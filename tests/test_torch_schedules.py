"""The port's learning-rate schedules against the JAX reference on the CPU.

- Every ported schedule's `Value` at chosen steps (around each
  boundary, far past the end) against `jax.jit` of the reference's, the
  way the reference's train step computes it: within atol 1e-7, rtol
  1e-6 (XLA CPU fuses a product and a sum into one fused multiply-add
  where the port rounds twice, which near a cancellation, as in 1 - x^3
  close to 1, is worth 1e-7 absolute), most values bitwise.
- `DevBasedSchedule` replays the reference's anneal-on-plateau over a
  metric history file written by the port's `early_stop.MetricHistory`:
  the factor after each record equals the reference schedule's on the
  same file, and a restarted schedule recovers it.
- `TrainProgram.Run` refreshes a learner's DevBasedSchedule before its
  loop, so the loop's learning rate carries the decayed factor.
- The learner's default optimizer is the reference's, Adam.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lingvo_tpu.core import schedule as jax_schedule
from lingvo_tpu_torch.core import early_stop
from lingvo_tpu_torch.core import learner
from lingvo_tpu_torch.core import optimizer
from lingvo_tpu_torch.core import schedule
from lingvo_tpu_torch.models.lm import input_generator
from lingvo_tpu_torch.models.lm import layers as lm_layers
from lingvo_tpu_torch.runners import program

STEPS = [0, 1, 2, 7, 99, 100, 101, 299, 300, 333, 999, 1000, 1001, 2345,
         3999, 4000, 4001, 6999, 7000, 9000, 12345, 100000, 123457]

CASES = [
    ("PiecewiseConstant", dict(boundaries=[10, 500, 4000],
                               values=[1.0, 0.3, 0.01, 0.002])),
    ("Polynomial", dict(power=2, start=(100, 1.0), limit=(7000, 0.1))),
    ("Polynomial", dict(power=3, start=(0, 0.0), limit=(3000, 2.5),
                        origin="limit")),
    ("Polynomial", dict(power=1, start=(300, 0.5), limit=(9000, 1.5))),
    ("LinearRampupExponentialDecay", dict(warmup=300, decay_start=1000,
                                          decay_end=9000, max=3.0,
                                          min=0.07)),
    ("TransformerSchedule", dict(warmup_steps=4000, model_dim=1024)),
    ("TransformerSchedule", dict(warmup_steps=300, model_dim=512,
                                 decay_end=5000)),
    ("ExponentialDecay", dict(start_step=77, half_life_steps=333, min=0.01)),
    ("LinearRampupCosineDecay", dict(warmup_steps=4000, total_steps=500000)),
    ("Constant", dict(value=0.25)),
]


@pytest.mark.parametrize("name, kw", CASES,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(CASES)])
def test_schedule_value_matches_jitted_reference(name, kw):
  ref = getattr(jax_schedule, name).Params().Set(name="s", **kw).Instantiate()
  port = getattr(schedule, name).Params().Set(**kw).Instantiate(device="cpu")
  value = jax.jit(ref.Value)
  want = np.array([float(value(jnp.int32(s))) for s in STEPS], np.float32)
  got = np.array([float(port.Value(s)) for s in STEPS], np.float32)
  for s in STEPS:
    v = port.Value(s)
    assert v.dtype == torch.float32 and v.shape == () and v.device.type == "cpu"
  np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-6)
  assert (got == want).mean() >= 0.6
  assert len(set(got.tolist())) > 1 or name == "Constant"


def _DevBased(lib, path, **kw):
  kw = dict(dict(window=100, decay=0.5, min_factor=0.1, tolerance=0.01), **kw)
  p = lib.DevBasedSchedule.Params().Set(history_path=path, **kw)
  if lib is jax_schedule:
    return p.Set(name="s").Instantiate()
  return p.Instantiate(device="cpu")


@pytest.mark.parametrize("minimize", [True, False])
def test_dev_based_schedule_replays_the_history_as_reference(tmp_path,
                                                             minimize):
  hist = early_stop.MetricHistory(str(tmp_path), "eval_dev", "loss")
  ref = _DevBased(jax_schedule, hist.path, minimize=minimize)
  port = _DevBased(schedule, hist.path, minimize=minimize)
  sign = 1.0 if minimize else -1.0
  # improvements, then a plateau long enough for three decays
  values = [3.0, 2.5, 2.4, 2.395, 2.394, 2.6, 2.5, 2.45, 2.44, 2.43, 2.42,
            2.41, 2.40, 2.39]
  factors = []
  for i, v in enumerate(values):
    hist.ConditionalAppend(50 * (i + 1), sign * v)
    changed_ref = ref.UpdateFromHistory()
    changed = port.UpdateFromHistory()
    assert changed == changed_ref
    assert float(port.Value(0)) == float(ref.Value(0))
    factors.append(float(port.Value(0)))
  assert factors[-1] < 0.5 and min(factors) >= 0.1
  restarted = _DevBased(schedule, hist.path, minimize=minimize)
  assert restarted.UpdateFromHistory()
  assert float(restarted.Value(0)) == factors[-1]


def test_train_program_refreshes_the_dev_based_schedule(tmp_path):
  hist = early_stop.MetricHistory(str(tmp_path), "eval_dev", "loss")
  for i, v in enumerate([1.0, 1.5, 1.6, 1.7, 1.8]):
    hist.ConditionalAppend(100 * (i + 1), v)
  p = lm_layers.TransformerLm.Params().Set(
      name="lm", vocab_size=64, model_dim=16, num_layers=1, num_heads=2,
      hidden_dim=32)
  p.train.learner = learner.Learner.Params().Set(
      learning_rate=0.1, optimizer=optimizer.SGD.Params(),
      lr_schedule=schedule.DevBasedSchedule.Params().Set(
          history_path=hist.path, window=150, decay=0.5))
  lm = p.Instantiate(device="cpu")
  state = lm.CreateTrainState(torch.Generator().manual_seed(0))
  gen = input_generator.SyntheticLmInput.Params().Set(
      batch_size=2, seq_len=16, vocab_size=64).Instantiate()
  prog = program.TrainProgram(
      program.TrainProgram.Params().Set(steps_per_loop=2,
                                        async_infeed=False),
      task=lm, input_generator=gen)
  _, result = prog.Run(state)
  # the best is at 100: 300 - 100 > 150 decays (the reference step moves
  # to 300), 500 - 300 > 150 decays again
  np.testing.assert_allclose(result["learning_rate"], 0.025, rtol=1e-7)
  hist.ConditionalAppend(700, 2.0)
  _, result = prog.Run(state)
  np.testing.assert_allclose(result["learning_rate"], 0.0125, rtol=1e-7)


def test_learner_defaults_to_adam_as_the_reference():
  from lingvo_tpu.core import learner as jax_learner
  ref = jax_learner.Learner.Params()
  port = learner.Learner.Params()
  assert port.optimizer.cls.__name__ == ref.optimizer.cls.__name__ == "Adam"
  lrn = port.Instantiate(device="cpu")
  assert isinstance(lrn.opt, optimizer.Adam)
  for name in ("beta1", "beta2", "epsilon"):
    assert port.optimizer.Get(name) == ref.optimizer.Get(name)
