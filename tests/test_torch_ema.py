"""The EMA of theta against the JAX reference on the CPU.

- A tiny LM with `ema_decay` 0.999 (so the decay is min(0.999, (1 + s) /
  (10 + s)), from the pre-increment step) and 0.15 (the cap from step
  1 on) takes 3 `TrainStep`s beside the jitted reference's: `ema_theta`
  within atol 1e-5, rtol 1e-4 (the tolerance of theta after the same
  steps) through `convert.TrainStatePairs`. `ema_decay_moving_vars`
  False raises: the port has no non-trainable variables for its mask.
- A leaf no learner trains keeps its theta bit for bit, and its EMA is
  still e * d + t * (1 - d): equal to the reference's within 1 ulp and
  to that float32 formula in numpy exactly.
- Eval on the EMA: the eval-mode metrics with the EMA weights within
  1e-5 of the reference's `EvalStep` on its `ema_theta`;
  `EvalProgram.Run` reads the EMA by default (`use_ema`) and theta with
  use_ema=False; theta is bitwise unchanged after either.
- `ema_theta` round-trips through the checkpointer.
- The follower jobs score the EMA: DenseLmTiny with `ema_decay` 0.99,
  trained 4 steps through each package's CLI from the reference's init
  (`train.init_from_npz`); then `--mode=eval` and `--job=evaler` restore
  the whole train state. Their eval losses equal the trainer's own eval
  of the EMA at step 4 (within 1e-6), lie within 1e-5 of the reference's
  `--mode=eval` and `--job=evaler` on its checkpoint, and differ from
  the raw theta's.
"""

import json
import os

import numpy as np
import pytest

import jax
import torch

from lingvo_tpu import model_registry as jax_registry
from lingvo_tpu import trainer as jax_trainer
from lingvo_tpu.models.lm.params import synthetic_packed_input as jax_spi
from lingvo_tpu_torch import convert
from lingvo_tpu_torch import model_registry
from lingvo_tpu_torch import trainer
from lingvo_tpu_torch.core import checkpointer
from lingvo_tpu_torch.models.lm import input_generator
from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
from lingvo_tpu_torch.runners import program

from tests import torch_train_helpers as h

FROZEN = r"^final_ln\."


def _Lm(pkg, decay=0.999):
  p = h.TinyLm(pkg)
  p.train.learner = pkg.learner.Learner.Params().Set(
      name="lrn", learning_rate=0.01, bprop_variable_exclusion=FROZEN,
      optimizer=pkg.optimizer.Adam.Params().Set(beta2=0.98))
  p.train.ema_decay = decay
  p.eval.samples_per_summary = h.B   # one eval batch
  return p


def _Trained(decay=0.999, steps=3):
  task, theta, port = h.Instantiate(_Lm(h.JAX, decay), _Lm(h.PORT, decay))
  jstate = task.CreateTrainState(jax.random.PRNGKey(0))
  jstate.theta = jax.tree_util.tree_map(jax.numpy.asarray, theta)
  jstate.ema_theta = jstate.theta
  jstate.opt_states = [lrn.InitState(task._TrainableSubset(jstate.theta, lrn))
                       for lrn in task.learners]
  step_fn = jax.jit(task.TrainStep)
  tstate = port.CreateTrainState()
  for i in range(steps):
    batch = h.Batch(seed=30 + i)
    jstate, _ = step_fn(jstate, h.ToJax(batch))
    port.TrainStep(tstate, h.ToTorch(batch))
  return task, theta, port, jstate, tstate


@pytest.mark.parametrize("decay", [0.999, 0.15])
def test_ema_theta_matches_reference(decay):
  _, _, port, jstate, tstate = _Trained(decay)
  h.CheckTheta(port, jstate.theta, atol=1e-5, rtol=1e-4)
  pairs = convert.TrainStatePairs(tstate, h.Numpy(jstate))
  assert sum(n.startswith("state.ema_theta") for n, _, _ in pairs) == len(
      jax.tree_util.tree_leaves(jstate.ema_theta))
  for name, t, a in pairs:
    np.testing.assert_allclose(t.numpy(), a, atol=1e-5, rtol=1e-4,
                               err_msg=name)
  # the EMA lags theta
  theta = dict(convert.ThetaToNumpy(port).FlattenItems())
  assert max(np.abs(tstate.ema_theta[k].numpy() - theta[k]).max()
             for k in theta) > 1e-4


def test_ema_without_moving_vars_raises():
  p = _Lm(h.PORT)
  p.train.ema_decay_moving_vars = False
  with pytest.raises(NotImplementedError, match="non-trainable"):
    p.Instantiate(device="cpu")


def test_ema_of_a_frozen_leaf_is_still_smoothed():
  task, theta, port, jstate, tstate = _Trained(steps=1)
  start = dict(type(theta)(theta).FlattenItems())
  for k in ("final_ln.scale", "final_ln.bias"):
    t = port.ThetaTree().GetItem(k).detach().numpy()
    np.testing.assert_array_equal(t, start[k])    # frozen
    d = np.minimum(np.float32(0.999),
                   np.float32(1.0) / np.float32(10.0))   # step 0
    want = start[k] * d + start[k] * (np.float32(1.0) - d)
    np.testing.assert_array_equal(tstate.ema_theta[k].numpy(), want)
    np.testing.assert_allclose(tstate.ema_theta[k].numpy(),
                               np.asarray(jstate.ema_theta.GetItem(k)),
                               rtol=1.2e-7, atol=0)


class _OneBatch:
  """An input generator that gives the same batch again and again."""

  def __init__(self, batch):
    self._batch = batch

  def GetPreprocessedInputBatch(self):
    return self._batch

  def __iter__(self):
    while True:
      yield self._batch

  def InfeedBatchSize(self):
    return h.B

  def GlobalBatchSize(self):
    return h.B


def test_eval_reads_the_ema_and_gives_theta_back():
  task, _, port, jstate, tstate = _Trained()
  batch = h.Batch(seed=99)
  jm, _ = jax.jit(task.EvalStep)(jstate.ema_theta, h.ToJax(batch))
  before = {k: v.clone() for k, v in port.state_dict().items()}
  with port.EmaThetaActive(tstate):
    tm, _ = port.EvalStep(h.ToTorch(batch))
  for k in ("loss", "fraction_of_correct_next_step_preds"):
    np.testing.assert_allclose(float(tm[k][0]), float(jm[k][0]), atol=1e-5,
                               err_msg=k)
  results = {}
  for use_ema in (True, False):
    prog = program.EvalProgram(
        program.EvalProgram.Params().Set(use_ema=use_ema, async_infeed=False,
                                         steps_per_loop=1),
        task=port, input_generator=_OneBatch(batch))
    _, results[use_ema] = prog.Run(tstate)
    for k, v in port.state_dict().items():
      assert torch.equal(v, before[k]), k
  assert results[True]["loss"] == pytest.approx(float(tm.loss[0]), abs=1e-6)
  plain, _ = port.EvalStep(h.ToTorch(batch))
  assert results[False]["loss"] == pytest.approx(float(plain.loss[0]),
                                                 abs=1e-6)
  assert abs(results[True]["loss"] - results[False]["loss"]) > 1e-5


def test_ema_theta_round_trips_through_the_checkpointer(tmp_path):
  _, _, port, _, tstate = _Trained(steps=1)
  ckpt = checkpointer.Checkpointer(str(tmp_path))
  ckpt.Save(1, port, tstate, force=True)
  fresh = port.CreateTrainState()
  fresh.ema_theta = {k: torch.zeros_like(v)
                     for k, v in fresh.ema_theta.items()}
  restored, _ = ckpt.Restore(port, state=fresh)
  for k, v in tstate.ema_theta.items():
    assert torch.equal(restored.ema_theta[k], v), k


def _EmaTiny(base):
  """DenseLmTiny with an EMA and 10x its learning rate, one loop of 4
  steps, one eval batch, and the weights of the npz file named by
  `INIT_NPZ`."""

  def _Task(self):
    p = base.Task(self)
    p.train.ema_decay = 0.99
    p.train.learner.learning_rate = 0.03   # EMA and theta far apart
    p.train.tpu_steps_per_loop = 4
    p.train.save_interval_steps = 4
    p.train.init_from_npz = self.INIT_NPZ
    p.eval.samples_per_summary = self.BATCH_SIZE
    return p

  return type("DenseLmTinyEma", (base,), {"Task": _Task, "INIT_NPZ": ""})


JAX_EMA_TINY = _EmaTiny(jax_spi.DenseLmTiny)
EMA_TINY = _EmaTiny(spi.DenseLmTiny)


@pytest.fixture
def ema_tiny_registered():
  """Both twins in their packages' registries for the test's duration
  only: other tests walk every registered model."""
  keys = [(registry, registry.RegisterSingleTaskModel(cls)._registry_key)
          for registry, cls in ((jax_registry, JAX_EMA_TINY),
                                (model_registry, EMA_TINY))]
  yield keys[1][1]
  for registry, key in keys:
    registry._MODEL_REGISTRY.pop(key)


def _EvalLosses(logdir):
  with open(os.path.join(logdir, "eval_test", "summaries.jsonl")) as f:
    return [json.loads(line)["loss"] for line in f]


def test_followers_score_the_ema_like_the_reference(tmp_path,
                                                   ema_tiny_registered):
  key = ema_tiny_registered
  init = jax_registry.GetParams(key, "Train").task.Instantiate()
  init.FinalizePaths()
  theta = init.CreateTrainState(jax.random.PRNGKey(1234)).theta
  npz = str(tmp_path / "init.npz")
  np.savez(npz, **{k: np.asarray(v) for k, v in theta.FlattenItems()})
  JAX_EMA_TINY.INIT_NPZ = EMA_TINY.INIT_NPZ = npz
  losses = {}
  for name, main, extra in (("ref", jax_trainer.main, []),
                            ("port", trainer.main, ["--device=cpu"])):
    logdir = str(tmp_path / name)
    common = [f"--model={key}", f"--logdir={logdir}"]
    assert main(common + extra + ["--max_steps=4"]) == 0
    assert main(common + extra + ["--mode=eval"]) == 0
    assert main(common + extra + ["--mode=eval", "--job=evaler",
                                  "--poll_interval_secs=0.01"]) == 0
    losses[name] = _EvalLosses(logdir)
  # the trainer's eval at step 4, then --mode=eval, then the evaler
  assert len(losses["port"]) == len(losses["ref"]) == 3
  np.testing.assert_allclose(losses["port"], losses["port"][0], atol=1e-6)
  np.testing.assert_allclose(losses["port"], losses["ref"], atol=1e-5)
  # the raw theta scores otherwise
  p = model_registry.GetParams(key, "Test")
  task = p.task.Instantiate(device="cpu")
  checkpointer.Checkpointer(str(tmp_path / "port" / "train")).Restore(task)
  gen = input_generator.SyntheticLmInput(p.input)
  batch = gen.GetPreprocessedInputBatch().Transform(torch.as_tensor)
  metrics, _ = task.EvalStep(batch)
  assert abs(float(metrics.loss[0]) - losses["port"][0]) > 5e-4
