"""Magnitude pruning against the JAX reference on the CPU.

- `PruningSchedule.SparsityAt` / `ShouldUpdate` equal the reference's
  (the boundary-crossing rule included).
- `ComputeMasks` on one theta (a matrix, a repeat stack's stacked leaf,
  a 3-D weight, an unmatched leaf and a vector; ties placed at the
  threshold) gives the reference's masks bit for bit: the threshold is
  the k-th smallest |w| of the whole stacked tensor and ties at it are
  pruned. `Sparsity` equals the reference's.
- The executor on DenseLmTiny with pruning (the FFN weights to 0.5 over
  8 steps, frequency 3) and an EMA, from the reference's init through
  `train.init_from_npz`, 8 steps (two loops of 4), then a restart to 12:
  after each run the masks equal the reference executor's (masks are not
  checkpointed, so the restarted run recomputes them at its first
  boundary), the realized sparsity is the schedule's at the last
  boundary, theta and `ema_theta` are zero wherever the mask is, and the
  final theta is within atol 1e-5, rtol 1e-4 of the reference's.
- The `cuda` case (JAX is imported only in `_Jax`): the masks on the card
  (`torch.kthvalue`) equal the CPU's bit for bit.
"""

import argparse
import types

import numpy as np
import pytest
import torch

from lingvo_tpu_torch import convert
from lingvo_tpu_torch import model_registry
from lingvo_tpu_torch import trainer
from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import pruning
from lingvo_tpu_torch.runners import executor

TINY = "lm.synthetic_packed_input.DenseLmTiny"


def _Jax():
  """The reference's modules, imported here only (the `cuda` case runs
  where JAX is not installed)."""
  import jax
  from lingvo_tpu import model_registry as jax_registry
  from lingvo_tpu import trainer as jax_trainer
  from lingvo_tpu.core import pruning as jax_pruning
  from lingvo_tpu.runners import executor as jax_executor
  from tests import torch_train_helpers
  return types.SimpleNamespace(
      jax=jax, registry=jax_registry, trainer=jax_trainer,
      pruning=jax_pruning, executor=jax_executor,
      JaxTree=torch_train_helpers.JaxTree)
SCHEDULE = dict(weight_regex=r".*ffn_(in|out)\.w", final_sparsity=0.5,
                begin_step=0, end_step=8, frequency=3)


def test_schedule_matches_reference():
  jax_pruning = _Jax().pruning
  kw = dict(final_sparsity=0.7, begin_step=5, end_step=105, frequency=10,
            power=3.0)
  j = jax_pruning.PruningSchedule(jax_pruning.PruningSchedule.Params().Set(
      **kw))
  t = pruning.PruningSchedule(pruning.PruningSchedule.Params().Set(**kw))
  for step in (0, 4, 5, 6, 50, 104, 105, 106, 1000):
    assert t.SparsityAt(step) == j.SparsityAt(step)
    for last in (-1, 0, 9, 10, 55):
      assert t.ShouldUpdate(step, last) == j.ShouldUpdate(step, last)


def _Theta():
  rng = np.random.RandomState(0)
  theta = dict(a=dict(w=rng.randn(16, 24).astype(np.float32)),
               stack=dict(w=rng.randn(3, 8, 8).astype(np.float32)),
               u=dict(w=rng.randn(4, 2, 8).astype(np.float32)),
               skip=dict(w=rng.randn(8, 8).astype(np.float32)),
               vec=dict(w=rng.randn(10).astype(np.float32)))
  # ties: the 10 smallest magnitudes of `a` all equal, straddling k
  flat = theta["a"]["w"].reshape(-1)
  order = np.argsort(np.abs(flat))
  flat[order[:10]] = np.float32(0.01) * np.sign(flat[order[:10]])
  return theta


@pytest.mark.parametrize("sparsity_step", [1, 4, 8])
def test_masks_match_reference_with_ties(sparsity_step):
  jax_pruning = _Jax().pruning
  kw = dict(weight_regex=r"(?!skip).*\.w", final_sparsity=0.5, begin_step=0,
            end_step=8, frequency=1)
  js = jax_pruning.PruningSchedule(jax_pruning.PruningSchedule.Params().Set(
      **kw))
  ts = pruning.PruningSchedule(pruning.PruningSchedule.Params().Set(**kw))
  theta = _Theta()
  jtheta = _Jax().JaxTree(theta)
  jmasks = dict(jax_pruning.ComputeMasks(jtheta, js, sparsity_step)
                .FlattenItems())
  port = {}
  for k, v in jtheta.FlattenItems():
    arr = torch.tensor(np.asarray(v))
    port[k] = (base_layer.StackedLeaf(tuple(arr)) if k == "stack.w"
               else arr)
  masks = pruning.ComputeMasks(port, ts, sparsity_step)
  assert sorted(masks) == ["a.w", "stack.w", "u.w"]
  for k, m in jmasks.items():
    if k in masks:
      np.testing.assert_array_equal(masks[k].numpy(), np.asarray(m),
                                    err_msg=k)
    else:
      assert np.all(np.asarray(m) == 1), k
  assert pruning.Sparsity(masks, ts) == jax_pruning.Sparsity(
      jax_pruning.ComputeMasks(jtheta, js, sparsity_step), js)
  pruning.ApplyMasks(port, masks)
  got = np.stack([x.numpy() for x in port["stack.w"].layers])
  np.testing.assert_array_equal(
      got, np.asarray(jax_pruning.ApplyMasks(
          jtheta, jax_pruning.ComputeMasks(jtheta, js, sparsity_step))
                      .stack.w))


def _Overrides(mp, npz, max_steps, pkg_pruning):
  """DenseLmTiny cut to 4 steps a loop and one eval batch, warm-started
  from npz, with an EMA and the pruning SCHEDULE."""
  mp.task.train.learner.lr_schedule.warmup_steps = 2
  mp.task.train.max_steps = max_steps
  mp.task.train.tpu_steps_per_loop = 4
  mp.task.train.save_interval_steps = 4
  mp.task.eval.samples_per_summary = 4
  mp.task.train.init_from_npz = npz
  mp.task.train.ema_decay = 0.99
  mp.task.train.pruning = pkg_pruning.PruningSchedule.Params().Set(
      **SCHEDULE)
  return mp


def _RunBoth(tmp, npz, max_steps):
  """The reference's run to max_steps in a fresh logdir; the port's in
  its one logdir (a restart after the first run)."""
  import lingvo_tpu.models.lm.params.synthetic_packed_input  # noqa: F401
  j = _Jax()
  mp = _Overrides(j.registry.GetParams(TINY, "Train"), npz, max_steps,
                  j.pruning)
  args = argparse.Namespace(model=TINY, logdir=str(tmp / f"ref{max_steps}"),
                            train_executions_per_eval=1)
  sched, task = j.trainer._BuildSchedule(mp, args)
  jex = j.executor.ExecutorTpu(mp, args.logdir, schedule=sched, task=task)
  jstate = jex.Start()
  mp = _Overrides(model_registry.GetParams(TINY, "Train"), npz, max_steps,
                  pruning)
  args = argparse.Namespace(model=TINY, logdir=str(tmp / "port"),
                            device="cpu", train_executions_per_eval=1)
  sched, task = trainer._BuildSchedule(mp, args)
  tex = executor.ExecutorTpu(mp, args.logdir, schedule=sched, task=task)
  tstate = tex.Start()
  return jex, jstate, tex, tstate, task


def test_executor_pruning_across_boundaries_and_a_restart(tmp_path):
  import lingvo_tpu.models.lm.params.synthetic_packed_input  # noqa: F401
  j = _Jax()
  mp = j.registry.GetParams(TINY, "Train")
  jtask = mp.task.Instantiate()
  jtask.FinalizePaths()
  init = jtask.CreateTrainState(j.jax.random.PRNGKey(1234)).theta
  npz = str(tmp_path / "init.npz")
  np.savez(npz, **{k: np.asarray(v) for k, v in init.FlattenItems()})
  sched = pruning.PruningSchedule(pruning.PruningSchedule.Params().Set(
      **SCHEDULE))
  for max_steps, boundary in ((8, 8), (12, 12)):
    jex, jstate, tex, tstate, task = _RunBoth(tmp_path, npz, max_steps)
    assert int(jstate.step) == tstate.step == max_steps
    jmasks = dict(jex._pruning_masks.FlattenItems())
    masks = tex.pruning_masks
    assert len(masks) == 2   # the repeat stack's ffn_in.w and ffn_out.w
    numel = sum(m.numel() for m in masks.values())
    zeros = sum(m.numel() - int(torch.count_nonzero(m))
                for m in masks.values())
    assert pruning.Sparsity(masks, sched) == zeros / numel
    want = sum(int(sched.SparsityAt(boundary) * m.numel())
               for m in masks.values())
    assert zeros == want
    theta = dict(task.ThetaTree().FlattenItems())
    for k, m in masks.items():
      np.testing.assert_array_equal(m.numpy(), np.asarray(jmasks[k]),
                                    err_msg=k)
      for w in (theta[k], tstate.ema_theta[k]):
        w = (torch.stack(w.layers) if isinstance(w, base_layer.StackedLeaf)
             else w)
        assert not bool(torch.any((m == 0) & (w != 0))), k
    want_theta = dict(jstate.theta.FlattenItems())
    for k, v in convert.ThetaToNumpy(task).FlattenItems():
      np.testing.assert_allclose(v, np.asarray(want_theta[k]), atol=1e-5,
                                 rtol=1e-4, err_msg=k)


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: compares the card's masks with the "
                "CPU's")


@pytest.mark.cuda
@pytest.mark.parametrize("sparsity_step", [1, 4, 8])
def test_masks_on_card_match_cpu(cuda, sparsity_step):
  """`ComputeMasks` (torch.kthvalue on the card) and `ApplyMasks` give the
  CPU's masks and weights bit for bit, ties at the threshold included."""
  sched = pruning.PruningSchedule(pruning.PruningSchedule.Params().Set(
      weight_regex=r"(?!skip).*\.w", final_sparsity=0.5, begin_step=0,
      end_step=8, frequency=1))
  out = {}
  for dev in ("cpu", "cuda"):
    theta = {}
    for k, v in _Theta().items():
      arr = torch.tensor(v["w"], device=dev)
      theta[f"{k}.w"] = (base_layer.StackedLeaf(tuple(arr)) if k == "stack"
                         else arr)
    masks = pruning.ComputeMasks(theta, sched, sparsity_step)
    pruning.ApplyMasks(theta, masks)
    out[dev] = ({k: m.cpu() for k, m in masks.items()},
                {k: convert._ToNumpy(v) for k, v in theta.items()})
  assert sorted(out["cpu"][0]) == sorted(out["cuda"][0])
  for k, m in out["cpu"][0].items():
    assert torch.equal(out["cuda"][0][k], m), k
    np.testing.assert_array_equal(out["cuda"][1][k], out["cpu"][1][k])
