"""The trainer runtime on the hybrid in lingvo_tpu_torch against the JAX reference's, on the CPU.

`ExecutorTpu` on DenseLmSsmHybridTiny (4 steps a loop, 8 eval samples, 8
steps, warmup 2) from the reference's init (PRNGKey(1234)), handed to
both through `train.init_from_npz`: every `metrics.jsonl` row's train
loss, grad_norm, learning_rate and eval metrics within atol 1e-5 and
the final theta (the port's last checkpoint) against the reference's
final state within atol 1e-5, rtol 1e-4, as tests/test_torch_executor.py
holds DenseLmTiny's. The SSM mixer's gradients go through autograd of
the plain chunked scan, the CPU half of `ops/ssd_scan.SsdScan`.
"""

import argparse
import json
import os

import numpy as np

import jax

from lingvo_tpu import model_registry as jax_registry
from lingvo_tpu import trainer as jax_trainer
from lingvo_tpu.runners import executor as jax_executor
from lingvo_tpu_torch import convert
from lingvo_tpu_torch import model_registry
from lingvo_tpu_torch import trainer
from lingvo_tpu_torch.core import checkpointer
from lingvo_tpu_torch.runners import executor

TINY = "lm.synthetic_packed_input.DenseLmSsmHybridTiny"


def _Overrides(mp, npz):
  # warmup 2 (not 1000), so that theta moves by more than the tolerance
  mp.task.train.learner.lr_schedule.warmup_steps = 2
  mp.task.train.max_steps = 8
  mp.task.train.tpu_steps_per_loop = 4
  mp.task.eval.samples_per_summary = 8
  mp.task.train.init_from_npz = npz
  return mp


def _Rows(logdir):
  with open(os.path.join(logdir, "metrics.jsonl")) as f:
    return [json.loads(line) for line in f]


def test_hybrid_executor_matches_reference(tmp_path):
  import lingvo_tpu.models.lm.params.synthetic_packed_input  # noqa: F401
  mp = jax_registry.GetParams(TINY, "Train")
  task = mp.task.Instantiate()
  task.FinalizePaths()
  init = task.CreateTrainState(jax.random.PRNGKey(1234)).theta
  npz = str(tmp_path / "init.npz")
  np.savez(npz, **{k: np.asarray(v) for k, v in init.FlattenItems()})
  ref_dir = str(tmp_path / "ref")
  mp = _Overrides(jax_registry.GetParams(TINY, "Train"), npz)
  args = argparse.Namespace(model=TINY, logdir=ref_dir,
                            train_executions_per_eval=1)
  sched, task = jax_trainer._BuildSchedule(mp, args)
  state = jax_executor.ExecutorTpu(mp, ref_dir, schedule=sched,
                                   task=task).Start()
  ref_theta = {k: np.asarray(v) for k, v in state.theta.FlattenItems()}

  logdir = str(tmp_path / "port")
  mp = _Overrides(model_registry.GetParams(TINY, "Train"), npz)
  args = argparse.Namespace(model=TINY, logdir=logdir, device="cpu",
                            train_executions_per_eval=1)
  sched, task = trainer._BuildSchedule(mp, args)
  executor.ExecutorTpu(mp, logdir, schedule=sched, task=task).Start()

  ref_rows, rows = _Rows(ref_dir), _Rows(logdir)
  assert [r["step"] for r in rows] == [r["step"] for r in ref_rows] == [4, 8]
  for got, want in zip(rows, ref_rows):
    for k in ("loss", "log_pplx", "fraction_of_correct_next_step_preds",
              "num_predictions", "grad_norm", "learning_rate", "grad_scale",
              "skipped_step"):
      np.testing.assert_allclose(got["train"][k], want["train"][k],
                                 atol=1e-5, rtol=1e-5, err_msg=k)
    for k in ("loss", "log_pplx", "fraction_of_correct_next_step_preds",
              "num_predictions"):
      np.testing.assert_allclose(got["eval_test"][k], want["eval_test"][k],
                                 atol=1e-5, rtol=1e-5, err_msg=k)
  fresh = mp.task.Instantiate(device="cpu")
  _, step = checkpointer.Checkpointer(
      os.path.join(logdir, "train")).Restore(fresh)
  assert step == 8
  got = dict(convert.ThetaToNumpy(fresh).FlattenItems())
  assert sorted(got) == sorted(ref_theta)
  assert any("w_dt" in k for k in got)
  moved = max(float(np.abs(ref_theta[k] - np.load(npz)[k]).max())
              for k in ref_theta)
  assert moved > 1e-3
  for k, v in got.items():
    np.testing.assert_allclose(v, ref_theta[k], atol=1e-5, rtol=1e-4,
                               err_msg=k)
