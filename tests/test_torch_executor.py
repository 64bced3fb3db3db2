"""The port's trainer runtime against the JAX reference's on the CPU.

- `ExecutorTpu` on DenseLmTiny (4 steps a loop, 8 eval samples, 8 steps,
  warmup 2) from the reference's init (PRNGKey(1234)), handed to both through
  `train.init_from_npz`: every `metrics.jsonl` row's train loss,
  grad_norm, learning_rate and eval metrics within the tolerance of
  tests/test_torch_train.py's steps (atol 1e-5), and the final theta
  (the port's last checkpoint) against the reference's final state
  (atol 1e-5, rtol 1e-4). Both runs also write the MLPerf log, report to
  a recording trial and watch the eval loss for a plateau (window 3, so
  the early stop fires at step 8): the log's events, the trial's reports
  and the metric history match the reference's.
- The port's registry keys are a subset of the reference's, and
  `--mode=inspect_model` prints the reference's rows and TOTAL.
- `EarlyStop` on the same eval history stops where the reference's does.
- `ApplyInitFromCheckpointRules` with several rules over two source runs
  (regex groups, first match wins, a leaf mapped to another name) gives
  bitwise the reference's theta.
"""

import argparse
import json
import math
import os

import numpy as np
import pytest

import jax

from lingvo_tpu import model_registry as jax_registry
from lingvo_tpu import trainer as jax_trainer
from lingvo_tpu.core import checkpointer as jax_checkpointer
from lingvo_tpu.core import early_stop as jax_early_stop
from lingvo_tpu.core.nested_map import NestedMap as JaxNestedMap
from lingvo_tpu.runners import executor as jax_executor
from lingvo_tpu_torch import convert
from lingvo_tpu_torch import model_registry
from lingvo_tpu_torch import trainer
from lingvo_tpu_torch.core import base_trial
from lingvo_tpu_torch.core import checkpointer
from lingvo_tpu_torch.core import early_stop
from lingvo_tpu_torch.runners import executor

TINY = "lm.synthetic_packed_input.DenseLmTiny"


def _Overrides(mp, npz):
  # warmup 2 (not 1000), so that theta moves by more than the tolerance
  mp.task.train.learner.lr_schedule.warmup_steps = 2
  mp.task.train.max_steps = 8
  mp.task.train.tpu_steps_per_loop = 4
  mp.task.eval.samples_per_summary = 8
  mp.task.train.init_from_npz = npz
  # no eval improves on the first by 1e9: the plateau stop fires once
  # step - 4 > 3, at step 8
  mp.task.train.early_stop_window = 3
  mp.task.train.early_stop_tolerance = 1e9
  return mp


class _RecordingTrial(base_trial.NoOpTrial):
  """Records what the executor reports; never asks to stop."""

  def __init__(self):
    self.calls = []

  def ReportEvalMeasure(self, global_step, metrics, checkpoint_path=""):
    self.calls.append(("eval", global_step, sorted(metrics),
                       metrics["loss"]))
    return False

  def ReportDone(self, infeasible=False, reason=""):
    self.calls.append(("done", infeasible, reason))


def _MlLog(logdir):
  """(key, event_type, value, metadata) of each :::MLLOG line."""
  out = []
  with open(os.path.join(logdir, "mlperf_log.txt")) as f:
    for line in f:
      rec = json.loads(line.split(":::MLLOG ", 1)[1])
      out.append((rec["key"], rec["event_type"], rec["value"],
                  rec["metadata"]))
  return out


def _Rows(logdir):
  with open(os.path.join(logdir, "metrics.jsonl")) as f:
    return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
  """The reference executor on DenseLmTiny; its init as an npz."""
  import lingvo_tpu.models.lm.params.synthetic_packed_input  # noqa: F401
  tmp = tmp_path_factory.mktemp("ref")
  mp = jax_registry.GetParams(TINY, "Train")
  task = mp.task.Instantiate()
  task.FinalizePaths()
  init = task.CreateTrainState(jax.random.PRNGKey(1234)).theta
  npz = str(tmp / "init.npz")
  np.savez(npz, **{k: np.asarray(v) for k, v in init.FlattenItems()})
  logdir = str(tmp / "log")
  mp = _Overrides(jax_registry.GetParams(TINY, "Train"), npz)
  args = argparse.Namespace(model=TINY, logdir=logdir,
                            train_executions_per_eval=1)
  sched, task = jax_trainer._BuildSchedule(mp, args)
  trial = _RecordingTrial()
  state = jax_executor.ExecutorTpu(mp, logdir, schedule=sched, task=task,
                                   mlperf_benchmark="lm",
                                   trial=trial).Start()
  return npz, logdir, {k: np.asarray(v)
                       for k, v in state.theta.FlattenItems()}, trial


@pytest.fixture(scope="module")
def port_run(reference_run, tmp_path_factory):
  """The port's executor on the same config and init."""
  logdir = str(tmp_path_factory.mktemp("port"))
  mp = _Overrides(model_registry.GetParams(TINY, "Train"), reference_run[0])
  args = argparse.Namespace(model=TINY, logdir=logdir, device="cpu",
                            train_executions_per_eval=1)
  sched, task = trainer._BuildSchedule(mp, args)
  trial = _RecordingTrial()
  executor.ExecutorTpu(mp, logdir, schedule=sched, task=task,
                       mlperf_benchmark="lm", trial=trial).Start()
  return logdir, mp, trial


def test_executor_metrics_and_final_theta_match_reference(reference_run,
                                                          port_run):
  npz, ref_dir, ref_theta, _ = reference_run
  logdir, mp, _ = port_run
  ref_rows, rows = _Rows(ref_dir), _Rows(logdir)
  assert [r["step"] for r in rows] == [r["step"] for r in ref_rows] == [4, 8]
  for got, want in zip(rows, ref_rows):
    assert got["train"]["at_step"] == want["train"]["at_step"]
    for k in ("loss", "log_pplx", "fraction_of_correct_next_step_preds",
              "num_predictions", "grad_norm", "learning_rate", "grad_scale",
              "skipped_step"):
      np.testing.assert_allclose(got["train"][k], want["train"][k],
                                 atol=1e-5, rtol=1e-5, err_msg=k)
    assert sorted(got["eval_test"]) == sorted(want["eval_test"])
    for k in ("loss", "log_pplx", "fraction_of_correct_next_step_preds",
              "num_predictions"):
      np.testing.assert_allclose(got["eval_test"][k], want["eval_test"][k],
                                 atol=1e-5, rtol=1e-5, err_msg=k)
  # the final checkpoint, restored into a fresh task, against the
  # reference's final state
  fresh = mp.task.Instantiate(device="cpu")
  _, step = checkpointer.Checkpointer(
      os.path.join(logdir, "train")).Restore(fresh)
  assert step == 8
  got = dict(convert.ThetaToNumpy(fresh).FlattenItems())
  assert sorted(got) == sorted(ref_theta)
  moved = max(float(np.abs(ref_theta[k] - np.load(npz)[k]).max())
              for k in ref_theta)
  assert moved > 1e-3
  for k, v in got.items():
    np.testing.assert_allclose(v, ref_theta[k], atol=1e-5, rtol=1e-4,
                               err_msg=k)
  for name in ("trainer_params.txt", "model_analysis.txt",
               "train/summaries.jsonl", "eval_test/summaries.jsonl",
               "train/FINISHED"):
    assert os.path.exists(os.path.join(logdir, name)), name


def test_registry_keys_are_the_references():
  import lingvo_tpu.models.all_params  # noqa: F401
  import lingvo_tpu_torch.models.all_params  # noqa: F401
  # the port's experiment modules' keys (a test module may register
  # twins of its own in the same process)
  ours = {k for k, cls in model_registry.GetRegisteredModels().items()
          if cls.__module__.startswith("lingvo_tpu_torch.models.")}
  assert TINY in ours and "lm.synthetic_packed_input.DenseLmWord793k" in ours
  assert ours <= set(jax_registry.GetRegisteredModels())
  # the MoE configs wait for the MoE slice
  assert not any("MoE" in k for k in ours)


@pytest.mark.parametrize("name", ["DenseLmTiny", "DenseLmWord793k",
                                  "DenseLmSsmHybridTiny"])
def test_inspect_model_rows_match_reference(name, capsys):
  model = f"lm.synthetic_packed_input.{name}"
  assert jax_trainer.main([f"--model={model}", "--mode=inspect_model"]) == 0
  want = capsys.readouterr().out.strip().splitlines()
  assert trainer.main([f"--model={model}", "--mode=inspect_model"]) == 0
  got = capsys.readouterr().out.strip().splitlines()
  assert got == want
  assert got[-1].startswith("TOTAL")


def test_executor_cadence_records_match_reference(reference_run, port_run):
  """The MLPerf log, the trial's reports and the eval-loss history of the
  two runs above: the same events in the same order (the plateau stop at
  step 8 leaves out that block's block_stop), values within 1e-5."""
  ref_dir, ref_trial = reference_run[1], reference_run[3]
  logdir, _, trial = port_run
  got, want = _MlLog(logdir), _MlLog(ref_dir)
  assert [e[:2] for e in got] == [e[:2] for e in want]
  assert [e[0] for e in got] == [
      "submission_benchmark", "init_start", "init_stop", "run_start",
      "block_start", "eval_loss", "block_stop", "block_start", "eval_loss",
      "run_stop"]
  for g, w in zip(got, want):
    assert g[3] == w[3], g[0]
    if isinstance(w[2], float):
      np.testing.assert_allclose(g[2], w[2], atol=1e-5, err_msg=g[0])
    else:
      assert g[2] == w[2], g[0]
  assert [c[:3] for c in trial.calls] == [c[:3] for c in ref_trial.calls]
  assert [c[0] for c in trial.calls] == ["eval", "eval", "done"]
  for g, w in zip(trial.calls, ref_trial.calls):
    if g[0] == "eval":
      np.testing.assert_allclose(g[3], w[3], atol=1e-5)
  hist = "eval.loss.history.jsonl"
  got = early_stop.ReadHistory(os.path.join(logdir, hist))
  want = jax_early_stop.ReadHistory(os.path.join(ref_dir, hist))
  assert [s for s, _ in got] == [s for s, _ in want] == [4, 8]
  np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                             atol=1e-5)


@pytest.mark.parametrize("values,window,tolerance,minimize,min_steps", [
    ([5.0, 4.0, 4.5, 4.2, 4.1, 4.3, 4.4], 250, 0.0, True, 0),
    ([5.0, 4.0, 3.95, 3.9, 3.88, 3.87, 3.86], 250, 0.05, True, 0),
    ([0.1, 0.3, 0.2, 0.25, 0.29, 0.28, 0.27], 150, 0.0, False, 0),
    ([5.0, 5.0, 5.0, 5.0, 5.0, 5.0, 5.0], 100, 0.0, True, 600),
    ([3.0, math.nan, 2.0, 2.5, 2.6, 2.7, 2.8], 200, 0.0, True, 0)])
def test_early_stop_matches_reference(tmp_path, values, window, tolerance,
                                      minimize, min_steps):
  """The same eval values, one every 100 steps, through both: the same
  decision after each, and the same BestStep."""
  decisions = {}
  for lib in (early_stop, jax_early_stop):
    root = tmp_path / lib.__name__
    history = lib.MetricHistory(str(root), "eval", "loss", minimize=minimize)
    stop = lib.EarlyStop(lib.EarlyStop.Params().Set(
        window=window, tolerance=tolerance, minimize=minimize,
        min_steps=min_steps, metric_history=history))
    assert not stop.Stop(0)   # no history yet
    out = []
    for i, v in enumerate(values):
      history.ConditionalAppend(100 * (i + 1), v)
      out.append(stop.Stop(100 * (i + 1)))
    out.append(lib.BestStep(history.path, tolerance, minimize))
    decisions[lib.__name__] = out
  got, want = decisions.values()
  assert got == want
  assert any(got[:-1]) and not got[0]


def test_warm_start_rules_match_reference(tmp_path):
  """Two source runs (seeds 1 and 3) into a target (seed 2), through the
  reference on its state and orbax checkpoints and through the port on
  its task and checkpoints, from the same weights: bitwise the same
  theta, and the same leaves loaded."""
  import lingvo_tpu.models.lm.params.synthetic_packed_input  # noqa: F401
  jax_task = jax_registry.GetParams(TINY, "Train").task.Instantiate()
  jax_task.FinalizePaths()
  thetas = {seed: jax_task.CreateTrainState(jax.random.PRNGKey(seed)).theta
            for seed in (1, 2, 3)}
  atten = r"stack\.body\.self_atten\.atten\."
  rules_of = lambda root: {
      str(root / "src1"): [
          (atten + r"w_(query|key)", r"stack.body.self_atten.atten.w_value"),
          (atten + r"w_.*", r"\g<0>"),
          (r"final_ln\.(bias|scale)", r"final_ln.scale")],
      str(root / "src3"): [
          (r"stack\.body\.fflayer\.ffn_(in|out)\.b",
           r"stack.body.fflayer.ffn_\1.b")]}
  ref_root, port_root = tmp_path / "ref", tmp_path / "port"
  port_p = model_registry.GetParams(TINY, "Train").task
  for seed in (1, 3):
    ck = jax_checkpointer.Checkpointer(str(ref_root / f"src{seed}"))
    ck.Save(5, JaxNestedMap(theta=thetas[seed],
                            step=jax.numpy.asarray(5, jax.numpy.int32)),
            force=True)
    ck.Close()
    npz = str(tmp_path / f"theta{seed}.npz")
    np.savez(npz, **{k: np.asarray(v)
                     for k, v in thetas[seed].FlattenItems()})
    src = port_p.Instantiate(device="cpu")
    checkpointer.ImportNpzCheckpoint(src, npz)
    checkpointer.Checkpointer(str(port_root / f"src{seed}")).Save(
        5, src, force=True)
  # the reference sets the leaves of the state it is given
  before = {k: np.asarray(v) for k, v in thetas[2].FlattenItems()}
  want = jax_checkpointer.ApplyInitFromCheckpointRules(
      JaxNestedMap(theta=thetas[2], step=jax.numpy.asarray(0)),
      rules_of(ref_root)).theta
  npz = str(tmp_path / "theta2.npz")
  np.savez(npz, **before)
  dst = port_p.Instantiate(device="cpu")
  checkpointer.ImportNpzCheckpoint(dst, npz)
  # w_query, w_key, w_value, w_post, final_ln's two, ffn_in.b, ffn_out.b
  assert checkpointer.ApplyInitFromCheckpointRules(
      dst, rules_of(port_root)) == 8
  got = dict(convert.ThetaToNumpy(dst).FlattenItems())
  want = {k: np.asarray(v) for k, v in want.FlattenItems()}
  assert sorted(got) == sorted(want)
  for k, v in got.items():
    np.testing.assert_array_equal(v, want[k], k)
  # the rules moved something, and left what they do not match alone
  query = "stack.body.self_atten.atten.w_query"
  assert not np.array_equal(got[query], before[query])
  np.testing.assert_array_equal(got["emb.emb"], before["emb.emb"])
