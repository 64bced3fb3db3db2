"""The port's trainer CLI and runtime on the CPU, within the port.

- `python -m lingvo_tpu_torch.trainer` on DenseLmTiny writes the
  reference's set of files; `--mode=eval`, `--job=evaler` (stops at
  FINISHED), `--list_models`; the default device is CUDA and raises
  without a card; `--mode=export` and the multi-host flags raise, and a
  mode that reads or writes a run needs `--logdir`.
- A DenseLmTiny twin with `xent_block_size` > 0 runs the fused-xent path
  through the CLI (one statistics call a train step and an eval batch),
  with the dense twin's metrics (atol 1e-5).
- Resume (0->4, then 4->8) is bitwise a straight 0->8, and pipeline_depth
  0 and 2 and async_infeed=False give bitwise the same run.
- The NaN stop fires within pipeline_depth loops and ends the MLPerf run
  as aborted; a transient failure, raised by the input or by the step,
  restores, replays the same batches and ends bitwise where an
  uninterrupted run ends; a fatal error and a CUDA fault raise.
- The checkpointer's sanity check refuses a non-finite save; SaveAsync's
  snapshot is complete when it returns and visible after the barrier;
  the warm starts map the reference's theta paths.
- `DeviceInfeed`: order, end-of-stream latch, exception propagation, Stop
  joining its thread.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from lingvo_tpu_torch import convert
from lingvo_tpu_torch import model_registry
from lingvo_tpu_torch import trainer
from lingvo_tpu_torch.core import base_model
from lingvo_tpu_torch.core import base_trial
from lingvo_tpu_torch.core import checkpointer
from lingvo_tpu_torch.core import layers
from lingvo_tpu_torch.core import learner as learner_lib
from lingvo_tpu_torch.core import optimizer as opt_lib
from lingvo_tpu_torch.core import retry
from lingvo_tpu_torch.core.nested_map import NestedMap
from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
from lingvo_tpu_torch.ops import fused_xent
from lingvo_tpu_torch.runners import base_runner
from lingvo_tpu_torch.runners import executor
from lingvo_tpu_torch.runners import infeed
from lingvo_tpu_torch.runners import program

TINY = "lm.synthetic_packed_input.DenseLmTiny"
# the input's own sleep: the retry tests stub the executor's time.sleep
_SLEEP = time.sleep


def _Rows(logdir):
  with open(os.path.join(logdir, "metrics.jsonl")) as f:
    return [json.loads(line) for line in f]


@model_registry.RegisterSingleTaskModel
class DenseLmTinyXent(spi.DenseLmTiny):
  """DenseLmTiny with the fused head (3 blocks of 48 over 128: a ragged
  last block), 4 steps a loop, 32 eval samples."""

  XENT_BLOCK_SIZE = 48

  def Task(self):
    p = super().Task()
    p.train.tpu_steps_per_loop = 4
    p.eval.samples_per_summary = 32
    return p


@model_registry.RegisterSingleTaskModel
class DenseLmTinyDense(DenseLmTinyXent):
  XENT_BLOCK_SIZE = 0


def test_cli_writes_the_reference_files_and_evals(tmp_path, capsys):
  logdir = str(tmp_path)
  assert trainer.main([f"--model={TINY}", f"--logdir={logdir}",
                       "--mode=train", "--device=cpu", "--max_steps=20"]) == 0
  for name in ("trainer_params.txt", "model_analysis.txt", "metrics.jsonl",
               "train/summaries.jsonl", "eval_test/summaries.jsonl",
               "train/ckpt_00000000/theta.pt",
               "train/ckpt_00000020/train_state.pt"):
    assert os.path.exists(os.path.join(logdir, name)), name
  with open(os.path.join(logdir, "train", "FINISHED")) as f:
    assert f.read() == "20"
  (row,) = _Rows(logdir)
  assert row["step"] == 20
  assert np.isfinite(row["train"]["loss"]) and np.isfinite(
      row["eval_test"]["loss"])
  capsys.readouterr()
  # eval the checkpoint with DenseLmTiny's shapes and 32 eval samples:
  # once, then as the follower job, which evaluates the final checkpoint
  # and ends at the FINISHED marker
  twin = "--model=misc.test_torch_trainer.DenseLmTinyDense"
  assert trainer.main([twin, f"--logdir={logdir}", "--mode=eval",
                       "--device=cpu"]) == 0
  assert "[eval_test] step=20" in capsys.readouterr().out
  assert trainer.main([twin, f"--logdir={logdir}", "--mode=eval",
                       "--job=evaler", "--device=cpu",
                       "--poll_interval_secs=0.01"]) == 0
  out = capsys.readouterr().out
  assert "[poller] evaluated checkpoint @ step 20" in out
  with open(os.path.join(logdir, "eval_test", "summaries.jsonl")) as f:
    evals = [json.loads(line) for line in f]
  assert [e["step"] for e in evals] == [20, 20, 20]
  assert evals[1]["loss"] == evals[2]["loss"]
  assert np.isfinite(evals[1]["loss"])


def test_model_params_wrap_the_task():
  mp = model_registry.GetParams(TINY, "Train")
  model = mp.Instantiate(device="cpu")
  task = model.GetTask()
  assert model.tasks == [task] and task.p.input.seed == 0
  assert task.p.train.tpu_steps_per_loop == 20
  assert spi.DenseLmTiny().GetDatasetParams("Test").seed == 99
  assert spi.DenseLmTiny().GetDatasetNames() == ["Test", "Train"]


def test_list_models(capsys):
  assert trainer.main(["--list_models"]) == 0
  out = capsys.readouterr().out.splitlines()
  assert f"{TINY}  [Test, Train]" in out
  assert "lm.synthetic_packed_input.DenseLmWord793k  [Test, Train]" in out


def test_cli_defaults_to_cuda_and_refuses_what_is_not_ported(tmp_path):
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="no CUDA device"):
      trainer.main([f"--model={TINY}", f"--logdir={tmp_path}"])
  with pytest.raises(NotImplementedError, match="item 11"):
    trainer.main([f"--model={TINY}", "--mode=export"])
  with pytest.raises(NotImplementedError, match="parallelism"):
    trainer.main([f"--model={TINY}", "--num_processes=2"])
  for mode in ("train", "eval", "decode", "shell"):
    with pytest.raises(SystemExit):
      trainer.main([f"--model={TINY}", f"--mode={mode}", "--device=cpu"])


def test_cli_runs_the_fused_xent_path(tmp_path, monkeypatch):
  calls = []
  stats = fused_xent.FusedXentStats

  def _Counted(*args):
    calls.append(args[0].shape)
    return stats(*args)

  monkeypatch.setattr(fused_xent, "FusedXentStats", _Counted)
  rows = {}
  for name in ("DenseLmTinyXent", "DenseLmTinyDense"):
    logdir = str(tmp_path / name)
    assert trainer.main([f"--model=misc.test_torch_trainer.{name}",
                         f"--logdir={logdir}", "--device=cpu",
                         "--max_steps=8"]) == 0
    rows[name] = _Rows(logdir)
    if name == "DenseLmTinyXent":
      # 2 loops of 4 steps and 2 evals of 8 batches, one call each
      assert calls == [(4 * 64, 64)] * (2 * 4 + 2 * 8)
  assert len(calls) == 24   # the dense head makes none
  for got, want in zip(*rows.values()):
    for prog in ("train", "eval_test"):
      for k in ("loss", "fraction_of_correct_next_step_preds"):
        np.testing.assert_allclose(got[prog][k], want[prog][k], atol=1e-5,
                                   err_msg=f"{prog} {k}")


# -- the executor on DenseLmTiny, within the port -------------------------------


def _TinyRun(logdir, max_steps, **train_program):
  """DenseLmTiny through the CLI's schedule: 4 steps a loop, 8 eval
  samples, warmup 2. Returns (rows, the task, the final state)."""
  import argparse
  mp = model_registry.GetParams(TINY, "Train")
  mp.task.train.learner.lr_schedule.warmup_steps = 2
  mp.task.train.max_steps = max_steps
  mp.task.train.tpu_steps_per_loop = 4
  mp.task.eval.samples_per_summary = 8
  args = argparse.Namespace(model=TINY, logdir=logdir, device="cpu",
                            train_executions_per_eval=1)
  sched, task = trainer._BuildSchedule(mp, args)
  sched.train_program.p.Set(**train_program)
  state = executor.ExecutorTpu(mp, logdir, schedule=sched, task=task).Start()
  return _Rows(logdir), task, state


def _TrainLosses(rows):
  return [(r["step"], r["train"]["loss"], r["train"]["grad_norm"])
          for r in rows]


def _Bits(task, state):
  return ([v.detach().clone() for v in task.state_dict().values()] +
          [v.clone() for _, v in checkpointer._OptItems(state)])


def _SameBits(a, b):
  assert len(a) == len(b)
  for x, y in zip(a, b):
    assert torch.equal(x, y)


def test_resume_and_pipelining_are_bitwise_the_straight_run(tmp_path):
  rows, task, state = _TinyRun(str(tmp_path / "straight"), 8)
  want = _TrainLosses(rows)
  bits = _Bits(task, state)
  assert [s for s, _, _ in want] == [4, 8]
  # resume: a second executor restores step 4 and its train input seeks
  # to batch 4
  first, _, _ = _TinyRun(str(tmp_path / "resume"), 4)
  assert len(first) == 1
  both, task2, state2 = _TinyRun(str(tmp_path / "resume"), 8)
  assert _TrainLosses(both) == want
  assert state2.step == 8
  _SameBits(_Bits(task2, state2), bits)
  for kw in (dict(pipeline_depth=0), dict(async_infeed=False)):
    rows_kw, task_kw, state_kw = _TinyRun(str(tmp_path / str(kw)), 8, **kw)
    assert _TrainLosses(rows_kw) == want, kw
    _SameBits(_Bits(task_kw, state_kw), bits)


# -- a regression task for the executor's failure paths -------------------------


class _RegressionTask(base_model.BaseTask):
  """y = 2x regression (the reference's trainer_test_utils task)."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("dim", 4, "")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    self.CreateChild("proj", layers.ProjectionLayer.Params().Set(
        input_dim=self.p.dim, output_dim=self.p.dim))

  def ComputePredictions(self, input_batch):
    return self.proj.FProp(input_batch.x)

  def ComputeLoss(self, predictions, input_batch):
    err = torch.mean(torch.square(predictions - input_batch.y))
    return (NestedMap(loss=(err, torch.tensor(float(input_batch.x.shape[0])))),
            NestedMap())


class _RegressionInput:
  """Seekable: batch i comes from RandomState(seed + i). Pulls from
  `nan_from` on carry NaN targets; pull `fail_at` raises `error`. A pull
  takes `pull_s` seconds between reading its index and storing the next,
  as a slow reader would."""

  def __init__(self, seed=0, nan_from=None, fail_at=None, error=None,
               pull_s=0.0):
    self._seed, self._i = seed, 0
    self._nan_from, self._fail_at, self._error = nan_from, fail_at, error
    self._pull_s = pull_s
    self.pulls = 0

  def GetPreprocessedInputBatch(self):
    self.pulls += 1
    if self.pulls == self._fail_at:
      raise self._error
    i = self._i
    if self._pull_s:
      _SLEEP(self._pull_s)
    x = np.random.RandomState(self._seed + i).randn(16, 4).astype(
        np.float32)
    self._i = i + 1
    y = 2.0 * x
    if self._nan_from is not None and self.pulls >= self._nan_from:
      y = y + np.float32("nan")
    return NestedMap(x=x, y=y)

  def Seek(self, batch_index):
    self._i = batch_index

  def __iter__(self):
    while True:
      yield self.GetPreprocessedInputBatch()

  def GlobalBatchSize(self):
    return 16

  def InfeedBatchSize(self):
    return 16


def _Regression(logdir, input_gen, pipeline_depth=2, max_steps=30,
                save_interval=10, async_infeed=True, **ex_kw):
  p = _RegressionTask.Params().Set(name="reg", dim=4)
  p.train.learner = learner_lib.Learner.Params().Set(
      learning_rate=0.05, optimizer=opt_lib.Adafactor.Params().Set(
          beta1=0.9, multiply_by_parameter_scale=False))
  p.train.max_steps = max_steps
  p.train.tpu_steps_per_loop = 5
  p.train.save_interval_steps = save_interval
  task = p.Instantiate(device="cpu")
  train_p = program.TrainProgram.Params().Set(
      task=p, logdir=logdir, steps_per_loop=5, pipeline_depth=pipeline_depth,
      async_infeed=async_infeed)
  sched = program.SimpleProgramSchedule(
      program.SimpleProgramSchedule.Params().Set(train_program=train_p),
      task=task, input_generators={"Train": input_gen})
  return executor.ExecutorTpu(p, logdir, schedule=sched, task=task, **ex_kw)


@pytest.mark.parametrize("depth,max_step", [(1, 15), (2, 20)])
def test_nan_stop_within_depth_loops(tmp_path, depth, max_step):
  """NaN enters at loop 2 (steps 6-10); the stop lands within
  pipeline_depth loops of it."""
  ex = _Regression(str(tmp_path), _RegressionInput(nan_from=6),
                   pipeline_depth=depth, max_steps=100, save_interval=100,
                   max_train_retries=0)
  state = ex.Start()
  assert 10 <= state.step <= max_step
  rows = _Rows(str(tmp_path))
  assert not np.isfinite(rows[-1]["train"]["loss"])


def test_nan_stop_aborts_the_mlperf_run(tmp_path):
  """The NaN stop ends the MLPerf run as aborted and writes no success
  stop after it; the trial is reported infeasible once."""
  calls = []

  class _Trial(base_trial.NoOpTrial):

    def ReportDone(self, infeasible=False, reason=""):
      calls.append((infeasible, reason))

  ex = _Regression(str(tmp_path), _RegressionInput(nan_from=6),
                   max_steps=100, save_interval=100, max_train_retries=0,
                   mlperf_benchmark="reg", trial=_Trial())
  ex.Start()
  with open(os.path.join(str(tmp_path), "mlperf_log.txt")) as f:
    events = [json.loads(line.split(":::MLLOG ", 1)[1]) for line in f]
  stops = [e for e in events if e["key"] == "run_stop"]
  assert [e["metadata"] for e in stops] == [
      {"status": "aborted", "reason": "nan_loss"}]
  assert events[-1]["key"] == "run_stop"
  assert calls == [(True, "nan_loss")]


@pytest.mark.parametrize("depth", [0, 2])
def test_transient_failure_restores_and_replays(tmp_path, monkeypatch, depth):
  monkeypatch.setattr(executor.time, "sleep", lambda s: None)
  want = _Regression(str(tmp_path / "clean"), _RegressionInput(),
                     pipeline_depth=depth)
  want_state = want.Start()
  gen = _RegressionInput(fail_at=17,
                         error=RuntimeError("UNAVAILABLE: reader died"))
  ex = _Regression(str(tmp_path / "retry"), gen, pipeline_depth=depth)
  state = ex.Start()
  assert state.step == 30 and gen.pulls > 30   # batches 10.. read again
  _SameBits(_Bits(ex.task, state), _Bits(want.task, want_state))


@pytest.mark.parametrize("train", [
    dict(pipeline_depth=0), dict(pipeline_depth=2), dict(async_infeed=False)])
def test_transient_failure_in_the_step_replays_the_same_batches(
    tmp_path, monkeypatch, train):
  """The step raises while the producer is inside a slow pull, with its
  input healthy: the retry stops the producer before seeking, so the
  replayed run is bitwise the uninterrupted one."""
  monkeypatch.setattr(executor.time, "sleep", lambda s: None)
  want = _Regression(str(tmp_path / "clean"), _RegressionInput(), **train)
  want_state = want.Start()
  ex = _Regression(str(tmp_path / "retry"), _RegressionInput(pull_s=0.02),
                   **train)
  step = ex.task.TrainStep
  calls = []

  def _Flaky(state, batch, *base_step_key):
    calls.append(int(state.step))
    if len(calls) == 17:
      raise RuntimeError("UNAVAILABLE: lost the host")
    return step(state, batch, *base_step_key)

  monkeypatch.setattr(ex.task, "TrainStep", _Flaky)
  state = ex.Start()
  assert state.step == 30 and calls.count(16) == 2   # restored at 10
  _SameBits(_Bits(ex.task, state), _Bits(want.task, want_state))


@pytest.mark.parametrize("error", [
    ValueError("shape mismatch"),
    RuntimeError("CUDA error: an illegal memory access was encountered "
                 "(UNAVAILABLE)"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate")])
def test_fatal_failures_raise(tmp_path, error):
  gen = _RegressionInput(fail_at=7, error=error)
  ex = _Regression(str(tmp_path), gen)
  with pytest.raises(type(error)):
    ex.Start()
  assert not os.path.exists(os.path.join(str(tmp_path), "train", "FINISHED"))


@pytest.mark.parametrize("text,transient", [
    ("UNAVAILABLE: socket closed", True),
    ("DEADLINE_EXCEEDED", True),
    ("CUDA error: unspecified launch failure", False),
    ("an illegal memory access was encountered; Connection reset", False),
    ("RESOURCE_EXHAUSTED: UNAVAILABLE", False)])
def test_failure_taxonomy(text, transient):
  assert retry.IsTransient(RuntimeError(text)) == transient


def test_poller_stops_at_finished(tmp_path):
  ex = _Regression(str(tmp_path), _RegressionInput(), max_steps=10)
  ex.Start()
  task = ex.task
  ev_p = program.EvalProgram.Params().Set(
      name="eval_test", task=task.p, logdir=str(tmp_path), steps_per_loop=2)
  ev = program.EvalProgram(ev_p, task=task,
                           input_generator=_RegressionInput(seed=5))
  seen = []
  base_runner.CheckpointPollingRunner(
      task, [ev], os.path.join(str(tmp_path), "train"),
      poll_interval_secs=0.01, timeout_secs=60).Run(
          lambda step, results: seen.append(step))
  assert seen == [10]


# -- the checkpointer's barrier and sanity check --------------------------------


def _Proj(seed=0):
  proj = layers.ProjectionLayer.Params().Set(
      input_dim=3, output_dim=2).Instantiate(device="cpu")
  return proj.InstantiateVariables(torch.Generator("cpu").manual_seed(seed))


def test_sanity_check_refuses_non_finite_saves(tmp_path):
  ck = checkpointer.Checkpointer(str(tmp_path), save_interval_steps=1)
  bad = _Proj()
  with torch.no_grad():
    bad.w[0, 0] = float("nan")
  with pytest.raises(ValueError, match="sanity check failed.*w"):
    ck.Save(1, bad)
  assert ck.SaveAsync(2, bad)          # snapshot and submit succeed ...
  with pytest.raises(ValueError, match="non-finite"):
    ck.WaitForPendingSave()            # ... the failure lands at the fence
  assert ck.Steps() == []
  assert ck.SaveAsync(3, _Proj())      # the checkpointer stays usable
  ck.Close()
  assert ck.Steps() == [3]


def test_save_async_snapshot_is_complete_on_return(tmp_path):
  ck = checkpointer.Checkpointer(str(tmp_path), save_interval_steps=1)
  src = _Proj(0)
  want = src.w.detach().clone()
  assert ck.SaveAsync(7, src)
  with torch.no_grad():
    src.w.add_(1.0)                    # an in-place update right after
  dst = _Proj(1)
  _, step = ck.Restore(dst)            # crosses the barrier
  assert step == 7 and torch.equal(dst.w, want)
  ck.Close()


def test_warm_starts_map_reference_theta_paths(tmp_path):
  """ApplyInitFromCheckpointRules reads a port checkpoint's leaves under
  the reference's theta paths (the repeat stack restacked); a rule whose
  source is missing raises. ImportNpzCheckpoint splits a stacked npz
  leaf over the repeat's layers."""
  p = spi.DenseLmTiny().Task()
  src = p.Instantiate(device="cpu")
  src.InstantiateVariables(torch.Generator().manual_seed(1))
  checkpointer.Checkpointer(str(tmp_path / "src")).Save(5, src, force=True)
  dst = p.Instantiate(device="cpu")
  dst.InstantiateVariables(torch.Generator().manual_seed(2))
  before = dict(convert.ThetaToNumpy(dst).FlattenItems())
  rules = {str(tmp_path / "src"): [(r"stack\.body\.fflayer\..*", r"\g<0>"),
                                   ("final_ln.scale", "final_ln.scale")]}
  assert checkpointer.ApplyInitFromCheckpointRules(dst, rules) == 7
  got = dict(convert.ThetaToNumpy(dst).FlattenItems())
  want = dict(convert.ThetaToNumpy(src).FlattenItems())
  for k, v in got.items():
    moved = k.startswith("stack.body.fflayer.") or k == "final_ln.scale"
    np.testing.assert_array_equal(v, want[k] if moved else before[k], k)
  with pytest.raises(KeyError, match="no_such"):
    checkpointer.ApplyInitFromCheckpointRules(
        dst, {str(tmp_path / "src"): [("emb.emb", "no_such.emb")]})
  npz = str(tmp_path / "w.npz")
  w = np.arange(2 * 64 * 128, dtype=np.float32).reshape(2, 64, 128)
  np.savez(npz, **{"stack.body.fflayer.ffn_in.w": w})
  assert checkpointer.ImportNpzCheckpoint(dst, npz) == 1
  np.testing.assert_array_equal(
      dict(convert.ThetaToNumpy(dst).FlattenItems())[
          "stack.body.fflayer.ffn_in.w"], w)


# -- DeviceInfeed -----------------------------------------------------------------


def test_infeed_order_and_end_of_stream_latch():
  feed = infeed.DeviceInfeed(lambda: iter(range(50)), depth=3)
  assert list(feed.Iter()) == list(range(50))
  assert feed.Get() is None and feed.Get() is None   # latched
  feed.Reset()
  assert feed.Get() == 0
  feed.Stop()


def test_infeed_places_in_the_producer():
  producers = []

  def _Place(x):
    producers.append(threading.current_thread().name)
    return torch.as_tensor(x)

  feed = infeed.DeviceInfeed(lambda: iter([np.ones(3)] * 2), place_fn=_Place,
                             device="cpu")
  assert all(isinstance(b, torch.Tensor) for b in feed.Iter())
  assert producers == ["infeed-producer"] * 2


def test_infeed_producer_exception_propagates_and_latches():
  def _Gen():
    yield 1
    raise RuntimeError("UNAVAILABLE: reader died")

  feed = infeed.DeviceInfeed(_Gen)
  assert feed.Get() == 1
  for _ in range(2):
    with pytest.raises(RuntimeError, match="reader died"):
      feed.Get()
  assert not feed.healthy
  feed.Reset()
  assert feed.healthy and feed.Get() == 1


def test_infeed_stop_joins_the_producer():
  feed = infeed.DeviceInfeed(lambda: iter(range(10**6)), depth=2)
  assert feed.Get() == 0
  names = lambda: {t.name for t in threading.enumerate()}
  assert "infeed-producer" in names()
  feed.Stop()
  assert "infeed-producer" not in names()
  feed.Stop()   # twice is fine


def test_producer_exception_reaches_run(tmp_path):
  gen = _RegressionInput(fail_at=3, error=ValueError("bad record"))
  ex = _Regression(str(tmp_path), gen)
  prog = ex._schedule.train_program
  with pytest.raises(ValueError, match="bad record"):
    prog.Run(ex.task.CreateTrainState(torch.Generator().manual_seed(0)))
  prog.Shutdown()
