"""ExecutorTpu: the training main loop (port of lingvo_tpu/runners/executor.py).

Owns the train state, the checkpointer and the program schedule; the
main loop interleaves checkpoint saves and restores with schedule runs
and exports metrics, as the reference's does (the name is the
reference's; the port's device is the card the task lives on):

- `trainer_params.txt` and `model_analysis.txt` in the logdir;
- restore-or-init: the latest checkpoint of `<logdir>/train`, or a fresh
  state whose weights come from a CPU generator seeded with `INIT_SEED`
  (the same weights on the card as on the CPU), warm-started by
  `init_from_checkpoint_rules` / `init_from_npz` on a fresh run only;
- a save at the start step and a final forced save, `FINISHED` after it;
- a transient failure (core/retry.py) restores the last checkpoint and
  retries, up to `max_train_retries` in a row; anything else, a CUDA
  fault included, raises;
- a non-finite train loss stops the run (also in the flushed tail), and
  reports the trial infeasible; trial reports, the early stop and the
  MLPerf log as in the reference;
- `metrics.jsonl`: one row per step with every program's result.

Two main-loop bodies, as the reference's. A schedule with a
deterministic `StepsPerCycle` (`SimpleProgramSchedule`) runs the
pipelined one: it saves with `SaveAsync` and makes its cadence decisions
(`_CadenceDecisions`) over the loops that completed, which a synchronous
train program reports at once and a pipelined one within
`pipeline_depth` loops. At each of its fences (the start, a restore) the
programs learn the step (`SyncHostStep`), and a seekable train input
moves to it. A schedule without one (`MultiTaskProgramSchedule`, whose
cycle's steps depend on the sampled task) runs the sequential one (the
reference's `_LegacyMainLoopBody`): a synchronous save, one cycle, the
step read from the state, the decisions over that cycle's results. For
a multi-task schedule `ExecutorTpu(None, logdir, schedule=...)` takes
the tasks from the schedule and checkpoints its `model`.

Magnitude pruning (`train.pruning`, core/pruning.py): after every cycle
the masks are recomputed if a `frequency` boundary was crossed since
their last update, and re-applied to theta and `ema_theta`. They are not
checkpointed; a restarted run recomputes them at its first boundary.

The status server (`serve_port`), the stall watchdog and the goodput
tracker come with `observe/` (ROADMAP item 11) and raise when asked for.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any

import torch

from lingvo_tpu_torch.core import base_trial
from lingvo_tpu_torch.core import checkpointer as checkpointer_lib
from lingvo_tpu_torch.core import early_stop as early_stop_lib
from lingvo_tpu_torch.core import ml_perf_log
from lingvo_tpu_torch.core import pruning as pruning_lib
from lingvo_tpu_torch.core import retry as retry_lib
from lingvo_tpu_torch.core import summary_utils
from lingvo_tpu_torch.core.nested_map import NestedMap


# the fresh run's weights: a CPU generator with this seed (the reference's
# PRNGKey(1234))
INIT_SEED = 1234


def _NanTrainLoss(results) -> bool:
  """A train result (keyed 'train...') with a non-finite loss."""
  return any(isinstance(r, dict) and "loss" in r and
             not math.isfinite(r["loss"])
             for name, r in results if name.startswith("train"))


class ExecutorTpu:

  def __init__(self, model_params, logdir: str, schedule=None, task=None,
               max_train_retries: int = 3,
               mlperf_benchmark: str = "", trial=None, serve_port=None,
               watchdog=None, device=None):
    """model_params: SingleTaskModel params (task + input attached).

    `task`: the instance the schedule's programs share; None builds the
    model from model_params on `device`, or, for a multi-task schedule
    (one with `tasks`), takes the schedule's tasks. `max_train_retries`:
    consecutive transient failures tolerated, each retry restoring the
    last checkpoint."""
    if serve_port is not None or watchdog:
      raise NotImplementedError(
          "the status server and the stall watchdog come with observe/ "
          "(ROADMAP item 11)")
    self._logdir = logdir
    os.makedirs(logdir, exist_ok=True)
    self._max_train_retries = max_train_retries
    if task is None and hasattr(schedule, "tasks"):
      tasks = schedule.tasks   # multi-task: the schedule owns the task set
      self._module = schedule.model
    else:
      if task is None:
        if trial is not None:
          model_params = trial.OverrideModelParams(model_params)
        self._model = model_params.Instantiate(device=device)
        task = self._model.GetTask()
      tasks = task
      self._module = task
    self._task = task
    for t in (tasks.values() if isinstance(tasks, dict) else [tasks]):
      t.FinalizePaths()
    ref_task = next(iter(tasks.values())) if task is None else task
    tp = ref_task.p.train
    self._pruning_schedule = (tp.pruning.Instantiate()
                              if task is not None and tp.pruning is not None
                              else None)
    self._pruning_masks = None
    self._last_prune_step = -1
    # the full experiment config, for reproducibility
    if model_params is not None:
      with open(os.path.join(logdir, "trainer_params.txt"), "w") as f:
        f.write(model_params.ToText())
    self._schedule = schedule
    with open(os.path.join(logdir, "model_analysis.txt"), "w") as f:
      f.write("\n".join(summary_utils.ModelAnalysis(tasks)) + "\n")
    self._checkpointer = checkpointer_lib.Checkpointer(
        os.path.join(logdir, "train"),
        save_interval_steps=tp.save_interval_steps,
        max_to_keep=tp.save_max_to_keep)
    self._trial = trial if trial is not None else base_trial.NoOpTrial()
    self._trial_done = False
    self._mlperf = None
    if mlperf_benchmark:
      self._mlperf = ml_perf_log.MlPerfLogger(
          os.path.join(logdir, "mlperf_log.txt"), benchmark=mlperf_benchmark)
      self._mlperf.Print(ml_perf_log.INIT_START)
    self._max_steps = tp.max_steps
    # early stop on an eval plateau (ref base_runner._ShouldStop)
    self._early_stop = None
    if tp.early_stop_window > 0:
      self._metric_history = early_stop_lib.MetricHistory(
          logdir, "eval", tp.early_stop_metric)
      self._early_stop = early_stop_lib.EarlyStop(
          early_stop_lib.EarlyStop.Params().Set(
              window=tp.early_stop_window,
              tolerance=tp.early_stop_tolerance,
              metric_history=self._metric_history))

  @property
  def task(self):
    return self._task

  @property
  def checkpointer(self):
    return self._checkpointer

  def _CreateTrainState(self, initialize: bool) -> NestedMap:
    """A train state of the task's (or the multi-task schedule's)
    structure; with `initialize`, the weights are drawn first from a CPU
    generator seeded with INIT_SEED."""
    gen = (torch.Generator("cpu").manual_seed(INIT_SEED)
           if initialize else None)
    if self._task is None:
      return self._schedule.CreateTrainState(gen)
    return self._task.CreateTrainState(gen)

  def _Restore(self) -> tuple[NestedMap, int]:
    """The last checkpoint into a fresh state of the task's structure."""
    return self._checkpointer.Restore(self._module,
                                      state=self._CreateTrainState(False))

  def _MaybePrune(self, state: NestedMap, step: int) -> None:
    """Magnitude pruning at a program-run boundary: masks recomputed when
    a frequency boundary was crossed since their last update, then applied
    to theta and ema_theta, so pruned weights cannot regrow."""
    sched = self._pruning_schedule
    if sched is None:
      return
    theta = dict(self._task.ThetaTree().FlattenItems())
    if self._pruning_masks is None or sched.ShouldUpdate(
        step, self._last_prune_step):
      self._pruning_masks = pruning_lib.ComputeMasks(theta, sched, step)
      self._last_prune_step = step
    pruning_lib.ApplyMasks(theta, self._pruning_masks)
    if "ema_theta" in state:
      # eval reads the EMA weights: they must be pruned too
      pruning_lib.ApplyMasks(state.ema_theta, self._pruning_masks)

  @property
  def pruning_masks(self) -> dict | None:
    """The masks last applied ({theta path: mask}), None before any."""
    return self._pruning_masks

  def Start(self) -> NestedMap:
    """Runs the main loop until max_steps; returns the final state."""
    # 'no checkpoint at all' (fresh run) is distinct from 'restored the
    # step-0 checkpoint': warm starts apply only to the former
    fresh_run = self._checkpointer.LatestStep() is None
    state = self._CreateTrainState(fresh_run)
    state, start_step = self._checkpointer.Restore(self._module, state=state)
    if fresh_run and self._task is not None:
      tp = self._task.p.train
      if tp.init_from_checkpoint_rules:
        checkpointer_lib.ApplyInitFromCheckpointRules(
            self._task, tp.init_from_checkpoint_rules, state=state)
      if tp.init_from_npz:
        checkpointer_lib.ImportNpzCheckpoint(
            self._task, tp.init_from_npz, tp.init_from_npz_rules,
            state=state)
    if self._mlperf is not None:
      self._mlperf.Print(ml_perf_log.INIT_STOP)
      self._mlperf.Print(ml_perf_log.RUN_START)
    try:
      return self._MainLoop(state, start_step)
    except BaseException:
      if self._mlperf is not None:
        self._mlperf.Print(ml_perf_log.RUN_STOP,
                           metadata={"status": "aborted"})
        self._mlperf.Close()
      raise

  def _SchedulePrograms(self):
    return list(getattr(self._schedule, "programs", None) or [])

  def _ProgramName(self, prog) -> str:
    return getattr(getattr(prog, "p", None), "name", "") or "train"

  def _FlushPrograms(self) -> None:
    """Lands every program's deferred telemetry (PollCompletedResults
    then returns the tail)."""
    for prog in self._SchedulePrograms():
      prog.Flush()

  def _PollPrograms(self) -> list:
    return [(self._ProgramName(prog), r)
            for prog in self._SchedulePrograms()
            for r in prog.PollCompletedResults()]

  def _ForEachProgram(self, method: str, *args) -> None:
    """Best-effort teardown and recovery hooks: they must not mask the
    error being handled."""
    for prog in self._SchedulePrograms():
      try:
        getattr(prog, method)(*args)
      except BaseException:  # noqa: BLE001
        pass

  def _SyncHostSteps(self, step: int) -> None:
    for prog in self._SchedulePrograms():
      prog.SyncHostStep(step)

  def _MainLoop(self, state, start_step):
    try:
      return self._MainLoopBody(state, start_step)
    finally:
      try:
        # a fatal exit must not abandon a background write in flight
        self._checkpointer.WaitForPendingSave()
      except BaseException:  # noqa: BLE001
        pass
      self._ForEachProgram("Shutdown")

  def _Recover(self, e, consecutive_failures):
    """Retry a transient failure from the last checkpoint, or re-raise.
    Returns (state, step)."""
    if (not retry_lib.IsTransient(e) or
        consecutive_failures > self._max_train_retries):
      raise e
    delay = min(2.0 ** consecutive_failures, 30.0)
    print(f"[executor] transient failure ({type(e).__name__}: {e}); "
          f"restoring last checkpoint and retrying "
          f"({consecutive_failures}/{self._max_train_retries}) "
          f"in {delay:.0f}s", flush=True)
    time.sleep(delay)
    # drain the dispatch window (results straddling the failure are
    # unreliable) and restart errored infeed producers
    self._ForEachProgram("RecoverFromFailure")
    state, step = self._Restore()
    self._SyncHostSteps(step)
    return state, step

  def _MainLoopBody(self, state, start_step):
    """Cadence saves write in the background (SaveAsync), and the cadence
    decisions read the loops that completed (PollCompletedResults), so
    they fire within pipeline_depth loops of the offending step; eval
    results are fresh (the schedule flushes the train window before
    eval), and the exit path flushes and decides again over the tail."""
    if not hasattr(self._schedule, "StepsPerCycle"):
      return self._SequentialMainLoopBody(state, start_step)
    if not self._schedule.StepsPerCycle():
      raise ValueError("the executor's schedule needs a train program")
    step = start_step
    self._SyncHostSteps(step)
    consecutive_failures = 0
    while step < self._max_steps:
      # the snapshot is taken here; the write overlaps the cycle below
      self._checkpointer.SaveAsync(step, self._module, state)
      if self._mlperf is not None:
        self._mlperf.Print(ml_perf_log.BLOCK_START, metadata={"step": step})
      try:
        state, run_results = self._schedule.Run(state)
        consecutive_failures = 0
      except BaseException as e:  # noqa: BLE001
        if self._mlperf is not None:
          self._mlperf.Print(ml_perf_log.BLOCK_STOP,
                             metadata={"step": step, "status": "error"})
        consecutive_failures += 1
        state, step = self._Recover(e, consecutive_failures)
        continue
      step = int(state.step)
      self._MaybePrune(state, step)
      # this cycle's inline eval results (fresh), plus the train loops
      # that completed; Run's train result is the same stream lagged
      completed = [(name, r) for name, r in (run_results or {}).items()
                   if isinstance(r, dict) and not name.startswith("train")]
      completed += self._PollPrograms()
      if self._CadenceDecisions(step, completed):
        break
      if self._mlperf is not None:
        self._mlperf.Print(ml_perf_log.BLOCK_STOP, metadata={"step": step})
    self._FlushPrograms()
    tail = self._PollPrograms()
    if tail:
      self._CadenceDecisions(step, tail)
    return self._Finish(step, state)

  def _SequentialMainLoopBody(self, state, start_step):
    """The reference's sequential body, for schedules without a
    deterministic StepsPerCycle (multi-task sampling): a synchronous
    cadence save, one cycle, the step read from the state, and the
    decisions over that cycle's results, every row at that step."""
    step = start_step
    consecutive_failures = 0
    while step < self._max_steps:
      self._checkpointer.Save(step, self._module, state)
      if self._mlperf is not None:
        self._mlperf.Print(ml_perf_log.BLOCK_START, metadata={"step": step})
      try:
        state, results = self._schedule.Run(state)
        consecutive_failures = 0
      except BaseException as e:  # noqa: BLE001
        if self._mlperf is not None:
          self._mlperf.Print(ml_perf_log.BLOCK_STOP,
                             metadata={"step": step, "status": "error"})
        consecutive_failures += 1
        state, step = self._Recover(e, consecutive_failures)
        continue
      step = int(state.step)
      self._MaybePrune(state, step)
      self._PollPrograms()   # the same results, as the stream reports them
      if self._CadenceDecisions(step, list(results.items()),
                                own_steps=False):
        break
      if self._mlperf is not None:
        self._mlperf.Print(ml_perf_log.BLOCK_STOP, metadata={"step": step})
    tail = {self._ProgramName(prog): prog.Flush()
            for prog in self._SchedulePrograms()}
    tail = {k: v for k, v in tail.items() if v is not None}
    self._PollPrograms()
    if tail:
      self._CadenceDecisions(step, list(tail.items()), own_steps=False)
    return self._Finish(step, state)

  def _Finish(self, step, state):
    """Run-stop records, the final forced save and the FINISHED marker
    for follower jobs."""
    if self._mlperf is not None:
      self._mlperf.Print(ml_perf_log.RUN_STOP,
                         metadata={"status": "success", "step": step})
      self._mlperf.Close()
    if not self._trial_done:
      self._trial.ReportDone()
    self._checkpointer.Save(step, self._module, state, force=True)
    self._checkpointer.Close()
    for w in self._checkpointer.writes:
      print(f"[executor] checkpoint step {w['step']}: {w['bytes']} bytes, "
            f"snapshot {w['snapshot_s']:.3f} s, write {w['write_s']:.3f} s",
            flush=True)
    with open(os.path.join(self._checkpointer.train_dir, "FINISHED"),
              "w") as f:
      f.write(str(step))
    return state

  def _CadenceDecisions(self, step: int, completed: list,
                        own_steps: bool = True) -> bool:
    """One cadence pass: metric rows (train rows at their own `at_step`,
    eval rows at `step`; every row at `step` without own_steps: a
    multi-task train result's `at_step` counts its task's steps), then
    the NaN stop, trial reports, MLPerf eval markers and the early stop.
    Returns True when the loop must stop."""
    rows: dict[int, dict] = {}
    for name, r in completed:
      at = (int(r["at_step"]) if own_steps and isinstance(r, dict)
            and "at_step" in r else step)
      rows.setdefault(at, {})[name] = r
    for at in sorted(rows):
      self._ExportMetrics(at, rows[at])
    if _NanTrainLoss(completed):
      if not self._trial_done:
        self._trial.ReportDone(infeasible=True, reason="nan_loss")
        self._trial_done = True
      if self._mlperf is not None:
        self._mlperf.Print(ml_perf_log.RUN_STOP,
                           metadata={"status": "aborted",
                                     "reason": "nan_loss"})
        self._mlperf.Close()
        self._mlperf = None
      print("[executor] NaN/Inf train loss: reporting trial infeasible "
            "and stopping", flush=True)
      return True
    stop_requested = False
    for name, r in completed:
      if isinstance(r, dict) and name.startswith(("eval", "decode")):
        stop_requested |= bool(self._trial.ReportEvalMeasure(step, r))
    if stop_requested or self._trial.ShouldStop():
      print(f"[executor] trial requested early stop at step {step}",
            flush=True)
      return True
    if self._mlperf is not None:
      for name, r in completed:
        if not (isinstance(r, dict) and name.startswith("eval")):
          continue
        if "accuracy" in r:  # eval_accuracy is higher-is-better only
          self._mlperf.Print(ml_perf_log.EVAL_ACCURACY, r["accuracy"],
                             metadata={"step": step, "program": name})
        if "loss" in r:
          self._mlperf.Print("eval_loss", r["loss"],
                             metadata={"step": step, "program": name})
    if self._early_stop is not None and self._task is not None:
      tp = self._task.p.train
      for name, r in completed:
        if (name == tp.early_stop_program and isinstance(r, dict)
            and tp.early_stop_metric in r):
          self._metric_history.ConditionalAppend(step,
                                                 r[tp.early_stop_metric])
      if self._early_stop.Stop(step):
        print(f"[executor] early stop at step {step} "
              f"(no {tp.early_stop_metric} improvement in "
              f"{tp.early_stop_window} steps)", flush=True)
        return True
    return False

  def _ExportMetrics(self, step: int, results: dict[str, Any]):
    path = os.path.join(self._logdir, "metrics.jsonl")
    with open(path, "a") as f:
      f.write(json.dumps({"step": step, **results}, default=float) + "\n")
    summary = {k: v.get("loss", v.get("steps_per_second"))
               for k, v in results.items() if isinstance(v, dict)}
    print(f"[executor] step={step} " +
          " ".join(f"{k}={v:.4g}" for k, v in summary.items()
                   if v is not None), flush=True)
