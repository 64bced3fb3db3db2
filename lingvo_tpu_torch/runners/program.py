"""Programs: the train and eval units and their schedule (port of lingvo_tpu/runners/program.py).

`TrainProgram.Run(state)` takes `steps_per_loop` training steps, each fed
by the task's input generator, and returns the state (updated in place:
the parameters and optimizer slots live on the task and in `state`) and
the weighted means of the task's metrics and the learner's stats over
the loop, plus steps and examples per second. `EvalProgram.Run` runs the
eval-mode FProp over `eval.samples_per_summary` examples of its dataset.
`SimpleProgramSchedule` runs `train_executions_per_eval` train loops,
then every eval program. With a `logdir`, each program appends its
results to `<logdir>/<name>/summaries.jsonl` (and TensorBoard events
when tensorboardX imports); without one it writes nothing.

The reference's defaults hold: `async_infeed` (a producer thread
prepares, and on the card places, the next batches: runners/infeed.py)
and `pipeline_depth` 2. The loop's metrics stay on the device: at its end
the program enqueues one copy of them to pinned host memory and an event,
and the telemetry worker waits on that event, never on the stream, so
the host keeps dispatching the next loop. Run then returns the newest
COMPLETED loop's result, at most `pipeline_depth` loops old (the first
Run of a program blocks for its own). With `async_infeed=False` every
step, fetch and write runs on the calling thread, and Run returns its own
loop's result. Either way each loop's result reaches the executor once,
through `PollCompletedResults`.

`state.step` is a host integer in the port, so the step of every loop is
known when it is dispatched. `SyncHostStep(step)`, called by the
executor at its fences (start, restore), also moves a seekable train
input to batch `step`, so a resumed or retried run reads the batches the
uninterrupted run would have read.

A program turns TF32 off for float32 matrix products and convolutions,
and reduced-precision reductions off for bf16 ones: weights, gradients
and optimizer slots are float32, and under `fprop_dtype=bfloat16` the
activations' products sum in float32.

`EvalProgram.use_ema` (default True, as the reference's) evaluates with
the state's `ema_theta` when it has one: the parameters hold the EMA's
values for the eval and theta is given back bit for bit
(`BaseTask.EmaThetaActive`).

`MultiTaskProgramSchedule` samples one task a cycle with its
`task_schedule` (`core/task_scheduler.py`, a seeded numpy RandomState,
so the sequence is the reference's) and runs that task's train program;
the combined state is NestedMap(tasks={name: state}, step=sum of the
tasks' steps), which one checkpointer saves with `model`, the tasks as
one module. `variable_renaming_rules` share leaves across tasks
(`core/multitask_model.py`): unified at init, the sampled task's values
copied into the others after its cycle.

The reference's on-device loop, its decode and input-benchmark programs
and its switches for a lag-1 window and for fetching metrics on the
calling thread are not implemented here (ROADMAP §1).
"""

from __future__ import annotations

import collections
import functools
import json
import os
import time
from typing import Any

import contextlib

import torch

from lingvo_tpu_torch.core import base_model
from lingvo_tpu_torch.core import hyperparams
from lingvo_tpu_torch.core import input_policy
from lingvo_tpu_torch.core import metrics as metrics_lib
from lingvo_tpu_torch.core import multitask_model
from lingvo_tpu_torch.core import summary_utils
from lingvo_tpu_torch.core import threefry
from lingvo_tpu_torch.core.nested_map import NestedMap
from lingvo_tpu_torch.runners import infeed as infeed_lib


def _StartFetch(accs: list) -> Any:
  """Starts the host read of weighted-metric accumulators ([2] tensors):
  one device-to-host copy of them all, into pinned memory, and an event
  after it. Returns a callable that waits on that event alone and gives
  {name: weighted mean} in FinalizeMetrics' order and arithmetic."""
  names, pairs = [], []
  for acc in accs:
    for k in sorted(acc.keys()):
      names.append(k)
      pairs.append(acc[k])
  if not pairs:
    return dict
  packed = torch.stack(pairs)
  event = None
  if packed.device.type == "cuda":
    packed = packed.to("cpu", non_blocking=True)
    event = torch.cuda.Event()
    event.record()

  def _Finish() -> dict:
    if event is not None:
      event.synchronize()
    return {k: total / max(weight, 1e-8)
            for k, (total, weight) in zip(names, packed.tolist())}

  return _Finish


class BaseProgram:
  """Shared program machinery (ref BaseProgram, program.py:56)."""

  @classmethod
  def Params(cls):
    p = hyperparams.InstantiableParams(cls)
    p.Define("name", "", "Program name (logdir subdir).")
    p.Define("task", None, "Task params.")
    p.Define("logdir", "", "Run log directory ('' = write no summaries).")
    p.Define("steps_per_loop", 100, "Steps per Run() invocation.")
    p.Define("dataset_name", "Train", "Which dataset this program consumes.")
    p.Define("async_infeed", True,
             "Overlap host batch preparation and placement with device "
             "compute through a producer thread (runners/infeed.py), and, "
             "for TrainProgram, defer the post-loop metric fetch and summary "
             "writes to a background worker. False: the fully synchronous "
             "flow.")
    p.Define("infeed_depth", 2, "Bounded infeed queue depth (batches).")
    return p

  def __init__(self, params, task=None, input_generator=None):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs (fprop_dtype bfloat16) sum in float32, as the reference's
    # dots do; cuBLAS may otherwise reduce partial sums in bf16
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    self.p = params.Copy()
    self._task = task if task is not None else params.task.Instantiate()
    self._input = input_generator
    self._program_dir = None
    if self.p.logdir:
      self._program_dir = os.path.join(self.p.logdir,
                                       self.p.name or type(self).__name__)
      os.makedirs(self._program_dir, exist_ok=True)
    self._tb = summary_utils.SummaryWriter(
        self._program_dir, enabled=self._program_dir is not None)
    self._infeed = None
    self._telemetry = None
    # the dispatch window: unresolved telemetry futures, oldest first
    self._pending: collections.deque = collections.deque()
    self._last_result: dict | None = None
    self._last_result_consumed = True
    # completed, unpolled results for the executor's cadence decisions;
    # every loop's result lands here exactly once
    self._completed_unpolled: list = []
    self._rate_tracker = summary_utils.StepRateTracker()

  @property
  def task(self):
    return self._task

  @property
  def input_generator(self):
    if self._input is None:
      ip = self.p.task.input if self.p.task is not None else None
      if ip is None:
        ip = self._task.p.input
      if ip is None:
        raise ValueError(f"Program {self.p.name}: no input params")
      self._input = input_policy.Instantiate(ip)
    return self._input

  def _PutBatch(self, batch: NestedMap) -> NestedMap:
    """Host batch -> tensors on the task's device; on the card from
    pinned memory, enqueued on the calling thread's current stream."""
    dev = self._task.device
    if dev.type != "cuda":
      return batch.Transform(torch.as_tensor)
    return batch.Transform(lambda x: torch.as_tensor(x).pin_memory().to(
        dev, non_blocking=True))

  def _MakeInfeed(self, make_iter, name):
    """A producer thread over make_iter() that also places the batches."""
    return infeed_lib.DeviceInfeed(
        make_iter, place_fn=self._PutBatch, depth=self.p.infeed_depth,
        name=name, stream_key=id(self.input_generator),
        device=self._task.device)

  def Run(self, state: NestedMap) -> tuple[NestedMap, dict[str, float]]:
    raise NotImplementedError

  def WriteSummaries(self, step: int, values: dict[str, float]) -> None:
    if self._program_dir is None:
      return
    path = os.path.join(self._program_dir, "summaries.jsonl")
    with open(path, "a") as f:
      f.write(json.dumps({"step": step, **values}) + "\n")
    self._tb.Scalars(values, step)
    self._tb.Flush()

  # -- async infeed / deferred telemetry lifecycle ---------------------------

  def SyncHostStep(self, step: int) -> None:
    """Executor fence (start, restore): the train state is at `step`."""

  def _PopPending(self) -> dict:
    """Resolves the OLDEST pending loop (blocking); its result becomes the
    newest completed result and joins the unpolled cadence stream."""
    res = self._pending.popleft().result()[1]
    self._last_result = res
    self._last_result_consumed = False
    self._completed_unpolled.append(res)
    return res

  def PollCompletedResults(self) -> list:
    """Drains, without blocking, every result completed since the last
    poll: the executor's cadence stream. Each result appears once."""
    while self._pending and self._pending[0].done():
      self._PopPending()
    out, self._completed_unpolled = self._completed_unpolled, []
    return out

  def Flush(self):
    """Waits for ALL deferred telemetry and flushes the event writer;
    returns the newest completed result if no Run handed it out yet,
    else None. Called at program boundaries and before the final
    checkpoint, so summaries land in order and the tail result still
    reaches the NaN stop and the metrics."""
    out = None
    while self._pending:
      self._PopPending()
    if not self._last_result_consumed:
      out = self._last_result
      self._last_result_consumed = True
    self._tb.Flush()
    return out

  def RecoverFromFailure(self) -> None:
    """Executor retry hook: drain pending telemetry (its error is already
    being handled upstream) and restart an errored infeed producer."""
    while self._pending:
      try:
        self._pending.popleft().result()
      except BaseException:  # noqa: BLE001
        pass
    # results straddling the failure are unreliable
    self._last_result = None
    self._last_result_consumed = True
    self._completed_unpolled = []
    if self._infeed is not None and not self._infeed.healthy:
      self._infeed.Reset()

  def Shutdown(self) -> None:
    """Teardown between programs and at executor exit: best-effort
    telemetry flush, then stop the producer thread and the worker. The
    program stays usable: the next Run restarts both."""
    try:
      self.Flush()
    except BaseException:  # noqa: BLE001 - already surfaced via Run/Flush
      pass
    if self._infeed is not None:
      self._infeed.Stop()
      self._infeed = None
    if self._telemetry is not None:
      self._telemetry.Shutdown()
      self._telemetry = None


class TrainProgram(BaseProgram):
  """steps_per_loop training steps per Run (ref TrainProgram:442)."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.name = "train"
    p.Define("base_step_seed", 1234,
             "Base PRNG seed of the step seeds: step s draws dropout and "
             "sampled negatives from fold_in(PRNGKey(base_step_seed), s).")
    p.Define("pipeline_depth", 2,
             "Dispatch window under async_infeed: Run may leave up to this "
             "many loops' telemetry unresolved, so loop k+1 dispatches "
             "before loop k's metrics land (0: each Run resolves its own).")
    return p

  def SyncHostStep(self, step: int) -> None:
    """Moves a seekable train input to batch `step` (one batch a step).
    The producer is stopped first, and its read-ahead batches dropped, so
    no pull of it can land after the seek; the next Get restarts it."""
    if self.p.async_infeed:
      self._GetInfeed().Reset()
    try:
      self.input_generator.Seek(step)
    except NotImplementedError:
      pass   # the stream resumes where it stands, as in the reference

  def _GetInfeed(self):
    if self._infeed is None:
      gen = self.input_generator

      def _Batches():
        while True:
          try:
            batch = gen.GetPreprocessedInputBatch()
          except StopIteration:
            return
          yield batch

      self._infeed = self._MakeInfeed(_Batches,
                                      f"{self.p.name or 'train'}-infeed")
    return self._infeed

  def _GetTelemetry(self):
    if self._telemetry is None:
      self._telemetry = infeed_lib.DeferredTelemetry(
          name=f"{self.p.name or 'train'}-telemetry")
    return self._telemetry

  def _Step(self, state, batch, acc, stats_acc):
    out = self._task.TrainStep(state, batch,
                               threefry.PRNGKey(self.p.base_step_seed))
    acc = metrics_lib.AccumulateMetrics(acc, out.metrics)
    stats_acc = metrics_lib.AccumulateMetrics(stats_acc, NestedMap(
        {k: (v, 1.0) for k, v in out.stats.FlattenItems()}))
    return acc, stats_acc

  def _RefreshHostSchedules(self) -> None:
    """Host-driven schedules (DevBasedSchedule's anneal on plateau) read
    their metric history before each loop; the reference also drops its
    jitted functions when the value changed, the port has none to drop."""
    for lrn in self._task.Learners():
      if hasattr(lrn.lr_sched, "UpdateFromHistory"):
        lrn.lr_sched.UpdateFromHistory()

  def Run(self, state: NestedMap) -> tuple[NestedMap, dict[str, float]]:
    self._RefreshHostSchedules()
    if not self.p.async_infeed:
      return self._RunSync(state)
    return self._RunAsync(state)

  def _RunSync(self, state: NestedMap) -> tuple[NestedMap, dict[str, float]]:
    """The fully synchronous loop (async_infeed False): batch preparation,
    steps, metric fetch and summary writes all on this thread."""
    p = self.p
    t0 = time.time()
    acc = stats_acc = None
    infeed_wait_s = 0.0
    gen = self.input_generator
    for _ in range(p.steps_per_loop):
      t_in = time.perf_counter()
      batch = self._PutBatch(gen.GetPreprocessedInputBatch())
      infeed_wait_s += time.perf_counter() - t_in
      acc, stats_acc = self._Step(state, batch, acc, stats_acc)
    t_tel = time.perf_counter()
    result = _StartFetch([a for a in (acc, stats_acc) if a])()
    wall = time.time() - t0
    result["steps_per_second"] = p.steps_per_loop / wall
    result["examples_per_second"] = (
        p.steps_per_loop * gen.GlobalBatchSize() / wall)
    step = int(state.step)
    result["infeed_wait_s"] = round(infeed_wait_s, 6)
    result["host_overhead_s"] = round(
        infeed_wait_s + (time.perf_counter() - t_tel), 6)
    result["global_steps_per_second"] = self._rate_tracker.Update(
        step, gen.GlobalBatchSize())
    self.WriteSummaries(step, result)
    result["at_step"] = step
    self._completed_unpolled.append(result)
    return state, result

  def _RunAsync(self, state: NestedMap) -> tuple[NestedMap, dict[str, float]]:
    """Batches come prepared (and placed) from the infeed producer; the
    post-loop metric fetch and summary write run on the telemetry worker.
    The batch order is _RunSync's; the returned result is the newest
    COMPLETED loop's (at most pipeline_depth loops old; the first Run
    blocks for its own)."""
    p = self.p
    t0 = time.time()
    infeed = self._GetInfeed()
    wait0 = infeed.wait_s
    acc = stats_acc = None
    for _ in range(p.steps_per_loop):
      batch = infeed.Get()
      if batch is None:
        raise StopIteration("train input exhausted")
      acc, stats_acc = self._Step(state, batch, acc, stats_acc)
    # host-side cost of this Run (input wait + placement + dispatch)
    host_overhead_s = time.time() - t0
    infeed_wait_s = infeed.wait_s - wait0
    job = functools.partial(
        self._FinalizeLoop, int(state.step),
        _StartFetch([a for a in (acc, stats_acc) if a]), t0,
        host_overhead_s, infeed_wait_s, infeed.QueueDepth())
    # sweep completed loops, then apply backpressure so at most
    # pipeline_depth loops stay unresolved
    self._pending.append(self._GetTelemetry().Submit(job))
    while self._pending and self._pending[0].done():
      self._PopPending()
    while len(self._pending) > int(p.pipeline_depth):
      self._PopPending()
    if self._last_result is None:
      self._PopPending()   # the very first loop (or first after recovery)
    self._last_result_consumed = True
    return state, self._last_result

  def _FinalizeLoop(self, step, fetch, t_start, host_overhead_s,
                    infeed_wait_s, queue_depth) -> tuple[int, dict]:
    """Telemetry-worker job: one loop's metrics and its summary write.
    `fetch` waits for the loop's end on the card, so `wall` covers
    dispatch through completion."""
    p = self.p
    result = fetch()
    wall = max(time.time() - t_start, 1e-9)
    gen = self.input_generator
    result["steps_per_second"] = p.steps_per_loop / wall
    result["examples_per_second"] = (
        p.steps_per_loop * gen.GlobalBatchSize() / wall)
    result["infeed_wait_s"] = round(infeed_wait_s, 6)
    result["host_overhead_s"] = round(host_overhead_s, 6)
    result["infeed_queue_depth"] = queue_depth
    result["global_steps_per_second"] = self._rate_tracker.Update(
        step, gen.GlobalBatchSize())
    self.WriteSummaries(step, result)
    # stamped after the summary write: lets the executor's metrics rows
    # name the loop a lagged result belongs to
    result["at_step"] = step
    return step, result


class EvalProgram(BaseProgram):
  """Eval over samples_per_summary examples with weighted-metric
  accumulation (ref EvalProgram:927)."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.name = "eval"
    p.dataset_name = "Test"
    p.Define("use_ema", True, "Eval with EMA weights when available.")
    return p

  def _MaxEvalBatches(self) -> int:
    """The task's eval.samples_per_summary over the batch size, rounded up
    (0 = steps_per_loop batches)."""
    sps = getattr(self._task.p.eval, "samples_per_summary", 0)
    if sps:
      bs = max(1, self.input_generator.InfeedBatchSize())
      return max(1, -(-sps // bs))
    return self.p.steps_per_loop

  def Run(self, state: NestedMap) -> tuple[NestedMap, dict[str, float]]:
    gen = self.input_generator
    max_batches = self._MaxEvalBatches()
    raw = _TakeN(gen, max_batches)
    # one throwaway infeed per Run: exactly max_batches are drawn
    infeed = None
    if self.p.async_infeed:
      infeed = self._MakeInfeed(lambda: raw,
                                f"{self.p.name or 'eval'}-infeed")
    acc = None
    infeed_wait_s = 0.0
    theta = (self._task.EmaThetaActive(state) if self.p.use_ema
             else contextlib.nullcontext())
    try:
      with theta:
        for batch in (infeed.Iter() if infeed is not None else raw):
          if infeed is None:
            batch = self._PutBatch(batch)
          metrics, _ = self._task.EvalStep(batch)
          acc = metrics_lib.AccumulateMetrics(acc, metrics)
    finally:
      if infeed is not None:
        infeed_wait_s = infeed.wait_s
        infeed.Stop()
    result = _StartFetch([acc] if acc else [])()
    if infeed is not None:
      result["infeed_wait_s"] = round(infeed_wait_s, 6)
    self.WriteSummaries(int(state.step), result)
    return state, result


def PlaceStateForPrograms(programs, state):
  """The reference places a train state onto a program's mesh shardings;
  the port's programs run on one device, where the state already is."""
  del programs
  return state


def _TakeN(gen, n):
  it = iter(gen)
  for _ in range(n):
    try:
      yield next(it)
    except StopIteration:
      return


class SimpleProgramSchedule:
  """Train K loops, then run the eval programs (ref
  SimpleProgramSchedule:1217)."""

  @classmethod
  def Params(cls):
    p = hyperparams.InstantiableParams(cls)
    p.Define("name", "schedule", "Name.")
    p.Define("train_program", None, "TrainProgram params (or None).")
    p.Define("eval_programs", [], "List of eval program params.")
    p.Define("train_executions_per_eval", 1,
             "Train Run() calls between eval rounds.")
    return p

  def __init__(self, params, task=None, input_generators=None):
    self.p = params.Copy()
    input_generators = input_generators or {}
    self.train_program = None
    if self.p.train_program is not None:
      self.train_program = self.p.train_program.cls(
          self.p.train_program, task=task,
          input_generator=input_generators.get(
              self.p.train_program.dataset_name))
    self.eval_programs = [
        ep.cls(ep, task=task,
               input_generator=input_generators.get(ep.dataset_name))
        for ep in self.p.eval_programs
    ]

  @property
  def programs(self):
    out = []
    if self.train_program:
      out.append(self.train_program)
    return out + list(self.eval_programs)

  def StepsPerCycle(self) -> int:
    """Optimizer steps one Run() advances the train state by (0 = no
    train program)."""
    if self.train_program is None:
      return 0
    return (max(1, self.p.train_executions_per_eval)
            * int(self.train_program.p.steps_per_loop))

  def Run(self, state: NestedMap) -> tuple[NestedMap, dict[str, Any]]:
    results: dict[str, Any] = {}
    if self.train_program is not None:
      train_result = None
      for _ in range(max(1, self.p.train_executions_per_eval)):
        state, train_result = self.train_program.Run(state)
      results["train"] = train_result
      if self.eval_programs:
        # program boundary: land the deferred telemetry of the last train
        # loop before eval starts, and report the CURRENT loop's result
        flushed = self.train_program.Flush()
        if flushed is not None:
          results["train"] = flushed
    for ep in self.eval_programs:
      state, r = ep.Run(state)
      results[ep.p.name] = r
    return state, results


class MultiTaskProgramSchedule:
  """Per-task train programs driven by a sampling TaskScheduler (ref
  MultiTaskProgramSchedule:1285): each cycle samples one task name and
  runs that task's TrainProgram. It has no `StepsPerCycle` (the steps of
  a cycle depend on the sampled task), so the executor runs it in its
  sequential main-loop body."""

  @classmethod
  def Params(cls):
    p = hyperparams.InstantiableParams(cls)
    p.Define("name", "multitask_schedule", "Name.")
    p.Define("task_schedule", None, "TaskScheduler params.")
    p.Define("train_programs", None,
             "Params holding one TrainProgram params per task name.")
    p.Define("eval_programs", [], "Eval program params (any task).")
    p.Define("train_executions_per_eval", 1,
             "Train cycles between eval rounds.")
    p.Define("variable_renaming_rules", [],
             "[(regex, replacement)] over dotted theta paths; tasks whose "
             "renamed paths collide share those variables "
             "(core/multitask_model.py).")
    return p

  def __init__(self, params, tasks: dict | None = None,
               input_generators: dict | None = None, device=None):
    """tasks: {task_name: task instance} (instantiated on `device` from
    each train program's task params when omitted); input_generators:
    {(task_name, dataset_name): generator}, or {dataset_name: generator}
    for every task."""
    self.p = params.Copy()
    input_generators = input_generators or {}
    # the tasks as one module, what the checkpointer saves and restores
    model_p = base_model.MultiTaskModel.Params().Set(name=self.p.name)
    if tasks is None:
      model_p.task_params = hyperparams.Params()
      for name, tp in self.p.train_programs.IterParams():
        model_p.task_params.Define(name, tp.task, "")
      self.model = model_p.Instantiate(device=device)
      tasks = {n: self.model.GetTask(n) for n in self.model.task_names}
    else:
      self.model = model_p.Instantiate(
          device=next(iter(tasks.values())).device, tasks=tasks)
    for t in tasks.values():
      t.FinalizePaths()
    self._tasks = dict(tasks)
    self._scheduler = self.p.task_schedule.Instantiate()
    self._runs_since_eval = 0
    self._shared_rules = None
    if self.p.variable_renaming_rules:
      self._shared_rules = multitask_model.SharedVariableRules(
          self.p.variable_renaming_rules)

    def _GenFor(name, dataset):
      if (name, dataset) in input_generators:
        return input_generators[(name, dataset)]
      return input_generators.get(dataset)

    self.train_programs = {}
    for name, tp in self.p.train_programs.IterParams():
      self.train_programs[name] = tp.cls(
          tp, task=tasks[name],
          input_generator=_GenFor(name, tp.dataset_name))
    self.eval_programs = []
    for ep in self.p.eval_programs:
      task_name = getattr(ep, "task_name", None) or next(iter(tasks))
      self.eval_programs.append(
          ep.cls(ep, task=tasks[task_name],
                 input_generator=_GenFor(task_name, ep.dataset_name)))

  @property
  def programs(self):
    return list(self.train_programs.values()) + list(self.eval_programs)

  @property
  def tasks(self):
    return dict(self._tasks)

  def CreateTrainState(self, generator: torch.Generator | None = None
                       ) -> NestedMap:
    """NestedMap(tasks={name: train state}, step=0). With a generator,
    each task's weights are drawn from it in sorted task order, then the
    shared leaves are unified (the first task in sorted order donates)."""
    states = NestedMap()
    for name in sorted(self._tasks):
      states[name] = self._tasks[name].CreateTrainState(generator)
    if self._shared_rules is not None and generator is not None:
      self._shared_rules.UnifyStates(self._tasks)
    return NestedMap(tasks=states, step=0)

  def Run(self, state: NestedMap) -> tuple[NestedMap, dict[str, Any]]:
    name = self._scheduler.Sample(int(state.step))
    task_state, result = self.train_programs[name].Run(state.tasks[name])
    state.tasks[name] = task_state
    if self._shared_rules is not None:
      self._shared_rules.Propagate(self._tasks, name)
    state.step = sum(int(state.tasks[n].step) for n in sorted(self._tasks))
    results = {f"train_{name}": result, "sampled_task": name}
    self._runs_since_eval += 1
    if self._runs_since_eval >= max(1, self.p.train_executions_per_eval):
      self._runs_since_eval = 0
      if self.eval_programs:
        # program boundary: see SimpleProgramSchedule.Run
        flushed = self.train_programs[name].Flush()
        if flushed is not None:
          results[f"train_{name}"] = flushed
      for ep in self.eval_programs:
        task_name = (getattr(ep.p, "task_name", None)
                     or next(iter(self._tasks)))
        st, r = ep.Run(state.tasks[task_name])
        state.tasks[task_name] = st
        results[ep.p.name] = r
    return state, results
