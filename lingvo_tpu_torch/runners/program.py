"""The training program (port of part of lingvo_tpu/runners/program.py).

`TrainProgram.Run(state)` takes `steps_per_loop` synchronous training
steps, each fed by the task's input generator, and returns the state
(updated in place: the parameters and optimizer slots live on the task
and in `state`) and the weighted means of the task's metrics and the
learner's stats over the loop, as the reference's synchronous loop
returns them, plus steps and examples per second.

The program is where training starts, so it turns TF32 off for float32
matrix products and convolutions, and reduced-precision reductions off
for bf16 ones: weights, gradients and optimizer slots are float32, and
under `fprop_dtype=bfloat16` the activations' products sum in float32.

The reference's asynchronous infeed, on-device loop, telemetry,
checkpointer, eval and decode programs and the trainer CLI come with a
later slice.
"""

from __future__ import annotations

import time

import torch

from lingvo_tpu_torch.core import hyperparams
from lingvo_tpu_torch.core import metrics as metrics_lib
from lingvo_tpu_torch.core.nested_map import NestedMap


class TrainProgram:
  """steps_per_loop training steps per Run."""

  @classmethod
  def Params(cls) -> hyperparams.InstantiableParams:
    p = hyperparams.InstantiableParams(cls)
    p.Define("steps_per_loop", 100, "Steps per Run() invocation.")
    return p

  def __init__(self, params, task, input_generator=None):
    """task: the instantiated task (on its device). input_generator: None
    builds the task's p.input."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs (fprop_dtype bfloat16) sum in float32, as the reference's
    # dots do; cuBLAS may otherwise reduce partial sums in bf16
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    self.p = params.Copy()
    self._task = task
    if input_generator is None:
      if task.p.input is None:
        raise ValueError("TrainProgram needs an input generator or a task "
                         "with p.input set")
      input_generator = task.p.input.Instantiate()
    self._input = input_generator

  def _PutBatch(self, batch: NestedMap) -> NestedMap:
    dev = self._task.device
    return batch.Transform(lambda x: torch.as_tensor(x).to(dev))

  def Run(self, state: NestedMap) -> tuple[NestedMap, dict[str, float]]:
    """steps_per_loop TrainSteps; one host sync at the end of the loop."""
    p = self.p
    t0 = time.perf_counter()
    acc = stats_acc = None
    for _ in range(p.steps_per_loop):
      batch = self._PutBatch(self._input.GetPreprocessedInputBatch())
      out = self._task.TrainStep(state, batch)
      acc = metrics_lib.AccumulateMetrics(acc, out.metrics)
      stats_acc = metrics_lib.AccumulateMetrics(stats_acc, NestedMap(
          {k: (v, 1.0) for k, v in out.stats.FlattenItems()}))
    result = metrics_lib.FinalizeMetrics(acc) if acc else {}
    if stats_acc:
      result.update(metrics_lib.FinalizeMetrics(stats_acc))
    wall = time.perf_counter() - t0
    result["steps_per_second"] = p.steps_per_loop / wall
    result["examples_per_second"] = (
        p.steps_per_loop * self._input.GlobalBatchSize() / wall)
    return state, result
