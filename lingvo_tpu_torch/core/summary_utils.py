"""Summaries: TensorBoard event files and step-rate tracking (port of part of lingvo_tpu/core/summary_utils.py).

`SummaryWriter` writes event files when `tensorboardX` imports and is a
no-op otherwise, as the reference's; the programs write the
machine-readable JSONL beside it always. `StepRateTracker` smooths
steps/sec across Runs. The reference's attention images and registry
bridge come with `observe/` (ROADMAP item 11).
"""

from __future__ import annotations

import threading
import time

import numpy as np


class SummaryWriter:
  """Event-file writer; a no-op when tensorboardX is missing.

  Writes are serialized with a lock: under deferred telemetry the train
  program writes from a background worker while Flush may come from the
  main thread at program boundaries.
  """

  def __init__(self, logdir: str, enabled: bool = True):
    self._writer = None
    self._lock = threading.Lock()
    if not enabled:
      return
    try:
      from tensorboardX import SummaryWriter as TbWriter
      self._writer = TbWriter(logdir=logdir)
    except Exception:  # noqa: BLE001 - tensorboardX is optional
      self._writer = None

  def Scalar(self, tag: str, value, step: int):
    with self._lock:
      if self._writer is not None:
        self._writer.add_scalar(tag, float(value), step)

  def Scalars(self, values: dict, step: int, prefix: str = ""):
    for k, v in values.items():
      if isinstance(v, (int, float, np.floating, np.integer)):
        self.Scalar(f"{prefix}{k}" if prefix else k, v, step)

  def Flush(self):
    with self._lock:
      if self._writer is not None:
        self._writer.flush()


class StepRateTracker:
  """steps/sec + examples/sec with a decaying window (ref StepRateTracker)."""

  def __init__(self):
    self._start = None
    self._last_step = 0
    self._rate = 0.0
    self._example_rate = 0.0

  def Update(self, step: int, examples_per_step: float = 0.0):
    now = time.time()
    if self._start is None:
      self._start = now
      self._last_step = step
      return self._rate
    dt = max(now - self._start, 1e-6)
    inst = (step - self._last_step) / dt
    # exponential decay toward the instantaneous rate
    blend = 0.5 if self._rate else 1.0
    self._rate = blend * inst + (1 - blend) * self._rate
    self._example_rate = self._rate * examples_per_step
    self._start = now
    self._last_step = step
    return self._rate

  @property
  def steps_per_second(self) -> float:
    return self._rate

  @property
  def examples_per_second(self) -> float:
    return self._example_rate


def ModelAnalysis(task) -> list[str]:
  """The parameter-count report of `model_analysis.txt` and
  `--mode=inspect_model` (ref summary_utils.ModelAnalysis): one row per
  theta path with its shape and size, then the TOTAL. `task` may also be
  {task name: task} (a multi-task schedule's), each row's path then
  prefixed `{name}.`."""
  tasks = task if isinstance(task, dict) else {"": task}
  lines = []
  total = 0
  for tname, t in sorted(tasks.items()):
    prefix = f"{tname}." if tname else ""
    for path, spec in t.VariableSpecs().FlattenItems():
      n = int(np.prod(spec.shape)) if spec.shape else 1
      total += n
      lines.append(f"{prefix}{path:<60} {str(tuple(spec.shape)):<20} {n}")
  lines.append(f"{'TOTAL':<60} {'':<20} {total}")
  return lines
