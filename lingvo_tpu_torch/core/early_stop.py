"""Early stopping on metric plateaus and metric history files (port of lingvo_tpu/core/early_stop.py).

Re-designs `lingvo/core/early_stop.py` (MetricHistory:24, EarlyStop:126) and
the C++ BestStep op (`ops/best_step_op_kernels.cc`): the history is a jsonl
file of (step, value); BestStep scans it with an optional tolerance; EarlyStop
signals once no improvement has occurred within `window` steps.
"""

from __future__ import annotations

import json
import os

from lingvo_tpu_torch.core import hyperparams


class MetricHistory:
  """Appends (step, value) for one jobname/metric to a history file."""

  def __init__(self, logdir: str, jobname: str, metric: str,
               minimize: bool = True):
    self.jobname = jobname
    self.metric = metric
    self.minimize = minimize
    os.makedirs(logdir, exist_ok=True)
    self.path = os.path.join(logdir, f"{jobname}.{metric}.history.jsonl")

  def ConditionalAppend(self, step: int, value: float) -> None:
    with open(self.path, "a") as f:
      f.write(json.dumps({"step": int(step), "value": float(value)}) + "\n")

  def Read(self) -> list[tuple[int, float]]:
    return ReadHistory(self.path)


def ReadHistory(path: str) -> list[tuple[int, float]]:
  """All (step, value) records of a history file (empty if missing)."""
  if not os.path.exists(path):
    return []
  out = []
  with open(path) as f:
    for line in f:
      if line.strip():
        rec = json.loads(line)
        out.append((rec["step"], rec["value"]))
  return out


def BestStep(history_path: str, tolerance: float = 0.0,
             minimize: bool = True) -> tuple[int, int]:
  """Returns (best_step, last_step) from a history file (ref BestStep op).

  A new best must improve by more than `tolerance` over the incumbent.
  """
  if not os.path.exists(history_path):
    return 0, 0
  best_step = last_step = 0
  best_val = None
  with open(history_path) as f:
    for line in f:
      if not line.strip():
        continue
      rec = json.loads(line)
      step, val = rec["step"], rec["value"]
      last_step = step
      better = (best_val is None or
                (val < best_val - tolerance if minimize else
                 val > best_val + tolerance))
      if better:
        best_val = val
        best_step = step
  return best_step, last_step


class EarlyStop:
  """Plateau detector (ref EarlyStop:126)."""

  @classmethod
  def Params(cls):
    p = hyperparams.InstantiableParams(cls)
    p.Define("name", "early_stop", "Name.")
    p.Define("window", 0, "Steps without improvement before stopping "
             "(0 = disabled).")
    p.Define("tolerance", 0.0, "Required improvement margin.")
    p.Define("metric_history", None, "MetricHistory instance or None.")
    p.Define("min_steps", 0, "Never stop before this step.")
    p.Define("minimize", True, "Lower is better.")
    return p

  def __init__(self, params):
    self.p = params.Copy()
    self.metric_history = self.p.metric_history

  def Stop(self, current_step: int | None = None) -> bool:
    p = self.p
    if p.window <= 0 or self.metric_history is None:
      return False
    # no recorded evals yet -> never stop (a missing history must not read
    # as 'best was step 0')
    if not self.metric_history.Read():
      return False
    best, last = BestStep(self.metric_history.path, p.tolerance, p.minimize)
    step = current_step if current_step is not None else last
    if step < p.min_steps:
      return False
    return (step - best) > p.window
