"""Multi-task sampling schedulers (port of lingvo_tpu/core/task_scheduler.py).

The executor samples a task each program cycle (ref executor.py:573):
constant probabilities, exponentially-annealed interpolation, and
adaptive (loss-proportional) scheduling.
"""

from __future__ import annotations

import numpy as np

from lingvo_tpu_torch.core import hyperparams


class TaskScheduler:

  @classmethod
  def Params(cls):
    p = hyperparams.InstantiableParams(cls)
    p.Define("name", "scheduler", "Name.")
    p.Define("task_probs", [], "List of (task_name, prob).")
    p.Define("seed", 0, "Sampling seed.")
    return p

  def __init__(self, params):
    self.p = params.Copy()
    self._rng = np.random.RandomState(self.p.seed)
    self.cur_probs = None

  def Sample(self, current_step: int) -> str:
    raise NotImplementedError


class ConstantScheduler(TaskScheduler):
  """Fixed sampling probabilities (ref ConstantScheduler)."""

  def __init__(self, params):
    super().__init__(params)
    names = [t for t, _ in self.p.task_probs]
    probs = np.asarray([p for _, p in self.p.task_probs], np.float64)
    self._names = names
    self._probs = probs / probs.sum()
    self.cur_probs = self._probs

  def Sample(self, current_step: int) -> str:
    return str(self._rng.choice(self._names, p=self._probs))


class ExponentialScheduler(TaskScheduler):
  """Interpolates each task's prob from start to final with exp decay
  (ref ExponentialScheduler)."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("alpha", 1e-5, "Decay rate exponent per step.")
    p.Define("task_probs_final", [], "(task, final prob) pairs.")
    return p

  def __init__(self, params):
    super().__init__(params)
    self._names = [t for t, _ in self.p.task_probs]
    self._start = np.asarray([p for _, p in self.p.task_probs], np.float64)
    self._final = np.asarray([p for _, p in self.p.task_probs_final],
                             np.float64)

  def Sample(self, current_step: int) -> str:
    decay = np.exp(-self.p.alpha * current_step)
    probs = self._start * decay + self._final * (1 - decay)
    probs = probs / probs.sum()
    self.cur_probs = probs
    return str(self._rng.choice(self._names, p=probs))


class AdaptiveScheduler(TaskScheduler):
  """Samples proportionally to how far each task is from its target metric
  (ref AdaptiveScheduler): tasks lagging their goal get more steps."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("targets", [], "(task, target_metric_value) pairs.")
    p.Define("temperature", 1.0, "Sampling temperature.")
    return p

  def __init__(self, params):
    super().__init__(params)
    self._names = [t for t, _ in self.p.targets]
    self._targets = {t: v for t, v in self.p.targets}
    self._latest = {t: None for t in self._names}

  def ReportMetric(self, task_name: str, value: float) -> None:
    self._latest[task_name] = value

  def Sample(self, current_step: int) -> str:
    gaps = []
    for t in self._names:
      latest = self._latest[t]
      if latest is None:
        gaps.append(1.0)
      else:
        gaps.append(max(latest / max(self._targets[t], 1e-8), 1e-3))
    gaps = np.asarray(gaps, np.float64)**(1.0 / self.p.temperature)
    probs = gaps / gaps.sum()
    self.cur_probs = probs
    return str(self._rng.choice(self._names, p=probs))
