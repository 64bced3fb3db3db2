"""Learning-rate schedules (port of part of lingvo_tpu/core/schedule.py).

Each schedule is a Params-configured layer whose `Value(step)` is a 0-d
float32 CPU tensor, computed in float32 with the reference's op order.
The reference computes it inside its jitted train step, where XLA makes
a division by a Python constant a product with the constant's float32
reciprocal: the schedules ported with the 1B-words recipe's learner
(PiecewiseConstant, Polynomial, LinearRampupExponentialDecay,
TransformerSchedule, ExponentialDecay) do the same (`jit_arith`), and
an integer power is XLA's product chain (`_IntegerPow`). `Constant` and
`LinearRampupCosineDecay` keep the true division they were ported with.

`DevBasedSchedule` (anneal on plateau) decides on the host: it replays
the reference's algorithm over the port's metric history file
(`early_stop.MetricHistory`) whenever `TrainProgram.Run` refreshes it
(`UpdateFromHistory`), and `Value` is the current factor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import early_stop
from lingvo_tpu_torch.core import jit_arith


def _F32(x) -> torch.Tensor:
  return torch.tensor(np.float32(x), dtype=torch.float32)


def _IntegerPow(x: torch.Tensor, n: int) -> torch.Tensor:
  """x ** n for a Python int n >= 0 as `lax.integer_pow` computes it:
  binary powering, each product rounded in float32."""
  acc = None
  while n > 0:
    if n & 1:
      acc = x if acc is None else acc * x
    n >>= 1
    if n:
      x = x * x
  return torch.ones_like(x) if acc is None else acc


class BaseSchedule(base_layer.BaseLayer):

  def Value(self, step) -> torch.Tensor:
    raise NotImplementedError


class Constant(BaseSchedule):

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("value", 1.0, "The constant value.")
    return p

  def Value(self, step):
    del step
    return torch.tensor(self.p.value, dtype=torch.float32)


class LinearRampupCosineDecay(BaseSchedule):
  """Linear warmup then cosine decay to min_ratio."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("warmup_steps", 1000, "Warmup steps.")
    p.Define("total_steps", 100000, "Steps at which decay completes.")
    p.Define("min_ratio", 0.1, "Final value as a fraction of peak.")
    p.Define("max", 1.0, "Peak value.")
    return p

  def Value(self, step):
    p = self.p
    x = torch.tensor(step, dtype=torch.float32)
    warm = x / max(1.0, p.warmup_steps)
    ratio = torch.clamp((x - p.warmup_steps) /
                        max(1.0, p.total_steps - p.warmup_steps), 0.0, 1.0)
    cos = p.min_ratio + (1 - p.min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * ratio))
    return p.max * torch.where(x < p.warmup_steps, warm, cos)


class PiecewiseConstant(BaseSchedule):
  """values[i] where i counts the boundaries the step has reached."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("boundaries", [], "Step boundaries (ascending).")
    p.Define("values", [], "len(boundaries)+1 values.")
    return p

  def Value(self, step):
    p = self.p
    assert len(p.values) == len(p.boundaries) + 1
    index = sum(int(step) >= int(b) for b in p.boundaries)
    return _F32(p.values[index])


class Polynomial(BaseSchedule):
  """Polynomial interpolation between (x0, y0) and (x1, y1)."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("power", 1, "Polynomial power.")
    p.Define("start", (0, 0.0), "(step, value) start point.")
    p.Define("limit", (1, 1.0), "(step, value) end point.")
    p.Define("origin", "start", "'start' or 'limit': where f(x)=x^p anchors.")
    return p

  def _Pow(self, x):
    power = self.p.power
    if isinstance(power, int):
      return _IntegerPow(x, power)
    return torch.pow(x, _F32(power))

  def Value(self, step):
    p = self.p
    x = _F32(step)
    x0, y0 = p.start
    x1, y1 = p.limit
    ratio = torch.clamp(
        (x - x0) * jit_arith.Reciprocal(max(1.0, (x1 - x0))), 0.0, 1.0)
    if p.origin == "start":
      f = self._Pow(ratio)
    else:
      f = 1.0 - self._Pow(1.0 - ratio)
    return (y0 + f * (y1 - y0)).float()


class LinearRampupExponentialDecay(BaseSchedule):
  """Linear warmup to max, flat to decay_start, then exponential decay
  to min at decay_end."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("warmup", 100, "Steps of linear warmup to max.")
    p.Define("decay_start", 1000, "Step to start decay.")
    p.Define("decay_end", 10000, "Step decay reaches min.")
    p.Define("max", 1.0, "Peak multiplier.")
    p.Define("min", 0.01, "Final multiplier.")
    return p

  def Value(self, step):
    p = self.p
    x = _F32(step)
    warm = x * jit_arith.Reciprocal(max(1.0, p.warmup)) * p.max
    ratio = torch.clamp(
        (x - p.decay_start) *
        jit_arith.Reciprocal(max(1.0, p.decay_end - p.decay_start)), 0.0, 1.0)
    decayed = p.max * torch.pow(_F32(p.min / p.max), ratio)
    val = torch.where(x < p.warmup, warm,
                      torch.where(x < p.decay_start, _F32(p.max), decayed))
    return torch.clamp(val, min=0.0)


class TransformerSchedule(BaseSchedule):
  """model_dim^-0.5 * min((x + 1) warmup^-1.5, (x + 1)^-0.5), x the step
  floored at 1 (and capped at decay_end when set)."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("warmup_steps", 4000, "Warmup steps.")
    p.Define("model_dim", 512, "Model dim; scales by model_dim^-0.5.")
    p.Define("worker_replicas", 1, "Data-parallel replicas (kept for parity).")
    p.Define("decay_end", None, "If set, freeze value after this step.")
    return p

  def Value(self, step):
    p = self.p
    x = torch.clamp(_F32(step), min=1.0)
    if p.decay_end is not None:
      x = torch.clamp(x, max=float(p.decay_end))
    return (p.model_dim**-0.5) * torch.minimum(
        (x + 1) * p.warmup_steps**-1.5, torch.rsqrt(x + 1))


class ExponentialDecay(BaseSchedule):
  """0.5 ** ((step - start_step) / half_life_steps), floored at min."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("start_step", 0, "Decay start.")
    p.Define("half_life_steps", 1000, "Steps per halving.")
    p.Define("min", 0.0, "Floor.")
    return p

  def Value(self, step):
    p = self.p
    x = torch.clamp(_F32(step) - p.start_step, min=0.0)
    return torch.clamp(
        torch.pow(_F32(0.5), x * jit_arith.Reciprocal(p.half_life_steps)),
        min=p.min)


class DevBasedSchedule(BaseSchedule):
  """Anneal on plateau: the factor decays by `decay` (to min_factor)
  whenever the dev metric has not improved by `tolerance` for more than
  `window` steps since the best or the last decay.

  The history is the port's metric history file; `UpdateFromHistory`
  replays the reference's algorithm over all of it, so a restarted job
  recovers the same factor from the same file."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("history_path", "",
             "MetricHistory jsonl path (set by the trainer wiring).")
    p.Define("tolerance", 0.0, "Minimum significant metric improvement.")
    p.Define("window", 10000, "Steps since best/last decay before decaying.")
    p.Define("decay", 0.5, "Multiplier decay factor.")
    p.Define("min_factor", 0.01, "Multiplier floor.")
    p.Define("minimize", True, "Lower metric is better.")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    self._cur_factor = 1.0

  def UpdateFromHistory(self) -> bool:
    """Replays the decays over the history; True if the factor changed."""
    p = self.p
    if not p.history_path:
      return False
    history = early_stop.ReadHistory(p.history_path)
    if not history:
      return False
    factor, ref_step = 1.0, 0
    best_step, best_val = 0, None
    for step, val in history:
      better = (best_val is None or
                (val < best_val - p.tolerance if p.minimize else
                 val > best_val + p.tolerance))
      if better:
        best_val, best_step = val, step
      ref_step = max(ref_step, best_step)
      if step - ref_step > p.window:
        factor = max(factor * p.decay, p.min_factor)
        ref_step = step
    changed = factor != self._cur_factor
    self._cur_factor = factor
    return changed

  def Value(self, step):
    del step
    return _F32(self._cur_factor)
