"""Learning-rate schedules (port of part of lingvo_tpu/core/schedule.py).

Each schedule is a Params-configured layer whose `Value(step)` is a 0-d
float32 CPU tensor, computed in float32 with the reference's op order, so
the learner's rate is bit-equal to the reference's for the same step.
Only `Constant` and `LinearRampupCosineDecay` (the DenseLm recipe) are
ported.
"""

from __future__ import annotations

import math

import torch

from lingvo_tpu_torch.core import base_layer


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
