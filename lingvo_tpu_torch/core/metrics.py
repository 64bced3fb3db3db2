"""Weighted metric accumulation (port of part of lingvo_tpu/core/metrics.py).

A task's metrics are (value, weight) pairs. `AccumulateMetrics` folds one
step's pairs into [weighted_value_sum, weight_sum] float32 tensors on the
metrics' device, without a host sync; `FinalizeMetrics` reads them once
and returns {name: weighted mean}.
"""

from __future__ import annotations

import torch

from lingvo_tpu_torch.core.nested_map import NestedMap


def AccumulateMetrics(acc: NestedMap | None, metrics: NestedMap) -> NestedMap:
  """acc + one step's (value, weight) metrics, as [2] float32 tensors."""
  out = NestedMap()
  for k in metrics.keys():
    v, w = (torch.as_tensor(x, dtype=torch.float32) for x in metrics[k])
    w = w.to(v.device)
    pair = torch.stack([v * w, w])
    out[k] = pair if acc is None else acc[k] + pair
  return out


def FinalizeMetrics(acc: NestedMap) -> dict[str, float]:
  """{name: weighted mean} floats (one host read per metric)."""
  out = {}
  for k in sorted(acc.keys()):
    total, weight = acc[k].tolist()
    out[k] = total / max(weight, 1e-8)
  return out
