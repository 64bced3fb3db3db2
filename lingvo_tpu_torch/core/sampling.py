"""Token sampling for the serving step (port of lingvo_tpu/core/sampling.py).

Greedy only: `temperature <= 0` is the argmax of the (tanh-capped)
logits, the first maximal index on ties in both frameworks. Sampling at
temperature > 0 needs the reference's per-request threefry streams
(fold_in(key, seed), fold_in(position)) and comes with a later slice.
"""

from __future__ import annotations

import torch


def SampleFromLogits(logits, temperature: float = 0.0):
  """[..., V] float logits -> [...] int32 token ids (greedy)."""
  if temperature > 0.0:
    raise NotImplementedError(
        "temperature > 0 sampling needs the per-request random streams, "
        "which come with a later serving slice")
  return torch.argmax(logits, dim=-1).to(torch.int32)
