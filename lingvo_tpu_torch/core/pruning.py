"""Magnitude pruning (port of lingvo_tpu/core/pruning.py).

`PruningSchedule` is the reference's polynomial sparsity ramp; the
executor (`runners/executor.py` `_MaybePrune`) recomputes the masks when a
`frequency` boundary was crossed since their last update and re-applies
them to theta and `ema_theta` at every program-run boundary. Masks are
not checkpointed: after a restart they are recomputed at the first
boundary.

`ComputeMasks(theta, schedule, step)` takes theta as the reference's
flattened tree, {path: tensor or StackedLeaf}. A matched leaf of rank 2 or
more is one tensor for the threshold, a repeat stack's StackedLeaf with
all its layers: the threshold is the k-th smallest |w| of the whole
tensor (k = int(sparsity * size); `torch.kthvalue`, the reference's
`jnp.sort`), and the mask keeps |w| > threshold strictly, so ties at the
threshold are pruned. A mask is a float tensor of the leaf's dtype, a
StackedLeaf's stacked on its leading axis.
"""

from __future__ import annotations

import re

import torch

from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import hyperparams
from lingvo_tpu_torch.core import optimizer


class PruningSchedule:
  """Polynomial sparsity ramp (ref pruning schedule): 0 -> final_sparsity
  over [begin_step, end_step], updated every `frequency` steps."""

  @classmethod
  def Params(cls):
    p = hyperparams.InstantiableParams(cls)
    p.Define("name", "pruning", "Name.")
    p.Define("weight_regex", r".*\.w", "Which theta paths are pruned.")
    p.Define("final_sparsity", 0.9, "Target fraction of zeros.")
    p.Define("begin_step", 0, "Ramp start.")
    p.Define("end_step", 10000, "Ramp end.")
    p.Define("frequency", 100, "Mask update cadence (steps).")
    p.Define("power", 3.0, "Polynomial decay power (ref: cubic).")
    return p

  def __init__(self, params):
    self.p = params.Copy()

  def SparsityAt(self, step: int) -> float:
    p = self.p
    if step <= p.begin_step:
      return 0.0
    frac = min((step - p.begin_step) / max(p.end_step - p.begin_step, 1),
               1.0)
    return p.final_sparsity * (1.0 - (1.0 - frac) ** p.power)

  def ShouldUpdate(self, step: int, last_update_step: int = -1) -> bool:
    """True when a frequency boundary was crossed since the last update:
    the executor sees steps only at program-run boundaries."""
    p = self.p
    if step < p.begin_step:
      return False
    f = max(p.frequency, 1)
    return step // f > last_update_step // f

  def Matches(self, path: str) -> bool:
    return re.fullmatch(self.p.weight_regex, path) is not None


@torch.no_grad()
def ComputeMasks(theta: dict, schedule: PruningSchedule, step: int) -> dict:
  """{path: 0/1 mask} at the scheduled sparsity for each matched leaf of
  rank >= 2: the smallest |w| fraction of it is zeroed. The reference
  gives every other leaf a mask of ones; the port leaves them out, and
  `ApplyMasks` leaves them as they are."""
  sparsity = schedule.SparsityAt(step)
  masks = {}
  for path, leaf in theta.items():
    members = optimizer.Members(leaf)
    stacked = isinstance(leaf, base_layer.StackedLeaf)
    if not schedule.Matches(path) or len(leaf.shape) < 2:
      continue   # the reference's mask of ones
    k = int(sparsity * sum(m.numel() for m in members))
    if k <= 0:
      parts = [torch.ones_like(m) for m in members]
    else:
      mags = [torch.abs(m) for m in members]
      flat = torch.cat([a.reshape(-1) for a in mags])
      threshold = torch.kthvalue(flat, k).values
      parts = [(a > threshold).to(m.dtype) for a, m in zip(mags, members)]
    masks[path] = torch.stack(parts) if stacked else parts[0]
  return masks


@torch.no_grad()
def ApplyMasks(theta: dict, masks: dict) -> None:
  """w *= mask in place for every masked leaf of theta ({path: tensor or
  StackedLeaf}, or {path: stacked tensor} like ema_theta)."""
  for path, m in masks.items():
    leaf = theta[path]
    if isinstance(leaf, base_layer.StackedLeaf):
      for i, w in enumerate(leaf.layers):
        w.mul_(m[i])
    else:
      leaf.mul_(m)


def Sparsity(masks: dict, schedule: PruningSchedule) -> float:
  """Realized fraction of zeros over the pruned weights."""
  zeros = total = 0
  for path, m in masks.items():
    if schedule.Matches(path) and m.dim() >= 2:
      zeros += m.numel() - int(torch.count_nonzero(m))
      total += m.numel()
  return zeros / total if total else 0.0
