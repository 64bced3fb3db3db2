"""Combining gradients from multiple losses (port of lingvo_tpu/core/gradient_combiner.py).

`Combine(vmap, losses_and_gradients)` takes {loss name:
NestedMap(loss_metric=(loss, weight), grads={theta path: tensor})} and
returns one gradient dict: `LinearCombiner` a weighted sum, and
`PCGradCombiner` the deterministic PCGrad surgery of the reference
(https://arxiv.org/abs/2001.06782): each loss's gradient, flattened over
all paths in sorted order, loses its component along any other loss's
gradient it conflicts with, in loss order.
"""

from __future__ import annotations

import torch

from lingvo_tpu_torch.core import base_layer


class GradientCombiner(base_layer.BaseLayer):
  """Interface (ref `gradient_combiner.py:27`)."""

  def Combine(self, vmap, losses_and_gradients: dict) -> dict:
    raise NotImplementedError(type(self).__name__)


class LinearCombiner(GradientCombiner):
  """Weighted sum of per-loss gradients (the default TF behavior)."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("loss_weights", None,
             "Optional {loss_name: weight}; default = each loss's metric "
             "weight normalized away (plain sum).")
    return p

  def Combine(self, vmap, losses_and_gradients):
    del vmap
    weights = self.p.loss_weights or {}
    combined = None
    for name, lg in losses_and_gradients.items():
      w = weights.get(name, 1.0)
      scaled = {k: w * g for k, g in lg.grads.items()}
      combined = scaled if combined is None else {
          k: combined[k] + scaled[k] for k in combined}
    return combined


class PCGradCombiner(GradientCombiner):
  """Gradient surgery: for each ordered pair (i, j), if <g_i, g_j> < 0,
  g_i is projected onto the normal plane of g_j, over the flattened full
  gradient, in loss order."""

  def Combine(self, vmap, losses_and_gradients):
    del vmap
    names = list(losses_and_gradients.keys())
    grads = [losses_and_gradients[n].grads for n in names]
    keys = sorted(grads[0])
    flats = [torch.cat([g[k].reshape(-1).float() for k in keys])
             for g in grads]
    projected = []
    for i, gi in enumerate(flats):
      out = gi
      for j, gj in enumerate(flats):
        if i == j:
          continue
        dot = torch.sum(out * gj)
        denom = torch.sum(gj * gj) + 1e-12
        out = out - torch.clamp(dot, max=0.0) / denom * gj
      projected.append(out)
    total = sum(projected)
    out, offset = {}, 0
    for k in keys:
      ref = grads[0][k]
      out[k] = total[offset:offset + ref.numel()].reshape(ref.shape).to(
          ref.dtype)
      offset += ref.numel()
    return out
