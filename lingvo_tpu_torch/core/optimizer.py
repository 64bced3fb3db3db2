"""Optimizers as in-place update rules (port of part of lingvo_tpu/core/optimizer.py).

The reference's optimizers are pure functions `(state, grads, params, lr,
step) -> (new_params, new_state)` over theta pytrees. Here `Update`
writes the new parameters and slots IN PLACE, under `torch.no_grad()`,
one leaf group at a time, so no second copy of theta or of the slots is
ever held. A leaf is a tensor or a `base_layer.StackedLeaf`: the per-layer
parameters of a repeat stack, which the reference keeps stacked on a
leading axis. Every rule is applied to the stacked leaf as the reference
applies it (the factoring decision on the stacked shape, the update RMS
over all layers), while the parameters stay per layer; the slots of a
stacked leaf are stacked, as the reference's are.

`Update(..., skipped=...)` takes the learner's 0-d skip flag and keeps the
old value of every parameter and slot where it is set (the reference's
rollback by `jnp.where`), still without a host sync.

Only `Adafactor` (the DenseLm recipe) is ported; the reference's SGD,
Momentum, RMSProp, Adagrad, Adam, AdamW and Accumulator come with a later
slice.
"""

from __future__ import annotations

import torch

from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core.nested_map import NestedMap


def Members(leaf) -> tuple:
  """The per-layer tensors of a leaf: itself, or a StackedLeaf's layers."""
  if isinstance(leaf, base_layer.StackedLeaf):
    return leaf.layers
  return (leaf,)


def _Write(dst: torch.Tensor, new: torch.Tensor, skipped) -> None:
  if skipped is None:
    dst.copy_(new)
  else:
    dst.copy_(torch.where(skipped, dst, new))


class BaseOptimizer(base_layer.BaseLayer):
  """InitState(params) -> state; Update(...) writes params and state."""

  def InitState(self, params: dict) -> NestedMap:
    del params
    return NestedMap()

  def Update(self, state: NestedMap, grads: dict, params: dict, lr, step,
             skipped=None) -> None:
    """params/grads: {path: tensor or StackedLeaf}, the same keys and
    shapes; lr a 0-d float32 tensor; skipped None or a 0-d bool tensor on
    the parameters' device. Updates params and state in place."""
    raise NotImplementedError


class Adafactor(BaseOptimizer):
  """Adafactor with factored second moments (reference `Adafactor`).

  Factored second moments for rank>=2 weights (row accumulator over the
  last dim, col accumulator over the second-to-last) when both factored
  dims are at least min_dim_size_to_factor, update RMS clipping, the
  pow-decay schedule and an optional first moment."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("beta1", 0.0, "If >0 keep a first moment (uses more memory).")
    p.Define("decay_adam", 0.99, "Second-moment decay asymptote.")
    p.Define("decay_pow", 0.8, "decay = 1 - (step+1)^-decay_pow if >0.")
    p.Define("epsilon1", 1e-30, "Grad^2 regularizer.")
    p.Define("epsilon2", 1e-3, "RMS-of-param floor for update scale.")
    p.Define("multiply_by_parameter_scale", True,
             "Scale updates by RMS(param) (Adafactor's LR-free mode).")
    p.Define("clipping_threshold", 1.0, "Update RMS clip.")
    p.Define("factored", True, "Use factored second moments for rank>=2.")
    p.Define("min_dim_size_to_factor", 128,
             "Only factor when both factored dims are at least this size.")
    return p

  def _ShouldFactor(self, shape) -> bool:
    p = self.p
    return (p.factored and len(shape) >= 2 and
            shape[-1] >= p.min_dim_size_to_factor and
            shape[-2] >= p.min_dim_size_to_factor)

  def InitState(self, params):
    p = self.p

    def _Slot(leaf):
      shape = tuple(leaf.shape)   # a StackedLeaf's with its layer axis
      dev = Members(leaf)[0].device
      z = lambda s: torch.zeros(s, dtype=torch.float32, device=dev)
      slot = NestedMap()
      if self._ShouldFactor(shape):
        slot.vr = z(shape[:-1])
        slot.vc = z(shape[:-2] + shape[-1:])
      else:
        slot.v = z(shape)
      if p.beta1 > 0:
        slot.m = z(shape)
      return slot

    return NestedMap(slots={k: _Slot(v) for k, v in params.items()})

  def _Decay(self, step) -> torch.Tensor:
    p = self.p
    t = torch.tensor(step, dtype=torch.float32) + 1.0
    if p.decay_pow > 0:
      decay = 1.0 - t ** (-p.decay_pow)
    else:
      decay = torch.tensor(p.decay_adam, dtype=torch.float32)
    return torch.minimum(decay, torch.tensor(p.decay_adam,
                                             dtype=torch.float32))

  @torch.no_grad()
  def Update(self, state, grads, params, lr, step, skipped=None):
    decay = self._Decay(step)
    for key, leaf in params.items():
      self._UpdateLeaf(leaf, grads[key], state.slots[key], lr, decay,
                       skipped)

  def _UpdateLeaf(self, leaf, grad, slot, lr, decay, skipped):
    """One reference leaf: the update RMS and the parameter RMS are taken
    over all its layers, as over the reference's stacked tensor."""
    p = self.p
    ws, gs = Members(leaf), Members(grad)
    stacked = isinstance(leaf, base_layer.StackedLeaf)
    factored = self._ShouldFactor(tuple(leaf.shape))
    dev = ws[0].device
    decay = decay.to(dev)
    lr = lr.to(dev)

    def _Slot(name, i):
      return slot[name][i] if stacked else slot[name]

    us, new_slots = [], []
    for i, (w, g) in enumerate(zip(ws, gs)):
      g32 = g.float()
      gsq = torch.square(g32) + p.epsilon1
      new = {}
      if factored:
        vr = decay * _Slot("vr", i) + (1 - decay) * torch.mean(gsq, dim=-1)
        vc = decay * _Slot("vc", i) + (1 - decay) * torch.mean(gsq, dim=-2)
        new["vr"], new["vc"] = vr, vc
        # u = g / sqrt(vhat); vhat = vr * vc / mean_row(vr)
        row_mean = torch.mean(vr, dim=-1, keepdim=True)
        r = torch.rsqrt(vr / row_mean)[..., None]
        c = torch.rsqrt(vc)[..., None, :]
        u = g32 * r * c
      else:
        v = decay * _Slot("v", i) + (1 - decay) * gsq
        new["v"] = v
        u = g32 * torch.rsqrt(v)
      us.append(u)
      new_slots.append(new)
    numel = sum(u.numel() for u in us)
    if p.clipping_threshold > 0:
      u_rms = torch.sqrt(sum(torch.sum(torch.square(u)) for u in us) / numel
                         + 1e-30)
      clip = torch.clamp(u_rms / p.clipping_threshold, min=1.0)
      us = [u / clip for u in us]
    scale = lr
    if p.multiply_by_parameter_scale:
      param_rms = torch.sqrt(
          sum(torch.sum(torch.square(w.float())) for w in ws) / numel)
      scale = lr * torch.clamp(param_rms, min=p.epsilon2)
    for i, (w, u, new) in enumerate(zip(ws, us, new_slots)):
      if p.beta1 > 0:
        m = p.beta1 * _Slot("m", i) + (1 - p.beta1) * u
        new["m"] = m
        u = m
      for name, value in new.items():
        _Write(_Slot(name, i), value, skipped)
      _Write(w, w - (scale * u).to(w.dtype), skipped)
