"""Learner: the per-loss optimization pipeline (port of lingvo_tpu/core/learner.py).

Takes the trainable parameters and their gradients (from `loss.backward()`)
and applies, as the reference does: the optional gradient aggregation
hook, the global gradient norm, the skip of a step whose norm is not
finite (`skip_nan_gradients`) or above `grad_norm_to_clip_to_zero`, the
optional global-norm clip, the optional per-tensor clip, the
learning-rate schedule, and the optimizer update (Adam by default, as in
the reference), with every parameter and slot rolled back on a skipped
step. `RegularizationLoss` is the L1/L2 term the train step adds to the
loss. Unlike the reference, `Apply` updates the parameters and the
optimizer state IN PLACE and returns only the stats. Every decision stays
on the device, and the step's scalars reach it through pinned memory
without blocking (`py_utils.ToDevice`): no step syncs the host.

Parameters and gradients are dicts {theta path: tensor or StackedLeaf},
the paths as the reference flattens theta (`stack.body.fflayer.ffn_in.w`),
a repeat stack's leaf being the StackedLeaf of its per-layer tensors (one
leaf of the reference: the per-tensor clip takes its norm over all its
layers).
"""

from __future__ import annotations

import re

import torch

from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import optimizer as optimizer_lib
from lingvo_tpu_torch.core import py_utils
from lingvo_tpu_torch.core import schedule as schedule_lib
from lingvo_tpu_torch.core.nested_map import NestedMap


def _Tensors(leaves: dict) -> list:
  return [t for leaf in leaves.values() for t in optimizer_lib.Members(leaf)]


class Learner(base_layer.BaseLayer):

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("learning_rate", 1e-3, "Base learning rate.")
    p.Define("lr_schedule", schedule_lib.Constant.Params(),
             "Multiplier schedule on learning_rate.")
    p.Define("optimizer", optimizer_lib.Adam.Params(), "Optimizer template.")
    p.Define("loss_name", "loss",
             "Which entry of the task's metrics dict to optimize.")
    p.Define("clip_gradient_norm_to_value", 0.0,
             "If >0, clip global grad norm to this.")
    p.Define("clip_gradient_single_norm_to_value", 0.0,
             "If >0, clip each tensor's norm to this.")
    p.Define("grad_norm_to_clip_to_zero", 0.0,
             "If >0 and global norm exceeds this, skip the step (outlier "
             "batch rejection).")
    p.Define("skip_nan_gradients", True,
             "Skip updates whose global grad norm is NaN/Inf.")
    p.Define("l2_regularizer_weight", None, "Optional L2 on trainable theta.")
    p.Define("l1_regularizer_weight", None, "Optional L1 on trainable theta.")
    p.Define("grad_aggregation_fn", None,
             "Optional fn(grads) -> grads before the norm and the clips, on "
             "the {path: tensor or StackedLeaf} dict.")
    p.Define("bprop_variable_filter", None,
             "Regex: only vars whose path matches are trained.")
    p.Define("bprop_variable_exclusion", None,
             "Regex: vars whose path matches are NOT trained.")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    self.CreateChild("lr_sched", self.p.lr_schedule)
    self.CreateChild("opt", self.p.optimizer)

  def TrainableFilter(self, path: str) -> bool:
    """Whether the variable at `path` is trained by this learner."""
    p = self.p
    if p.bprop_variable_filter and not re.search(p.bprop_variable_filter,
                                                 path):
      return False
    if p.bprop_variable_exclusion and re.search(p.bprop_variable_exclusion,
                                                path):
      return False
    return True

  def RegularizationLoss(self, params: dict) -> torch.Tensor:
    """0.5 * l2 * sum(w^2) + l1 * sum(|w|) over the trainable parameters,
    in float32 (a 0-d tensor on their device; 0 with neither weight)."""
    p = self.p
    tensors = _Tensors(params)
    loss = torch.zeros((), dtype=torch.float32,
                       device=tensors[0].device if tensors else None)
    if p.l2_regularizer_weight:
      loss = loss + 0.5 * p.l2_regularizer_weight * sum(
          torch.sum(torch.square(w.float())) for w in tensors)
    if p.l1_regularizer_weight:
      loss = loss + p.l1_regularizer_weight * sum(
          torch.sum(torch.abs(w.float())) for w in tensors)
    return loss

  def InitState(self, params: dict) -> NestedMap:
    return self.opt.InitState(params)

  def LearningRate(self, step) -> torch.Tensor:
    """0-d float32 CPU tensor: learning_rate * schedule(step)."""
    return self.p.learning_rate * self.lr_sched.Value(step)

  @torch.no_grad()
  def Apply(self, params: dict, grads: dict, step,
            opt_state: NestedMap) -> NestedMap:
    """Updates params and opt_state in place; returns the stats
    (grad_norm, learning_rate, grad_scale, skipped_step), 0-d tensors on
    the parameters' device. The gradients are scaled in place."""
    p = self.p
    if p.grad_aggregation_fn is not None:
      grads = p.grad_aggregation_fn(grads)
    tensors = _Tensors(grads)
    dev = tensors[0].device
    grad_norm = py_utils.GlobalNorm(tensors)
    stats = NestedMap(grad_norm=grad_norm)
    # global scale: 0 when the norm is not finite (skip_nan_gradients) or
    # above grad_norm_to_clip_to_zero, else the optional global-norm clip.
    # A NaN norm is sanitized before any arithmetic: 0 * NaN = NaN would
    # defeat the skip.
    finite = torch.isfinite(grad_norm)
    safe_norm = torch.where(finite, grad_norm, 1.0)
    keep = finite if p.skip_nan_gradients else torch.ones_like(finite)
    if p.grad_norm_to_clip_to_zero > 0:
      keep = keep & (safe_norm <= p.grad_norm_to_clip_to_zero)
    grad_scale = keep.float()
    if p.clip_gradient_norm_to_value > 0:
      clip = torch.clamp(p.clip_gradient_norm_to_value /
                         torch.clamp(safe_norm, min=1e-30), max=1.0)
      grad_scale = grad_scale * clip
    # zero (not NaN-scale) grads on skipped steps so the slots stay finite;
    # parameters and slots are rolled back as well
    for g in tensors:
      g.copy_(torch.where(keep, g * grad_scale, torch.zeros_like(g)))
    if p.clip_gradient_single_norm_to_value > 0:
      for leaf in grads.values():
        members = optimizer_lib.Members(leaf)
        n = torch.sqrt(sum(torch.sum(torch.square(g)) for g in members)
                       + 1e-30)
        scale = torch.clamp(p.clip_gradient_single_norm_to_value / n,
                            max=1.0)
        for g in members:
          g.mul_(scale)
    lr = self.LearningRate(step)
    stats.learning_rate = py_utils.ToDevice(lr, dev)
    stats.grad_scale = grad_scale
    skipped = grad_scale == 0.0
    stats.skipped_step = skipped.float()
    self.opt.Update(opt_state, grads, params, lr, step, skipped=skipped)
    return stats
