"""Gradient Sign Dropout (GradDrop) for multi-task shared representations (port of lingvo_tpu/core/graddrop.py).

`GradDropSplit(x, key, n, cfg)` hands each of n downstream tasks its own
copy of the shared tensor x; the backward receives one gradient per task
and passes the trunk a single one, combined with sign dropout (the
NeurIPS-2020 GradDrop algorithm). It is a `torch.autograd.Function`; the
reference's `jax.random.uniform(key, ...)` draw is `threefry.Uniform01`,
bit for bit, with `key` a threefry key (a CPU int64 [2] tensor).

Usage::

  xs = graddrop.GradDropSplit(shared, step_key, len(task_heads), cfg)
  losses = [head_i(xs[i]) for i ...]   # per-task heads / losses
  sum(losses).backward()

Head weights get ordinary gradients; only d(total)/d(shared) changes. A
copy no loss reads contributes a zero gradient, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from lingvo_tpu_torch.core import threefry


@dataclasses.dataclass(frozen=True)
class GradDropConfig:
  """Static GradDrop knobs (ref `graddrop.py` Params)."""

  keep_prob_function: str = "linear"    # 'linear' | 'sigmoid'
  keep_prob_function_scale: float = 1.0
  use_input_sign_only: bool = True
  keep_gradnorm_constant: bool = True
  marginalize_batch_dim: bool = True
  epsilon: float = 1e-7
  leak_ratios: tuple = ()               # per-task; () = all zeros


def _Combine(x, key, cfg: GradDropConfig, gs):
  """The sign-dropped combination of the per-task gradients gs of x."""
  n = len(gs)
  eps = cfg.epsilon
  per_loss_grads = [g.float() for g in gs]
  # the signal of the sign decisions: grad * input (or the input's sign)
  x32 = x.float()
  if cfg.use_input_sign_only:
    x_abs = torch.abs((torch.abs(x32) <= eps).float() + x32)
    signal = [g * (x32 / x_abs) for g in per_loss_grads]
  else:
    signal = [g * x32 for g in per_loss_grads]
  if cfg.marginalize_batch_dim:
    signal = [torch.sum(s, dim=0, keepdim=True) for s in signal]
  sign_pos = [(s > 0.0).float() for s in signal]
  sign_neg = [(s < 0.0).float() for s in signal]
  # purity (eq. 1 of the paper): the probability of keeping positive signs
  abs_sum = sum(torch.abs(s) for s in signal)
  prob_pos = sum(signal) / (2.0 * abs_sum + eps)
  prob_pos = prob_pos * cfg.keep_prob_function_scale
  if cfg.keep_prob_function == "sigmoid":
    # sigmoid'(0) = 0.25, so 4x matches the linear slope at 0
    prob_pos = torch.sigmoid(4.0 * prob_pos)
  elif cfg.keep_prob_function == "linear":
    prob_pos = prob_pos + 0.5
  else:
    raise ValueError(cfg.keep_prob_function)
  u = threefry.Uniform01(key, tuple(prob_pos.shape), device=x.device)
  choose_pos = (prob_pos >= u).float() - 0.5   # +-0.5
  masks = [((sp - sn) * choose_pos >= 0).float()
           for sp, sn in zip(sign_pos, sign_neg)]
  leaks = cfg.leak_ratios or (0.0,) * n
  if len(leaks) != n:
    raise ValueError(f"leak_ratios has {len(leaks)} entries for {n} tasks")
  transformed = [g * (leak + (1.0 - leak) * mask)
                 for leak, g, mask in zip(leaks, per_loss_grads, masks)]
  combined = sum(transformed)
  if cfg.keep_gradnorm_constant:
    original = sum(per_loss_grads)
    combined = combined * (torch.linalg.norm(original) /
                           (torch.linalg.norm(combined) + eps))
  return combined.to(x.dtype)


class _GradDropSplit(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, key, n, cfg):
    ctx.save_for_backward(x)
    ctx.key, ctx.cfg = key, cfg
    return tuple(x.view_as(x) for _ in range(n))

  @staticmethod
  def backward(ctx, *gs):
    (x,) = ctx.saved_tensors
    gs = [torch.zeros_like(x) if g is None else g for g in gs]
    return _Combine(x, ctx.key, ctx.cfg, gs), None, None, None


def GradDropSplit(x, key, n: int, cfg: GradDropConfig) -> tuple:
  """n copies of x whose combined backward gradient is sign-dropped."""
  return _GradDropSplit.apply(x, key, n, cfg)
