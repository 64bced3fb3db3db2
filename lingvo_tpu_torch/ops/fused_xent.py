"""Fused blockwise LM-head + cross-entropy (port of lingvo_tpu/ops/fused_xent.py).

`FusedXent` streams the vocabulary in blocks of `block_size` with an online
logsumexp, so the [M, V] logits never exist in either direction. Per row
it keeps the running max and denominator, the label logit, the sum of
logits (label smoothing's uniform term) and the first-occurrence argmax,
and returns
  per_example_xent = lse - (1-ls) * label_logit - (ls/V) * sum_logits,
  label_log_prob = label_logit - lse, lse, argmax,
which is the dense `-sum(q * log_softmax(logits))` with
q = (1-ls) * onehot + ls/V. The tanh cap `logits_soft_max` chains through
the backward as (1 - (logit/cap)^2).

The forward statistics have two implementations of one function:

- the CUDA kernel `ops/csrc/fused_xent.cu`, for CUDA tensors;
- `_PlainStats`, the reference's `_XlaStats` loop over vocab blocks, in its
  op order (`_BlockLogits`, `_BlockStats`): the CPU path and the kernel's
  yardstick on the card.

`FusedXentStats` picks by the device of the tensors it is given, and only
by that: a CUDA tensor launches the kernel or raises. The backward is
`_PlainCoreBwd`, the reference's `_CoreBwd` block loop, on both devices:
the reference runs it in XLA outside any Pallas kernel, so its products
here are `torch.matmul`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from lingvo_tpu_torch.ops import cuda_build

NEG_INF = -1.0e30   # the reference's flash_attention.NEG_INF
_BIG_IDX = 2 ** 30


@dataclasses.dataclass(frozen=True)
class _Cfg:
  block_size: int
  vocab: int            # true vocab size V (the last block may overhang)
  vd: bool              # weight layout: True = [V, D], False = [D, V]
  soft_cap: float       # logits_soft_max tanh cap; 0 = off
  label_smoothing: float


class FusedXentOutput(NamedTuple):
  """All leading dims match class_ids; everything but argmax is f32."""
  per_example_xent: torch.Tensor   # smoothed cross-entropy
  label_log_prob: torch.Tensor     # log softmax(logits)[label] (no smoothing)
  lse: torch.Tensor                # logsumexp over the full vocab
  argmax: torch.Tensor             # int32 argmax over the full vocab


def _NumBlocks(vocab: int, block: int) -> int:
  return -(-vocab // block)


def _WeightBlock(w, start: int, end: int, cfg: _Cfg):
  return w[start:end] if cfg.vd else w[:, start:end]


def _BlockLogits(x, w_blk, b_blk, cfg: _Cfg):
  """One block of capped logits in f32: x [R, D] -> [R, bs]."""
  s = torch.matmul(x, w_blk.t() if cfg.vd else w_blk)
  s = s + b_blk
  if cfg.soft_cap > 0.0:
    s = cfg.soft_cap * torch.tanh(s / cfg.soft_cap)
  return s


def _BlockStats(s, start: int, labels, carry):
  """Online-stats update for one vocab block of capped logits s [R, bs]
  (every column in vocab: the plain loop slices the last block short
  instead of padding and masking it). carry: (m, l, sum_logits or None,
  label_logit, amax), each [R, 1]."""
  m, l, sumlog, llog, amax = carry
  m_cur = torch.amax(s, dim=-1, keepdim=True)
  m_new = torch.maximum(m, m_cur)
  # all-masked-so-far rows have m_new = NEG_INF; exp(s - m_new) would turn
  # masked entries into exp(0) = 1 (the reference's m_safe guard)
  m_safe = torch.where(m_new <= NEG_INF * 0.5, 0.0, m_new)
  p = torch.exp(s - m_safe)
  alpha = torch.exp(m - m_new)
  l_new = alpha * l + torch.sum(p, dim=-1, keepdim=True)
  if sumlog is not None:
    sumlog = sumlog + torch.sum(s, dim=-1, keepdim=True)
  iota = torch.arange(s.shape[1], dtype=torch.int64, device=s.device)[None]
  onehot = iota == (labels - start)
  llog_new = llog + torch.sum(torch.where(onehot, s, 0.0), dim=-1,
                              keepdim=True)
  # first occurrence: the smallest index attaining the block max, and a
  # strict > across blocks keeps the earlier block on ties
  idx_cur = start + torch.amin(torch.where(s >= m_cur, iota, _BIG_IDX),
                               dim=-1, keepdim=True)
  amax_new = torch.where(m_cur > m, idx_cur, amax)
  return m_new, l_new, sumlog, llog_new, amax_new


def _PlainStats(x, w, b, labels, cfg: _Cfg):
  """x [M, D], w [V, D] or [D, V], b [V], labels int32 [M] ->
  (lse, label_logit, sum_logits or None, argmax int32), each [M]."""
  rows, dev = x.shape[0], x.device
  labels2 = labels.to(torch.int64)[:, None]
  carry = (torch.full((rows, 1), NEG_INF, dtype=torch.float32, device=dev),
           torch.zeros((rows, 1), dtype=torch.float32, device=dev),
           torch.zeros((rows, 1), dtype=torch.float32, device=dev)
           if cfg.label_smoothing > 0.0 else None,
           torch.zeros((rows, 1), dtype=torch.float32, device=dev),
           torch.zeros((rows, 1), dtype=torch.int64, device=dev))
  for i in range(_NumBlocks(cfg.vocab, cfg.block_size)):
    start = i * cfg.block_size
    end = min(start + cfg.block_size, cfg.vocab)
    s = _BlockLogits(x, _WeightBlock(w, start, end, cfg), b[start:end], cfg)
    carry = _BlockStats(s, start, labels2, carry)
  m, l, sumlog, llog, amax = carry
  lse = m[:, 0] + torch.log(torch.clamp(l[:, 0], min=1e-37))
  return (lse, llog[:, 0], None if sumlog is None else sumlog[:, 0],
          amax[:, 0].to(torch.int32))


# -- the CUDA kernel -----------------------------------------------------------


_lib = None   # the loaded kernel library, with its C signature declared


def _Lib():
  global _lib
  if _lib is None:
    lib = cuda_build.Load("fused_xent")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.FusedXentStatsF32.argtypes = (
        [vp] * 8 + [ci] * 5 + [ctypes.c_float, ci, vp])
    lib.FusedXentStatsF32.restype = ci
    lib.FusedXentErrorString.argtypes = [ci]
    lib.FusedXentErrorString.restype = ctypes.c_char_p
    _lib = lib
  return _lib


def _CheckStatsArgs(x, w, b, labels, cfg: _Cfg):
  for name, t in (("x", x), ("weight", w), ("bias", b)):
    if t.dtype != torch.float32:
      raise TypeError(
          f"FusedXent takes float32 {name}, got {t.dtype}; bfloat16 heads "
          "come with the bf16-kernel slice of the port")
  d = x.shape[1]
  w_shape = (cfg.vocab, d) if cfg.vd else (d, cfg.vocab)
  if x.ndim != 2 or tuple(w.shape) != w_shape or tuple(b.shape) != (
      cfg.vocab,):
    raise ValueError(f"FusedXent shapes: x {tuple(x.shape)}, weight "
                     f"{tuple(w.shape)} (expected {w_shape}), bias "
                     f"{tuple(b.shape)}")
  if labels.dtype != torch.int32 or tuple(labels.shape) != (x.shape[0],):
    raise ValueError(f"labels must be int32 [{x.shape[0]}], got "
                     f"{labels.dtype} {tuple(labels.shape)}")
  for t in (w, b, labels):
    if t.device != x.device:
      raise ValueError(f"tensor on {t.device}, x on {x.device}")


def FusedXentStats(x, w, b, labels, cfg: _Cfg):
  """(lse, label_logit, sum_logits or None, argmax int32), each [M].

  CPU tensors run `_PlainStats`; CUDA tensors launch the kernel (one
  launch counted in `FusedXentStats.launches`) or raise."""
  _CheckStatsArgs(x, w, b, labels, cfg)
  if x.device.type == "cpu":
    return _PlainStats(x, w, b, labels, cfg)
  if x.device.type != "cuda":
    raise ValueError(f"FusedXent runs on cpu or cuda, not {x.device}")
  if not all(t.is_contiguous() for t in (x, w, b, labels)):
    raise ValueError("FusedXent kernel takes contiguous tensors")
  rows, d = x.shape
  lse, llog, sumlog = (torch.empty((rows,), dtype=torch.float32,
                                   device=x.device) for _ in range(3))
  amax = torch.empty((rows,), dtype=torch.int32, device=x.device)
  need_sum = cfg.label_smoothing > 0.0
  if rows:
    lib = _Lib()
    rc = lib.FusedXentStatsF32(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
        lse.data_ptr(), llog.data_ptr(), sumlog.data_ptr(), amax.data_ptr(),
        rows, d, cfg.vocab, cfg.block_size, int(cfg.vd), cfg.soft_cap,
        int(need_sum), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
      raise RuntimeError("FusedXent kernel launch failed: "
                         + lib.FusedXentErrorString(rc).decode())
    FusedXentStats.launches += 1
  return lse, llog, sumlog if need_sum else None, amax


FusedXentStats.launches = 0   # kernel launches (the plain version counts none)


# -- backward and autograd -----------------------------------------------------


def _Finish(lse, llog, sumlog, cfg: _Cfg):
  ls = cfg.label_smoothing
  if ls > 0.0:
    return lse - (1.0 - ls) * llog - (ls / cfg.vocab) * sumlog
  return lse - llog


def _PlainCoreBwd(x, w, b, labels, lse, g_xent, g_llp, g_lse, cfg: _Cfg):
  """The reference `_CoreBwd` block loop: (dx, dw, db) from the cotangents
  of (per_example_xent, label_log_prob, lse), with each block's logits
  and softmax recomputed from the saved lse; never more than one [M, bs]
  tile at a time."""
  ls = cfg.label_smoothing
  labels2 = labels.to(torch.int64)[:, None]
  lse2 = lse[:, None]
  g1, g2, g3 = (g.float()[:, None] for g in (g_xent, g_llp, g_lse))
  # xent = lse - (1-ls)*llog - ls/V*sumlog; llp = llog - lse.
  coef_p = g1 - g2 + g3              # softmax term
  coef_oh = g2 - (1.0 - ls) * g1     # onehot term
  coef_ones = -(ls / cfg.vocab) * g1 if ls > 0.0 else None
  dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
  dw = torch.empty_like(w)
  db = torch.empty_like(b)
  for i in range(_NumBlocks(cfg.vocab, cfg.block_size)):
    start = i * cfg.block_size
    end = min(start + cfg.block_size, cfg.vocab)
    w_blk = _WeightBlock(w, start, end, cfg)
    s = _BlockLogits(x, w_blk, b[start:end], cfg)
    p = torch.exp(s - lse2)
    iota = torch.arange(end - start, dtype=torch.int64, device=x.device)[None]
    onehot = (iota == (labels2 - start)).float()
    dz = coef_p * p + coef_oh * onehot
    if coef_ones is not None:
      dz = dz + coef_ones
    if cfg.soft_cap > 0.0:
      dz = dz * (1.0 - (s / cfg.soft_cap) ** 2)
    if cfg.vd:
      dx = dx + torch.matmul(dz, w_blk)
    else:
      dx = dx + torch.matmul(dz, w_blk.t())
    dw_blk = torch.matmul(dz.t(), x)                       # [bs, D]
    if cfg.vd:
      dw[start:end] = dw_blk
    else:
      dw[:, start:end] = dw_blk.t()
    db[start:end] = torch.sum(dz, dim=0)
  return dx.to(x.dtype), dw, db


class _FusedXentFunction(torch.autograd.Function):
  """Stats forward (kernel or plain by device), plain block-loop backward."""

  @staticmethod
  def forward(ctx, x, w, b, labels, cfg):
    lse, llog, sumlog, amax = FusedXentStats(x, w, b, labels, cfg)
    ctx.save_for_backward(x, w, b, labels, lse)
    ctx.cfg = cfg
    ctx.mark_non_differentiable(amax)
    return _Finish(lse, llog, sumlog, cfg), llog - lse, lse, amax

  @staticmethod
  def backward(ctx, g_xent, g_llp, g_lse, g_amax):
    del g_amax   # integer: no tangent
    x, w, b, labels, lse = ctx.saved_tensors
    dx, dw, db = _PlainCoreBwd(x, w, b, labels, lse, g_xent, g_llp, g_lse,
                               ctx.cfg)
    return dx, dw, db, None, None


# -- public entry --------------------------------------------------------------


def FusedXent(inputs, weight, class_ids, *, block_size: int, bias=None,
              logits_soft_max: float = 0.0, label_smoothing: float = 0.0,
              weight_layout: str = "vd") -> FusedXentOutput:
  """Blockwise fused LM-head + softmax cross-entropy.

  inputs: [..., D] float32 activations. weight: [V, D] (weight_layout
  'vd', the tied-embedding layout) or [D, V] ('dv'). class_ids: int
  [...] in [0, V). bias: optional [V]. logits_soft_max: tanh cap (0 =
  off). Gradients flow to inputs, weight and bias through
  per_example_xent, label_log_prob and lse; argmax is int32.

  The forward statistics run the CUDA kernel for CUDA tensors and the
  plain block loop for CPU tensors; the backward is the plain block loop
  on both."""
  if weight_layout not in ("vd", "dv"):
    raise ValueError(f"weight_layout {weight_layout!r} is not 'vd' or 'dv'")
  if block_size <= 0:
    raise ValueError(f"block_size must be > 0, got {block_size}")
  vd = weight_layout == "vd"
  vocab = weight.shape[0] if vd else weight.shape[1]
  d = weight.shape[1] if vd else weight.shape[0]
  lead = tuple(class_ids.shape)
  if tuple(inputs.shape) != lead + (d,):
    raise ValueError(f"inputs {tuple(inputs.shape)} do not match class_ids "
                     f"{lead} and weight {tuple(weight.shape)}")
  x = inputs.reshape(-1, d)
  labels = class_ids.reshape(-1).to(torch.int32)
  b = bias if bias is not None else torch.zeros(
      (vocab,), dtype=weight.dtype, device=weight.device)
  cfg = _Cfg(block_size=int(min(block_size, vocab)), vocab=int(vocab), vd=vd,
             soft_cap=float(logits_soft_max),
             label_smoothing=float(label_smoothing))
  xent, llp, lse, amax = _FusedXentFunction.apply(x, weight, b, labels, cfg)
  return FusedXentOutput(
      per_example_xent=xent.reshape(lead), label_log_prob=llp.reshape(lead),
      lse=lse.reshape(lead), argmax=amax.reshape(lead))
