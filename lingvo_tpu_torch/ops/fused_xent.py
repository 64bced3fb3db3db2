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

- the CUDA kernels `ops/csrc/fused_xent.cu`, for CUDA tensors (both
  dtypes split the vocabulary into runs of 128-column tiles, the grid from
  `StatsGeometry` at each kernel's occupancy, merged in order by a second
  kernel; float32 on the CUDA cores, bfloat16 by wgmma fed by TMA);
- `_PlainStats`, the reference's `_XlaStats` loop over vocab blocks, in its
  op order (`_BlockLogits`, `_BlockStats`): the CPU path and the kernel's
  yardstick on the card.

`FusedXentStats` picks by the device of the tensors it is given, and only
by that: a CUDA tensor launches the kernel of its dtype or raises. The
backward is `_PlainCoreBwd`, the reference's `_CoreBwd` block loop, on
both devices: the reference runs it in XLA outside any Pallas kernel, so
its products here are library GEMMs.

bfloat16 inputs (the table cast to the fprop dtype) keep bf16 operands
with float32 sums, as the reference's `_DotF32`: every statistic is
float32 and nothing in the forward rounds. The backward rounds dz to
bf16 before its two products (the reference's `dzc`), sums dx in
float32 and casts it to x's dtype at the end, and casts each block's
dw to the weight's dtype. Its bf16 x bf16 -> float32 products go to
`MatmulF32`: on the card a cuBLAS bf16 GEMM with float32 output
(`torch.mm(..., out_dtype=torch.float32)`), on the CPU the operands
widened to float32, where every product is exact.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
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


def MatmulF32(a, b):
  """a [M, K] @ b [K, N] with float32 sums and a float32 result: for bf16
  operands a cuBLAS bf16 GEMM with float32 output on the card, the
  operands widened to float32 (exact products) on the CPU; float32
  operands multiply as they are."""
  if a.dtype == torch.float32 and b.dtype == torch.float32:
    return torch.matmul(a, b)
  if a.device.type == "cuda":
    return torch.mm(a, b, out_dtype=torch.float32)
  return torch.matmul(a.float(), b.float())


def _BlockLogits(x, w_blk, b_blk, cfg: _Cfg):
  """One block of capped logits in f32: x [R, D] -> [R, bs]."""
  s = MatmulF32(x, w_blk.t() if cfg.vd else w_blk)
  s = s + b_blk.float()
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

# the kernels' tile (rows and vocab columns a block computes at once), D
# per copy stage and stages in their rings: csrc/fused_xent.cu's kTile,
# kDepth and kStages (float32; the launch refuses other values) and kXRows
# = kXCols, kXDepth and kXStages (bfloat16)
STATS_TILE, STATS_DEPTH, STATS_STAGES = 128, 32, 2
BF16_STATS_DEPTH, BF16_STATS_STAGES = 64, 4
_MIN_TILES_PER_SPLIT = 4   # vocab tiles a split takes at least (if it can)


@functools.lru_cache(maxsize=None)
def StatsGeometry(rows: int, vocab: int, sms: int = 132, per_sm: int = 2):
  """A statistics kernel's grid: (row tiles, vocab splits), and the vocab
  tiles of STATS_TILE columns each split owns, in order; `per_sm` is the
  kernel's resident blocks per SM (2 for float32, 1 for bfloat16).

  Split s owns tiles [s * tiles_per_split, (s + 1) * tiles_per_split) of
  the ceil(vocab / STATS_TILE); every split owns at least one. Of the
  split sizes of at least _MIN_TILES_PER_SPLIT tiles, the one whose grid
  finishes in the fewest tile times on `sms` SMs holding `per_sm` blocks
  each, when the grid fills them at least twice over (the smallest such
  size on a tie: more, shorter blocks even out the last wave); a grid
  that cannot fill them twice takes the smallest size."""
  row_tiles = -(-rows // STATS_TILE)
  col_tiles = -(-vocab // STATS_TILE)
  slots = sms * per_sm
  best = None
  for tps in range(min(_MIN_TILES_PER_SPLIT, col_tiles), col_tiles + 1):
    splits = -(-col_tiles // tps)
    if (splits - 1) * tps >= col_tiles:
      continue   # the last split would be empty
    blocks = row_tiles * splits
    key = (blocks < 2 * slots, -(-blocks // slots) * tps, tps)
    if best is None or key < best[0]:
      best = (key, tps, splits)
  _, tps, splits = best
  return dict(tile=STATS_TILE, depth=STATS_DEPTH, stages=STATS_STAGES,
              row_tiles=row_tiles, col_tiles=col_tiles, splits=splits,
              tiles_per_split=tps, grid=(row_tiles, splits))


def _Lib():
  global _lib
  if _lib is None:
    lib = cuda_build.Load("fused_xent")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.FusedXentStatsF32.argtypes = (
        [vp] * 9 + [ci] * 4 + [ctypes.c_float] + [ci] * 6 + [vp])
    lib.FusedXentStatsF32.restype = ci
    lib.FusedXentF32Geometry.argtypes = [vp]
    lib.FusedXentF32Geometry.restype = ci
    lib.FusedXentStatsBF16.argtypes = (
        [vp] * 9 + [ci] * 3 + [ctypes.c_float] + [ci] * 3 + [vp])
    lib.FusedXentStatsBF16.restype = ci
    lib.FusedXentBf16Geometry.argtypes = [vp]
    lib.FusedXentBf16Geometry.restype = ci
    lib.FusedXentErrorString.argtypes = [ci]
    lib.FusedXentErrorString.restype = ctypes.c_char_p
    _lib = lib
  return _lib


def KernelGeometry(dtype=torch.float32):
  """(threads, shared bytes per block, resident blocks per SM) of the
  statistics kernel of `dtype` on the current device."""
  lib = _Lib()
  geo = (ctypes.c_int * 3)()
  bf16 = dtype == torch.bfloat16
  rc = (lib.FusedXentBf16Geometry if bf16 else lib.FusedXentF32Geometry)(geo)
  if rc != 0:
    raise RuntimeError("the fused-xent kernel geometry failed: "
                       + lib.FusedXentErrorString(rc).decode())
  return tuple(geo)


@functools.lru_cache(maxsize=None)
def _Bf16PerSm(device_index: int) -> int:
  """The bfloat16 kernel's resident blocks per SM on a device (read once:
  the occupancy query costs host time on every training step)."""
  with torch.cuda.device(device_index):
    return KernelGeometry(torch.bfloat16)[2]


def _CheckStatsArgs(x, w, b, labels, cfg: _Cfg):
  if x.dtype not in (torch.float32, torch.bfloat16):
    raise TypeError(f"FusedXent takes float32 or bfloat16 x, got {x.dtype}")
  for name, t in (("weight", w), ("bias", b)):
    if t.dtype != x.dtype:
      raise TypeError(f"FusedXent: {name} is {t.dtype}, x is {x.dtype}")
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

  CPU tensors run `_PlainStats`; CUDA tensors launch the kernel of their
  dtype (one launch counted in `FusedXentStats.launches` and
  `.launches_by_dtype`) or raise."""
  _CheckStatsArgs(x, w, b, labels, cfg)
  if x.device.type == "cpu":
    return _PlainStats(x, w, b, labels, cfg)
  if x.device.type != "cuda":
    raise ValueError(f"FusedXent runs on cpu or cuda, not {x.device}")
  if not all(t.is_contiguous() for t in (x, w, b, labels)):
    raise ValueError("FusedXent kernel takes contiguous tensors")
  bf16 = x.dtype == torch.bfloat16
  if bf16 and (not cfg.vd or x.shape[1] % 8 or any(
      t.data_ptr() % 16 for t in (x, w))):
    raise ValueError(
        "the bf16 FusedXent kernel takes the [V, D] weight layout, D a "
        "multiple of 8 and 16-byte aligned x and weight")
  rows, d = x.shape
  lse, llog, sumlog = (torch.empty((rows,), dtype=torch.float32,
                                   device=x.device) for _ in range(3))
  amax = torch.empty((rows,), dtype=torch.int32, device=x.device)
  need_sum = cfg.label_smoothing > 0.0
  if rows:
    lib = _Lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), llog.data_ptr(), sumlog.data_ptr(),
            amax.data_ptr())
    # the statistics do not depend on the vocab blocks (no rounding
    # inside), so both kernels walk the vocabulary in their own tiles, in
    # splits merged in order by a second kernel: one counted launch
    props = torch.cuda.get_device_properties(x.device)
    if bf16:
      geo = StatsGeometry(rows, cfg.vocab, props.multi_processor_count,
                          _Bf16PerSm(x.device.index))
    else:
      geo = StatsGeometry(rows, cfg.vocab, props.multi_processor_count)
    part = torch.empty((5, geo["splits"], rows), dtype=torch.float32,
                       device=x.device)
    if bf16:
      rc = lib.FusedXentStatsBF16(*ptrs, part.data_ptr(), rows, d, cfg.vocab,
                                  cfg.soft_cap, int(need_sum), geo["splits"],
                                  geo["tiles_per_split"], stream)
    else:
      vec = (d % 4 == 0 and (cfg.vd or cfg.vocab % 4 == 0)
             and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
      rc = lib.FusedXentStatsF32(*ptrs, part.data_ptr(), rows, d, cfg.vocab,
                                 int(cfg.vd), cfg.soft_cap, int(need_sum),
                                 geo["splits"], geo["tiles_per_split"],
                                 geo["tile"], geo["stages"], int(vec), stream)
    if rc != 0:
      raise RuntimeError("FusedXent kernel launch failed: "
                         + lib.FusedXentErrorString(rc).decode())
    FusedXentStats.launches += 1
    FusedXentStats.launches_by_dtype["bfloat16" if bf16 else "float32"] += 1
  return lse, llog, sumlog if need_sum else None, amax


# kernel launches, in all and by dtype (the plain version counts none)
FusedXentStats.launches = 0
FusedXentStats.launches_by_dtype = {"float32": 0, "bfloat16": 0}


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
    # the products take dz in x's dtype with float32 sums (reference dzc)
    dzc = dz.to(x.dtype)
    dx = dx + MatmulF32(dzc, w_blk if cfg.vd else w_blk.t())
    dw_blk = MatmulF32(dzc.t(), x)                         # [bs, D]
    if cfg.vd:
      dw[start:end] = dw_blk
    else:
      dw[:, start:end] = dw_blk.t()
    db[start:end] = torch.sum(dz, dim=0)   # cast to b's dtype
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

  inputs: [..., D] float32 or bfloat16 activations, weight (and bias) in
  the same dtype: [V, D] (weight_layout
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
