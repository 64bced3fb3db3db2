"""Fused blocked attention with a segment mask (port of lingvo_tpu/ops/flash_attention.py).

`FlashAttention(q, k, v, causal=..., segment_ids=...)` computes softmax
attention over [b, t, n, h] inputs, scaling by 1/sqrt(h) inside, with an
optional causal mask and a packed-input segment mask (pairs with different
ids never attend; padding carries id 0, so pad queries attend pad keys and
every row keeps its diagonal). It never materializes the [t, t] matrix on
the card.

Two implementations of one function:

- the CUDA kernels of `ops/csrc/flash_attention.cu`, for CUDA tensors:
  `FlashForward` (out and the row logsumexp `lse`; float32: register-
  blocked tiles with cp.async double buffering; bf16: warpgroup MMA fed
  by TMA, 128 queries per block), and the two backward
  kernels `FlashDkDv` and `FlashDq`, which recompute the probabilities
  from `lse` (float32: register-blocked tiles streamed through two
  cp.async stages, 64 owned rows per block; bf16: warpgroup MMA fed by
  TMA, 128 owned rows per block; `delta = rowsum(do * out)` stays a plain
  torch op, as it is XLA in the reference). `_FlashFunction` ties them into autograd.
- `_PlainAttention`, the reference's `_XlaAttention` twin in the same op
  order, natively differentiable: the CPU path, and on the card the
  float32 kernels' yardstick (`_PlainForward` adds lse, `_PlainBackward`
  takes the gradients through autograd).

bfloat16 q/k/v run bf16 instantiations of the three kernels, which round
where the reference's Pallas kernels round (`_DotF32` keeps bf16 operands
and sums in float32; p is rounded to bf16 before P.V at the running max
through the end of the reference's key block `block_k`; p and ds before
the backward products; outputs in bf16, lse float32). Their plain
versions are `_PallasForward` / `_PallasBackward`, the Pallas kernels'
twins. In bf16 the reference's two lowerings part (its `_XlaAttention`
rounds the NORMALISED p), so the CPU path follows the reference's
off-TPU rule (`SelectedLowering`): the `_XlaAttention` twin below
`XLA_FALLBACK_MAX_ELEMS` elements of t·n·h, the Pallas twins at or above
it. A CUDA tensor always launches the kernels, as the reference always
runs its kernel on a TPU. In float32 the two lowerings agree to ulps and
the CPU path keeps `_PlainAttention`.

Each wrapper checks dtype (float32 or bfloat16), shapes and contiguity
first, then picks by the device of the tensors it is given, and only by
that: a CUDA tensor launches the kernel of its dtype or raises. Launches
are counted in all (`launches`) and by dtype (`launches_by_dtype`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from lingvo_tpu_torch.ops import cuda_build

NEG_INF = -1.0e30   # the reference's flash_attention.NEG_INF
MAX_HEAD_DIM = 128  # kernel limit: h a multiple of 16, at most 128
DTYPES = (torch.float32, torch.bfloat16)
# the reference's _XLA_FALLBACK_MAX_ELEMS: off a TPU, t*n*h below this runs
# the _XlaAttention twin
XLA_FALLBACK_MAX_ELEMS = 1 << 21
BF16_KEY_TILE = 64  # the bf16 forward kernel's key tile


# -- argument checks ----------------------------------------------------------


def _CheckQkv(q, k, v, seg, name):
  if q.dtype not in DTYPES:
    raise TypeError(f"{name} takes float32 or bfloat16 q/k/v, got {q.dtype}")
  for x in (k, v):
    if x.dtype != q.dtype:
      raise TypeError(f"{name}: q/k/v must share one dtype, got {q.dtype} "
                      f"and {x.dtype}")
  if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
    raise ValueError(f"{name}: q/k/v must share one [b, t, n, h] shape, got "
                     f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
  b, t = q.shape[:2]
  if seg is not None:
    if seg.dtype != torch.int32 or tuple(seg.shape) != (b, t):
      raise ValueError(f"{name}: segment ids must be int32 [{b}, {t}], got "
                       f"{seg.dtype} {tuple(seg.shape)}")
  for x in (q, k, v) + ((seg,) if seg is not None else ()):
    if x.device != q.device:
      raise ValueError(f"{name}: tensor on {x.device}, q on {q.device}")


def _CheckRows(q, rows, name):
  b, t, n, _ = q.shape
  for label, x in rows.items():
    if x.dtype != torch.float32 or tuple(x.shape) != (b, n, t):
      raise ValueError(f"{name}: {label} must be float32 [{b}, {n}, {t}], "
                       f"got {x.dtype} {tuple(x.shape)}")


def KernelLimitError(head_dim: int) -> str | None:
  """Why the CUDA kernels cannot take this head dim, or None if they
  can: a multiple of 16, at most MAX_HEAD_DIM. The wrappers raise it; the
  attention gate reads it."""
  if head_dim % 16 or not 0 < head_dim <= MAX_HEAD_DIM:
    return (f"the kernels take a head dim that is a multiple of 16 and at "
            f"most {MAX_HEAD_DIM}, got {head_dim}")
  return None


def _CheckCudaLayout(tensors, name):
  q = tensors[0]
  reason = KernelLimitError(q.shape[-1])
  if reason is not None:
    raise ValueError(f"{name}: {reason}")
  if q.device.type != "cuda":
    raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
  for x in tensors:
    if x is not None and (not x.is_contiguous() or x.data_ptr() % 16):
      raise ValueError(f"{name} kernel takes contiguous tensors at 16-byte "
                       "aligned addresses")


def FitBlock(t: int, requested: int = 1024) -> int:
  """The reference's `_FitBlock`: min(requested, t), halved until it
  divides t."""
  c = min(requested, t)
  while c > 1 and t % c != 0:
    c //= 2
  return max(c, 1)


def _CheckBlockK(t: int, block_k: int):
  """The bf16 forward kernel rounds p per reference key block, in whole
  64-key tiles: block_k must be a multiple of 64 or cover all of t."""
  if block_k < t and block_k % BF16_KEY_TILE:
    raise ValueError(
        f"the bf16 flash forward kernel takes a reference key block that "
        f"is a multiple of {BF16_KEY_TILE} or covers t; t = {t} gives "
        f"block_k = {block_k}")


# -- plain PyTorch version (the CPU path) -------------------------------------


def _Keep(q, seg, causal):
  """[b, 1, t, t] bool: the pairs the causal and segment masks keep."""
  b, t = q.shape[:2]
  keep = torch.ones((b, 1, t, t), dtype=torch.bool, device=q.device)
  if causal:
    keep = keep & torch.tril(torch.ones((t, t), dtype=torch.bool,
                                        device=q.device))[None, None]
  if seg is not None:
    keep = keep & (seg[:, None, :, None] == seg[:, None, None, :])
  return keep


def _Scores(q, k, seg, causal):
  """Masked f32 scores [b, n, t, t], as the reference twin forms them."""
  s = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) / math.sqrt(
      q.shape[-1])
  return torch.where(_Keep(q, seg, causal), s, NEG_INF)


def _PlainAttention(q, k, v, seg, causal: bool):
  """The reference `_XlaAttention`: q/k/v [b, t, n, h], seg [b, t] int32 or
  None -> [b, t, n, h]. Natively differentiable."""
  p = torch.softmax(_Scores(q, k, seg, causal), dim=-1)
  # bf16: the normalised p rounds to v's dtype, and the bf16 product sums
  # in float32 and rounds once (float32: both casts are no-ops)
  return torch.einsum("bnqk,bknh->bqnh", p.to(v.dtype), v).to(q.dtype)


def _PlainForward(q, k, v, seg, causal: bool):
  """(out [b, t, n, h], lse [b, n, t]): the forward kernel's yardstick."""
  s = _Scores(q, k, seg, causal)
  out = torch.einsum("bnqk,bknh->bqnh", torch.softmax(s, dim=-1), v)
  return out.to(q.dtype), torch.logsumexp(s, dim=-1)


def _PlainBackward(q, k, v, seg, do, causal: bool):
  """(dq, dk, dv) of sum(out * do), through autograd of _PlainAttention."""
  with torch.enable_grad():
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = _PlainAttention(*leaves, seg, causal)
    return torch.autograd.grad(out, leaves, do)


def _MaskedScores(q, k, seg, causal):
  """The Pallas kernels' scores: f32(q . k) * sm_scale, masked to NEG_INF
  (the reference multiplies by 1/sqrt(h); the twin divides)."""
  s = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) * (
      1.0 / math.sqrt(q.shape[-1]))
  return torch.where(_Keep(q, seg, causal), s, NEG_INF)


def _PallasForward(q, k, v, seg, causal: bool, block_k: int):
  """The reference `_FwdKernel` over whole key blocks of block_k, in its op
  order: (out [b, t, n, h] in q's dtype, lse [b, n, t] float32). p =
  exp(s - m_safe) at the running max through the end of each key block,
  l sums it unrounded, acc adds p rounded to v's dtype times v. Blocks of
  the causal future are exact no-ops here (every pair masked), as the
  reference skips them. The bf16 kernel's yardstick, and the CPU path of
  bf16 inputs from XLA_FALLBACK_MAX_ELEMS up."""
  b, t, n, h = q.shape
  s = _MaskedScores(q, k, seg, causal)
  vf = v.float()
  m = torch.full((b, n, t, 1), NEG_INF, dtype=torch.float32, device=q.device)
  l = torch.zeros_like(m)
  acc = torch.zeros((b, n, t, h), dtype=torch.float32, device=q.device)
  for start in range(0, t, block_k):
    sb = s[..., start:start + block_k]
    m_new = torch.maximum(m, torch.amax(sb, dim=-1, keepdim=True))
    m_safe = torch.where(m_new <= NEG_INF * 0.5, 0.0, m_new)
    p = torch.exp(sb - m_safe)
    alpha = torch.exp(m - m_new)
    l = alpha * l + torch.sum(p, dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum(
        "bnqk,bknh->bnqh", p.to(v.dtype).float(),
        vf[:, start:start + block_k])
    m = m_new
  l = torch.clamp(l, min=1e-20)
  out = (acc / l).to(q.dtype).transpose(1, 2).contiguous()
  return out, (m + torch.log(l))[..., 0]


def _PallasBackward(q, k, v, seg, do, lse, delta, causal: bool):
  """The reference `_DkDvKernel` / `_DqKernel` in their op order: (dq, dk,
  dv) in q's dtype from p = exp(s - lse) and ds = p (dp - delta) sm_scale,
  with p and ds rounded to q's dtype before their products and each
  gradient summed in float32 and rounded once."""
  h = q.shape[-1]
  sm_scale = 1.0 / math.sqrt(h)
  p = torch.exp(_MaskedScores(q, k, seg, causal) - lse[..., None])
  dp = torch.einsum("bqnh,bknh->bnqk", do.float(), v.float())
  ds = p * (dp - delta[..., None]) * sm_scale
  pr, dsr = p.to(q.dtype).float(), ds.to(q.dtype).float()
  dv = torch.einsum("bnqk,bqnh->bknh", pr, do.float())
  dk = torch.einsum("bnqk,bqnh->bknh", dsr, q.float())
  dq = torch.einsum("bnqk,bknh->bqnh", dsr, k.float())
  return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- the CUDA kernels ----------------------------------------------------------


_lib = None   # the loaded kernel library, with its C signatures declared


def _Lib():
  global _lib
  if _lib is None:
    lib = cuda_build.Load("flash_attention")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.FlashFwdF32.argtypes = [vp] * 6 + [ci] * 5 + [vp]
    lib.FlashBwdDkDvF32.argtypes = [vp] * 9 + [ci] * 5 + [vp]
    lib.FlashBwdDqF32.argtypes = [vp] * 8 + [ci] * 5 + [vp]
    lib.FlashFwdBF16.argtypes = [vp] * 6 + [ci] * 6 + [vp]
    lib.FlashBwdDkDvBF16.argtypes = [vp] * 9 + [ci] * 5 + [vp]
    lib.FlashBwdDqBF16.argtypes = [vp] * 8 + [ci] * 5 + [vp]
    for fn in (lib.FlashFwdGeometry, lib.FlashFwdBf16Geometry):
      fn.argtypes = [ci] * 2 + [ctypes.POINTER(ci)] * 3
    lib.FlashBwdGeometry.argtypes = [ci] * 3 + [ctypes.POINTER(ci)]
    for fn in (lib.FlashFwdF32, lib.FlashBwdDkDvF32, lib.FlashBwdDqF32,
               lib.FlashFwdBF16, lib.FlashBwdDkDvBF16, lib.FlashBwdDqBF16,
               lib.FlashFwdGeometry, lib.FlashFwdBf16Geometry,
               lib.FlashBwdGeometry):
      fn.restype = ci
    lib.FlashErrorString.argtypes = [ci]
    lib.FlashErrorString.restype = ctypes.c_char_p
    _lib = lib
  return _lib


def _Launch(wrapper, kernel, pointers, q, causal, *extra):
  """Launches `kernel` + the dtype suffix of q's instantiation and counts
  it on `wrapper`."""
  b, t, n, h = q.shape
  lib = _Lib()
  dtype = _DTYPE_NAMES[q.dtype]
  fn_name = kernel + ("F32" if q.dtype == torch.float32 else "BF16")
  stream = torch.cuda.current_stream(q.device).cuda_stream
  rc = getattr(lib, fn_name)(*pointers, b, t, n, h, int(causal), *extra,
                             stream)
  if rc != 0:
    raise RuntimeError(f"{fn_name} kernel launch failed: "
                       + lib.FlashErrorString(rc).decode())
  wrapper.launches += 1
  wrapper.launches_by_dtype[dtype] += 1


_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def ForwardGeometry(t: int, h: int, dtype=torch.float32):
  """(threads, shared bytes per block, resident blocks per SM) of the
  forward kernel of `dtype` at sequence length t and head dim h, on the
  current device."""
  lib = _Lib()
  vals = [ctypes.c_int() for _ in range(3)]
  fn = (lib.FlashFwdGeometry if dtype == torch.float32
        else lib.FlashFwdBf16Geometry)
  rc = fn(t, h, *(ctypes.byref(v) for v in vals))
  if rc != 0:
    raise RuntimeError("FlashFwdGeometry failed: "
                       + lib.FlashErrorString(rc).decode())
  return tuple(v.value for v in vals)


def BackwardGeometry(t: int, h: int, dtype=torch.float32):
  """{'dkdv': {...}, 'dq': {...}}: the launch geometry of the two backward
  kernels of `dtype` at sequence length t and head dim h, on the current
  device. Each holds `tiles` (grid y; grid x is b * n), `threads`,
  `smem` (dynamic shared bytes per block), `per_sm` (resident blocks per
  SM), `regs` (registers per thread) and `local` (local, i.e. spill,
  bytes per thread)."""
  lib = _Lib()
  geo = (ctypes.c_int * 12)()
  rc = lib.FlashBwdGeometry(t, h, int(dtype == torch.bfloat16), geo)
  if rc != 0:
    raise RuntimeError("FlashBwdGeometry failed: "
                       + lib.FlashErrorString(rc).decode())
  keys = ("tiles", "threads", "smem", "per_sm", "regs", "local")
  return dict(dkdv=dict(zip(keys, geo[:6])), dq=dict(zip(keys, geo[6:])))


def _Ptr(x):
  return None if x is None else x.data_ptr()


def FlashForward(q, k, v, seg, causal: bool, block_k: int | None = None):
  """(out [b, t, n, h] in q's dtype, lse [b, n, t] float32) of masked
  softmax attention. block_k: the reference's key block (None: its
  default, FitBlock(t, 1024)); only bf16 rounds per block.

  CPU tensors run `_PlainForward` (float32) or `_PallasForward` (bf16);
  CUDA tensors launch the forward kernel of their dtype (counted in
  `FlashForward.launches` and `.launches_by_dtype`) or raise."""
  _CheckQkv(q, k, v, seg, "FlashForward")
  t = q.shape[1]
  block_k = FitBlock(t) if block_k is None else block_k
  if q.device.type == "cpu":
    if q.dtype == torch.float32:
      return _PlainForward(q, k, v, seg, causal)
    return _PallasForward(q, k, v, seg, causal, block_k)
  _CheckCudaLayout((q, k, v, seg), "FlashForward")
  extra = ()
  if q.dtype == torch.bfloat16:
    _CheckBlockK(t, block_k)
    extra = (block_k,)
  b, t, n, _ = q.shape
  out = torch.empty_like(q)
  lse = torch.empty((b, n, t), dtype=torch.float32, device=q.device)
  if q.numel():
    _Launch(FlashForward, "FlashFwd",
            [_Ptr(x) for x in (q, k, v, seg, out, lse)], q, causal, *extra)
  return out, lse


def FlashDkDv(q, k, v, seg, do, lse, delta, causal: bool):
  """(dk, dv) of sum(out * do), with p recomputed from lse.

  lse and delta = rowsum(do * out) are float32 [b, n, t]. CPU tensors run
  `_PlainBackward` (float32) or `_PallasBackward` (bf16); CUDA tensors
  launch the dK/dV kernel of their dtype (counted in `FlashDkDv.launches`
  and `.launches_by_dtype`) or raise."""
  _CheckQkv(q, k, v, seg, "FlashDkDv")
  _CheckQkv(q, do, do, None, "FlashDkDv")
  _CheckRows(q, dict(lse=lse, delta=delta), "FlashDkDv")
  if q.device.type == "cpu":
    if q.dtype == torch.float32:
      return _PlainBackward(q, k, v, seg, do, causal)[1:]
    return _PallasBackward(q, k, v, seg, do, lse, delta, causal)[1:]
  _CheckCudaLayout((q, k, v, seg, do, lse, delta), "FlashDkDv")
  dk, dv = torch.empty_like(k), torch.empty_like(v)
  if q.numel():
    _Launch(FlashDkDv, "FlashBwdDkDv",
            [_Ptr(x) for x in (q, k, v, seg, do, lse, delta, dk, dv)], q,
            causal)
  return dk, dv


def FlashDq(q, k, v, seg, do, lse, delta, causal: bool):
  """dq of sum(out * do), with p recomputed from lse (see FlashDkDv).

  CPU tensors run `_PlainBackward` (float32) or `_PallasBackward` (bf16);
  CUDA tensors launch the dQ kernel of their dtype (counted in
  `FlashDq.launches` and `.launches_by_dtype`) or raise."""
  _CheckQkv(q, k, v, seg, "FlashDq")
  _CheckQkv(q, do, do, None, "FlashDq")
  _CheckRows(q, dict(lse=lse, delta=delta), "FlashDq")
  if q.device.type == "cpu":
    if q.dtype == torch.float32:
      return _PlainBackward(q, k, v, seg, do, causal)[0]
    return _PallasBackward(q, k, v, seg, do, lse, delta, causal)[0]
  _CheckCudaLayout((q, k, v, seg, do, lse, delta), "FlashDq")
  dq = torch.empty_like(q)
  if q.numel():
    _Launch(FlashDq, "FlashBwdDq",
            [_Ptr(x) for x in (q, k, v, seg, do, lse, delta, dq)], q, causal)
  return dq


# kernel launches, in all and by dtype (the plain versions count none)
for _wrapper in (FlashForward, FlashDkDv, FlashDq):
  _wrapper.launches = 0
  _wrapper.launches_by_dtype = dict.fromkeys(_DTYPE_NAMES.values(), 0)
del _wrapper


def RowDelta(do, out):
  """delta = rowsum(do * out) in float32, as [b, n, t] (reference `:334`)."""
  return torch.sum(do.float() * out.float(), dim=-1).transpose(1, 2) \
      .contiguous()


class _FlashFunction(torch.autograd.Function):
  """The kernels under autograd: forward saves (q, k, v, seg, out, lse)."""

  @staticmethod
  def forward(ctx, q, k, v, seg, causal, block_k=None):
    out, lse = FlashForward(q, k, v, seg, causal, block_k)
    ctx.save_for_backward(q, k, v, seg, out, lse)
    ctx.causal = causal
    return out

  @staticmethod
  def backward(ctx, do):
    q, k, v, seg, out, lse = ctx.saved_tensors
    do = do.contiguous()
    delta = RowDelta(do, out)
    dk, dv = FlashDkDv(q, k, v, seg, do, lse, delta, ctx.causal)
    dq = FlashDq(q, k, v, seg, do, lse, delta, ctx.causal)
    return dq, dk, dv, None, None, None


# -- public entry --------------------------------------------------------------


def SelectedLowering(q) -> str:
  """What FlashAttention runs for q: 'kernel' (CUDA), 'xla-twin' or
  'pallas-twin' (CPU; the reference's off-TPU rule, which only bf16
  tells apart)."""
  if q.device.type != "cpu":
    return "kernel"
  _, t, n, h = q.shape
  if q.dtype == torch.float32 or t * n * h < XLA_FALLBACK_MAX_ELEMS:
    return "xla-twin"
  return "pallas-twin"


def FlashAttention(q, k, v, *, causal: bool = True, segment_ids=None,
                   block_k: int = 1024):
  """Fused attention. q/k/v: [b, t, n, h] float32 or bfloat16 -> [b, t, n,
  h] in their dtype.

  segment_ids: optional [b, t] int; pairs with different ids never
  attend, and padding should carry id 0. Scaling by 1/sqrt(h) happens
  INSIDE (don't pre-scale q). block_k: the reference's key block, fitted
  to t as the reference fits it (`FitBlock`; bf16 rounds p per block).
  Differentiable in q, k and v.

  CPU tensors run a plain version (`SelectedLowering`; autograd through
  the `_XlaAttention` twin, or the Pallas twins under the kernels'
  autograd Function); CUDA tensors run the forward kernel, and the dK/dV
  and dQ kernels in the backward."""
  seg = None if segment_ids is None else segment_ids.to(torch.int32)
  _CheckQkv(q, k, v, seg, "FlashAttention")
  if q.device.type not in ("cpu", "cuda"):
    raise ValueError(f"FlashAttention runs on cpu or cuda, not {q.device}")
  if SelectedLowering(q) == "xla-twin":
    return _PlainAttention(q, k, v, seg, causal)
  return _FlashFunction.apply(q, k, v, seg, causal,
                              FitBlock(q.shape[1], block_k))
