"""Fused blocked attention with a segment mask (port of lingvo_tpu/ops/flash_attention.py).

`FlashAttention(q, k, v, causal=..., segment_ids=...)` computes softmax
attention over [b, t, n, h] inputs, scaling by 1/sqrt(h) inside, with an
optional causal mask and a packed-input segment mask (pairs with different
ids never attend; padding carries id 0, so pad queries attend pad keys and
every row keeps its diagonal). It never materializes the [t, t] matrix on
the card.

Two implementations of one function:

- the CUDA kernels of `ops/csrc/flash_attention.cu`, for CUDA tensors:
  `FlashForward` (out and the row logsumexp `lse`; register-blocked tiles
  with cp.async double buffering), and the two backward
  kernels `FlashDkDv` and `FlashDq`, which recompute the probabilities
  from `lse` (`delta = rowsum(do * out)` stays a plain torch op, as it is
  XLA in the reference). `_FlashFunction` ties them into autograd.
- `_PlainAttention`, the reference's `_XlaAttention` twin in the same op
  order, natively differentiable: the CPU path, and on the card the
  kernels' yardstick (`_PlainForward` adds lse, `_PlainBackward` takes the
  gradients through autograd).

Each wrapper checks dtype (float32 only: bf16 comes with a later slice),
shapes and contiguity first, then picks by the device of the tensors it is
given, and only by that: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from lingvo_tpu_torch.ops import cuda_build

NEG_INF = -1.0e30   # the reference's flash_attention.NEG_INF
MAX_HEAD_DIM = 128  # kernel limit: h a multiple of 16, at most 128


# -- argument checks ----------------------------------------------------------


def _CheckQkv(q, k, v, seg, name):
  for x in (q, k, v):
    if x.dtype != torch.float32:
      raise TypeError(
          f"{name} takes float32 q/k/v, got {x.dtype}; bfloat16 attention "
          "comes with the bf16-kernel slice of the port")
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


def _CheckCudaLayout(tensors, name):
  q = tensors[0]
  if q.device.type != "cuda":
    raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
  h = q.shape[-1]
  if h % 16 != 0 or h > MAX_HEAD_DIM:
    raise ValueError(f"{name} kernel takes a head dim that is a multiple of "
                     f"16 and at most {MAX_HEAD_DIM}, got {h}")
  for x in tensors:
    if x is not None and not x.is_contiguous():
      raise ValueError(f"{name} kernel takes contiguous tensors")


# -- plain PyTorch version (the CPU path) -------------------------------------


def _Scores(q, k, seg, causal):
  """Masked f32 scores [b, n, t, t], as the reference twin forms them."""
  b, t, n, h = q.shape
  s = torch.einsum("bqnh,bknh->bnqk", q, k) / math.sqrt(h)
  keep = torch.ones((b, 1, t, t), dtype=torch.bool, device=q.device)
  if causal:
    keep = keep & torch.tril(torch.ones((t, t), dtype=torch.bool,
                                        device=q.device))[None, None]
  if seg is not None:
    keep = keep & (seg[:, None, :, None] == seg[:, None, None, :])
  return torch.where(keep, s, NEG_INF)


def _PlainAttention(q, k, v, seg, causal: bool):
  """The reference `_XlaAttention`: q/k/v [b, t, n, h], seg [b, t] int32 or
  None -> [b, t, n, h]. Natively differentiable."""
  p = torch.softmax(_Scores(q, k, seg, causal), dim=-1)
  return torch.einsum("bnqk,bknh->bqnh", p, v).to(q.dtype)


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
    lib.FlashFwdGeometry.argtypes = [ci] * 2 + [ctypes.POINTER(ci)] * 3
    for fn in (lib.FlashFwdF32, lib.FlashBwdDkDvF32, lib.FlashBwdDqF32,
               lib.FlashFwdGeometry):
      fn.restype = ci
    lib.FlashErrorString.argtypes = [ci]
    lib.FlashErrorString.restype = ctypes.c_char_p
    _lib = lib
  return _lib


def _Launch(fn_name, pointers, q, causal):
  b, t, n, h = q.shape
  lib = _Lib()
  stream = torch.cuda.current_stream(q.device).cuda_stream
  rc = getattr(lib, fn_name)(*pointers, b, t, n, h, int(causal), stream)
  if rc != 0:
    raise RuntimeError(f"{fn_name} kernel launch failed: "
                       + lib.FlashErrorString(rc).decode())


def ForwardGeometry(t: int, h: int):
  """(threads, shared bytes per block, resident blocks per SM) of the
  forward kernel at sequence length t and head dim h, on the current
  device."""
  lib = _Lib()
  vals = [ctypes.c_int() for _ in range(3)]
  rc = lib.FlashFwdGeometry(t, h, *(ctypes.byref(v) for v in vals))
  if rc != 0:
    raise RuntimeError("FlashFwdGeometry failed: "
                       + lib.FlashErrorString(rc).decode())
  return tuple(v.value for v in vals)


def _Ptr(x):
  return None if x is None else x.data_ptr()


def FlashForward(q, k, v, seg, causal: bool):
  """(out [b, t, n, h], lse [b, n, t]) of masked softmax attention.

  CPU tensors run `_PlainForward`; CUDA tensors launch the forward kernel
  (one launch counted in `FlashForward.launches`) or raise."""
  _CheckQkv(q, k, v, seg, "FlashForward")
  if q.device.type == "cpu":
    return _PlainForward(q, k, v, seg, causal)
  _CheckCudaLayout((q, k, v, seg), "FlashForward")
  b, t, n, _ = q.shape
  out = torch.empty_like(q)
  lse = torch.empty((b, n, t), dtype=torch.float32, device=q.device)
  if q.numel():
    _Launch("FlashFwdF32", [_Ptr(x) for x in (q, k, v, seg, out, lse)], q,
            causal)
    FlashForward.launches += 1
  return out, lse


def FlashDkDv(q, k, v, seg, do, lse, delta, causal: bool):
  """(dk, dv) of sum(out * do), with p recomputed from lse.

  lse and delta = rowsum(do * out) are float32 [b, n, t]. CPU tensors run
  `_PlainBackward`; CUDA tensors launch the dK/dV kernel (counted in
  `FlashDkDv.launches`) or raise."""
  _CheckQkv(q, k, v, seg, "FlashDkDv")
  _CheckQkv(q, do, do, None, "FlashDkDv")
  _CheckRows(q, dict(lse=lse, delta=delta), "FlashDkDv")
  if q.device.type == "cpu":
    return _PlainBackward(q, k, v, seg, do, causal)[1:]
  _CheckCudaLayout((q, k, v, seg, do, lse, delta), "FlashDkDv")
  dk, dv = torch.empty_like(k), torch.empty_like(v)
  if q.numel():
    _Launch("FlashBwdDkDvF32",
            [_Ptr(x) for x in (q, k, v, seg, do, lse, delta, dk, dv)], q,
            causal)
    FlashDkDv.launches += 1
  return dk, dv


def FlashDq(q, k, v, seg, do, lse, delta, causal: bool):
  """dq of sum(out * do), with p recomputed from lse (see FlashDkDv).

  CPU tensors run `_PlainBackward`; CUDA tensors launch the dQ kernel
  (counted in `FlashDq.launches`) or raise."""
  _CheckQkv(q, k, v, seg, "FlashDq")
  _CheckQkv(q, do, do, None, "FlashDq")
  _CheckRows(q, dict(lse=lse, delta=delta), "FlashDq")
  if q.device.type == "cpu":
    return _PlainBackward(q, k, v, seg, do, causal)[0]
  _CheckCudaLayout((q, k, v, seg, do, lse, delta), "FlashDq")
  dq = torch.empty_like(q)
  if q.numel():
    _Launch("FlashBwdDqF32",
            [_Ptr(x) for x in (q, k, v, seg, do, lse, delta, dq)], q, causal)
    FlashDq.launches += 1
  return dq


FlashForward.launches = 0   # kernel launches (the plain versions count none)
FlashDkDv.launches = 0
FlashDq.launches = 0


def RowDelta(do, out):
  """delta = rowsum(do * out) in float32, as [b, n, t] (reference `:334`)."""
  return torch.sum(do.float() * out.float(), dim=-1).transpose(1, 2) \
      .contiguous()


class _FlashFunction(torch.autograd.Function):
  """The kernels under autograd: forward saves (q, k, v, seg, out, lse)."""

  @staticmethod
  def forward(ctx, q, k, v, seg, causal):
    out, lse = FlashForward(q, k, v, seg, causal)
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
    return dq, dk, dv, None, None


# -- public entry --------------------------------------------------------------


def FlashAttention(q, k, v, *, causal: bool = True, segment_ids=None):
  """Fused attention. q/k/v: [b, t, n, h] float32 -> [b, t, n, h].

  segment_ids: optional [b, t] int; pairs with different ids never
  attend, and padding should carry id 0. Scaling by 1/sqrt(h) happens
  INSIDE (don't pre-scale q). Differentiable in q, k and v.

  CPU tensors run the plain version (autograd through it); CUDA tensors
  run the forward kernel, and the dK/dV and dQ kernels in the backward."""
  seg = None if segment_ids is None else segment_ids.to(torch.int32)
  _CheckQkv(q, k, v, seg, "FlashAttention")
  if q.device.type == "cpu":
    return _PlainAttention(q, k, v, seg, causal)
  if q.device.type != "cuda":
    raise ValueError(f"FlashAttention runs on cpu or cuda, not {q.device}")
  return _FlashFunction.apply(q, k, v, seg, causal)
