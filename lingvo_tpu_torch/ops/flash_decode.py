"""Length-aware paged flash decode over a dense KV cache (port of lingvo_tpu/ops/flash_decode.py).

The incremental-decode read of `MultiHeadedAttention.ExtendStep` when
`decode_page_size > 0`: one pre-scaled query per row attends a
`[B, S, N, H]` cache of which only slots `[0, time_step]` are live. The
cache's time axis is cut into pages of `page_size` slots and only pages up
to `time_step` are read; `cache_paddings` (1.0 = never attend) masks the
left-pad slots of right-aligned prompts. A row with nothing live (every
live slot padded) returns exactly 0.

Two implementations of one function:

- the CUDA kernel `ops/csrc/flash_decode.cu` (one thread block per
  (row, head), walking only the `time_step // page_size + 1` live pages),
  launched for CUDA tensors;
- `_PlainDecode`, the reference twin `_XlaDecode`'s loop over live pages
  through the shared page step (`ragged_block_attend._PageAttend`, the
  reference `_PageAttend` batched over rows, with `_Finish`'s
  max(l, 1e-20)), used for CPU tensors and as the kernel's yardstick.

`FlashDecode` picks between them by the device of the tensors it is
given, and only by that: a CUDA tensor launches the kernel or raises.
`time_step` is a host integer: the decode loop that calls this op counts
its steps on the host, so no device value is read back per step.
"""

from __future__ import annotations

import ctypes

import torch

from lingvo_tpu_torch.ops import cuda_build
from lingvo_tpu_torch.ops.ragged_block_attend import (NEG_INF, _Finish,
                                                     _PageAttend)

MAX_PAGE_SIZE = 128   # kernel limits
HEAD_DIMS = (4, 8, 16, 32, 64, 128)


# -- plain PyTorch version (the CPU path) -----------------------------------


def _PlainDecode(q, k_cache, v_cache, time_step: int, page_size: int,
                 cache_paddings=None):
  """q: [B, N, H]; caches [B, S, N, H]; time_step int -> [B, N, H].

  Trip count min(time_step // P + 1, S // P): pages past time_step are
  never read."""
  b, s, n, h = k_cache.shape
  dev = q.device
  num_live = max(min(time_step // page_size + 1, s // page_size), 0)
  pad = (torch.zeros((b, s), dtype=torch.float32, device=dev)
         if cache_paddings is None else cache_paddings.float())
  m = torch.full((b, n, 1), NEG_INF, dtype=torch.float32, device=dev)
  l = torch.zeros((b, n, 1), dtype=torch.float32, device=dev)
  acc = torch.zeros((b, n, h), dtype=torch.float32, device=dev)
  offsets = torch.arange(page_size, device=dev)
  for j in range(num_live):
    start = j * page_size
    sl = slice(start, start + page_size)
    slot = start + offsets                                   # [P]
    keep = ((slot[None, :] <= time_step).float()
            * (1.0 - pad[:, sl]))[:, None, :]                # [B, 1, P]
    m, l, acc = _PageAttend(q.float(), k_cache[:, sl].float(),
                            v_cache[:, sl].float(), keep, m, l, acc)
  return _Finish(l, acc, q.dtype)


# -- the CUDA kernel ---------------------------------------------------------


_lib = None   # the loaded kernel library, with its C signatures declared


def _Lib():
  global _lib
  if _lib is None:
    lib = cuda_build.Load("flash_decode")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.FlashDecodeF32.argtypes = [vp] * 5 + [ci] * 6 + [vp]
    lib.FlashDecodeF32.restype = ci
    lib.FlashDecodeErrorString.argtypes = [ci]
    lib.FlashDecodeErrorString.restype = ctypes.c_char_p
    _lib = lib
  return _lib


def _CudaDecode(q, k_cache, v_cache, time_step, page_size, cache_paddings):
  b, n, h = q.shape
  s = k_cache.shape[1]
  for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
    if x.dtype != torch.float32:
      raise TypeError(f"FlashDecode kernel takes float32 {name}, got "
                      f"{x.dtype}")
  if k_cache.shape != v_cache.shape or tuple(k_cache.shape) != (b, s, n, h):
    raise ValueError(f"cache shapes {tuple(k_cache.shape)}, "
                     f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
  if not 1 <= page_size <= MAX_PAGE_SIZE:
    raise ValueError(f"page_size {page_size} outside the kernel's "
                     f"[1, {MAX_PAGE_SIZE}]")
  if h not in HEAD_DIMS:
    raise ValueError(f"head dim {h} not one of the kernel's {HEAD_DIMS}")
  tensors = [q, k_cache, v_cache]
  if cache_paddings is not None:
    if cache_paddings.dtype != torch.float32 or tuple(
        cache_paddings.shape) != (b, s):
      raise ValueError(f"cache_paddings must be float32 [{b}, {s}], got "
                       f"{cache_paddings.dtype} {tuple(cache_paddings.shape)}")
    tensors.append(cache_paddings)
  for x in tensors:
    if x.device != q.device:
      raise ValueError(f"tensor on {x.device}, q on {q.device}")
    if not x.is_contiguous():
      raise ValueError("FlashDecode kernel takes contiguous tensors")
  out = torch.empty_like(q)
  if b == 0:
    return out
  lib = _Lib()
  stream = torch.cuda.current_stream(q.device).cuda_stream
  rc = lib.FlashDecodeF32(
      q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
      None if cache_paddings is None else cache_paddings.data_ptr(),
      out.data_ptr(), b, s, n, h, page_size, int(time_step), stream)
  if rc != 0:
    raise RuntimeError("FlashDecode kernel launch failed: "
                       + lib.FlashDecodeErrorString(rc).decode())
  FlashDecode.launches += 1
  return out


# -- public entry ------------------------------------------------------------


def FlashDecode(q, k_cache, v_cache, time_step: int, *, page_size: int,
                cache_paddings=None):
  """Paged single-token decode attention.

  q: [B, 1, N, H], the newest query, ALREADY scaled (nothing is applied
  inside). k_cache/v_cache: [B, S, N, H] with slots [0, time_step] live
  (the caller writes slot time_step first); S a multiple of page_size.
  time_step: host int. cache_paddings: optional [B, S] float32, 1.0 =
  never attend this slot. Returns [B, 1, N, H].

  CPU tensors run the plain version; CUDA tensors launch the kernel (and
  count one launch in `FlashDecode.launches`) or raise."""
  if q.ndim != 4 or q.shape[1] != 1:
    raise ValueError(f"q must be [B, 1, N, H], got {tuple(q.shape)}")
  if not SupportedShape(k_cache.shape[1], page_size):
    raise ValueError(f"cache length {k_cache.shape[1]} is not a positive "
                     f"multiple of page_size {page_size}")
  time_step = int(time_step)
  q3 = q[:, 0]
  if q.device.type == "cpu":
    out = _PlainDecode(q3, k_cache, v_cache, time_step, page_size,
                       cache_paddings)
  elif q.device.type == "cuda":
    out = _CudaDecode(q3.contiguous(), k_cache, v_cache, time_step,
                      page_size, cache_paddings)
  else:
    raise ValueError(f"FlashDecode runs on cpu or cuda, not {q.device}")
  return out[:, None]


FlashDecode.launches = 0   # kernel launches (the plain version counts none)


def SupportedShape(max_len: int, page_size: int) -> bool:
  """Whether a [B, max_len, N, H] cache can take the paged path."""
  return page_size > 0 and max_len % page_size == 0 and max_len >= page_size
