"""Length-aware paged flash decode over a dense KV cache (port of lingvo_tpu/ops/flash_decode.py).

The incremental-decode read of `MultiHeadedAttention.ExtendStep` when
`decode_page_size > 0`: one pre-scaled query per row attends a
`[B, S, N, H]` cache of which only slots `[0, time_step]` are live. The
cache's time axis is cut into pages of `page_size` slots and only pages up
to `time_step` are read; `cache_paddings` (1.0 = never attend) masks the
left-pad slots of right-aligned prompts. A row with nothing live (every
live slot padded) returns exactly 0.

Two implementations of one function:

- the CUDA kernels of `ops/csrc/flash_decode.cu`, launched for CUDA
  tensors. A float32 cache takes a split kernel (grid (row x head,
  `NumSplits`); each block finds the row's first live slot and streams
  its share of the tiles from there to `time_step` through shared memory
  with cp.async) and a combine kernel that merges the splits' (m, l, acc)
  in split order. A bfloat16 cache takes one launch: the splits of a
  (row, head) form a thread-block cluster (`NumSplitsBf16`, at most 8),
  keep their scores in shared memory, exchange their maxima through
  distributed shared memory and merge in the same launch;
- `_PlainDecode`, the reference twin `_XlaDecode`'s loop over live pages
  through the shared page step (`ragged_block_attend._PageAttend`, the
  reference `_PageAttend` batched over rows, with `_Finish`'s
  max(l, 1e-20)), used for CPU tensors and as the kernel's yardstick.

`FlashDecode` picks between them by the device of the tensors it is
given, and only by that: a CUDA tensor launches the kernel or raises.

The cache is float32 or bfloat16 (`kv_cache_dtype='bfloat16'`). A
bfloat16 cache is read as float32 and its probabilities are rounded to
bfloat16 before P.V, as the reference's `_PageAttend` does
(`p.astype(v_page.dtype)`), each against the running max through the end
of its page, where the reference rounds it: the blocks of a cluster take
that max from each other's page maxima (see the .cu file). An int8 cache
never comes here: `ExtendStep` reads it densely.
q is float32, or bfloat16 under fprop_dtype=bfloat16: the reference
multiplies the widened q, sums in float32 and rounds the output to q's
dtype (`_Finish`); each kernel has a bfloat16-q instantiation that does
the same, with the split count of the float32-q kernel.
`time_step` is a host integer: the decode loop that calls this op counts
its steps on the host, so no device value is read back per step.
"""

from __future__ import annotations

import ctypes

import torch

from lingvo_tpu_torch.ops import cuda_build
from lingvo_tpu_torch.ops.ragged_block_attend import (
    KV_DTYPES, NEG_INF, CheckAligned, CheckQDtype, NewLaunchCounts,
    NewQLaunchCounts, _Finish, _PageAttend)
from lingvo_tpu_torch.quant import kv as kv_quant

MAX_PAGE_SIZE = 128   # page sizes the op takes (the kernel reads slots)
HEAD_DIMS = (4, 8, 16, 32, 64, 128)   # kernel limit: H / 4 a power of two
# the cache dtypes the kernel takes and their head dims (a 16-byte copy
# must not span two slots)
DTYPE_HEAD_DIMS = {torch.float32: HEAD_DIMS, torch.bfloat16: HEAD_DIMS[1:]}
TILE_BYTES = 8192     # K (and V) bytes of one kernel tile
MAX_TILE_SLOTS = 128
MAX_CLUSTER = 8       # bfloat16: splits of a (row, head), one cluster
MAX_CTA_SLOTS = 8192  # bfloat16: slots whose scores one block holds


# -- plain PyTorch version (the CPU path) -----------------------------------


def _PlainDecode(q, k_cache, v_cache, time_step: int, page_size: int,
                 cache_paddings=None):
  """q: [B, N, H]; caches [B, S, N, H] float32 or bfloat16; time_step
  int -> [B, N, H].

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
    m, l, acc = _PageAttend(q.float(), k_cache[:, sl], v_cache[:, sl], keep,
                            m, l, acc)
  return _Finish(l, acc, q.dtype)


# -- the CUDA kernel ---------------------------------------------------------


_lib = None   # the loaded kernel library, with its C signatures declared
# (device index, cache dtype) -> (threads, smem bytes, blocks per SM, SMs)
_geometry = {}


def _Lib():
  global _lib
  if _lib is None:
    lib = cuda_build.Load("flash_decode")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.FlashDecode.argtypes = [vp] * 6 + [ci] * 9 + [vp]
    lib.FlashDecode.restype = ci
    lib.FlashDecodeScratchFloats.argtypes = [ci] * 6
    lib.FlashDecodeScratchFloats.restype = ctypes.c_longlong
    lib.FlashDecodeGeometry.argtypes = [ci] + [ctypes.POINTER(ci)] * 3
    lib.FlashDecodeGeometry.restype = ci
    lib.FlashDecodeErrorString.argtypes = [ci]
    lib.FlashDecodeErrorString.restype = ctypes.c_char_p
    _lib = lib
  return _lib


def TileSlots(head_dim: int, itemsize: int = 4) -> int:
  """Slots of one kernel tile: 8 KB of K, at most 128 slots."""
  return min(MAX_TILE_SLOTS, TILE_BYTES // (head_dim * itemsize))


def NumSplits(rows: int, time_step: int, seq_len: int, head_dim: int,
              sm_count: int, blocks_per_sm: int, itemsize: int = 4) -> int:
  """Blocks per (row, head): enough for two waves of the card's resident
  blocks over `rows` = B x N, and never more than the tiles of [0,
  time_step], so a row whose every slot up to time_step is live gets no
  empty split. itemsize: bytes of one cache element."""
  t_eff = min(time_step, seq_len - 1)
  if t_eff < 0:
    return 1
  tiles = t_eff // TileSlots(head_dim, itemsize) + 1
  want = -(-2 * sm_count * blocks_per_sm // max(rows, 1))
  return max(1, min(want, tiles))


def NumSplitsBf16(rows: int, time_step: int, seq_len: int, head_dim: int,
                  sm_count: int, blocks_per_sm: int) -> int:
  """Blocks per (row, head) of a bfloat16 cache: the float32 rule
  (`NumSplits`) capped at MAX_CLUSTER, since the splits of one (row, head)
  form one thread-block cluster and 8 is the portable cluster size."""
  return min(MAX_CLUSTER, NumSplits(rows, time_step, seq_len, head_dim,
                                    sm_count, blocks_per_sm, 2))


def CtaSlots(seq_len: int, head_dim: int, time_step: int,
             splits: int) -> int:
  """Slots whose float32 scores one block of a bfloat16 cache holds in
  shared memory: ceil(tiles / splits) tiles, the tiles counted from slot
  0 to time_step (the first live slot is found on the card)."""
  t_eff = min(time_step, seq_len - 1)
  if t_eff < 0:
    return 0
  ts = TileSlots(head_dim, 2)
  return -(-(t_eff // ts + 1) // splits) * ts


def Geometry(device, dtype=torch.float32) -> tuple:
  """(threads, shared bytes per block, resident blocks per SM, SMs) of the
  split kernel for a `dtype` cache on `device`, queried once per device
  and dtype."""
  idx = torch.device(device).index
  idx = torch.cuda.current_device() if idx is None else idx
  if (idx, dtype) not in _geometry:
    lib = _Lib()
    vals = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(idx):
      rc = lib.FlashDecodeGeometry(KV_DTYPES[dtype],
                                   *(ctypes.byref(v) for v in vals))
    if rc != 0:
      raise RuntimeError("FlashDecodeGeometry failed: "
                         + lib.FlashDecodeErrorString(rc).decode())
    sms = torch.cuda.get_device_properties(idx).multi_processor_count
    _geometry[idx, dtype] = tuple(v.value for v in vals) + (sms,)
  return _geometry[idx, dtype]


def KernelLimitError(head_dim: int, page_size: int,
                     dtype=torch.float32) -> str | None:
  """Why the CUDA kernel cannot take this shape, or None if it can: a
  float32 or bfloat16 cache, head dim in DTYPE_HEAD_DIMS[dtype] (a
  bfloat16 cache's 16-byte copies must not span two slots: 8 and up),
  page_size 1..MAX_PAGE_SIZE. The wrapper raises it; the attention gate
  reads it."""
  if dtype not in DTYPE_HEAD_DIMS:
    return f"FlashDecode kernel takes float32 or bfloat16 caches, not {dtype}"
  if head_dim not in DTYPE_HEAD_DIMS[dtype]:
    return (f"head dim {head_dim} not one of the FlashDecode kernel's "
            f"{DTYPE_HEAD_DIMS[dtype]} for a {dtype} cache")
  if not 1 <= page_size <= MAX_PAGE_SIZE:
    return (f"page_size {page_size} outside the FlashDecode kernel's "
            f"[1, {MAX_PAGE_SIZE}]")
  return None


def _CudaDecode(q, k_cache, v_cache, time_step, page_size, cache_paddings):
  b, n, h = q.shape
  s = k_cache.shape[1]
  dtype = k_cache.dtype
  q_code = CheckQDtype("FlashDecode", q)
  if v_cache.dtype != dtype or dtype not in DTYPE_HEAD_DIMS:
    raise TypeError(f"FlashDecode kernel takes float32 or bfloat16 caches "
                    f"of one dtype, got {dtype}, {v_cache.dtype}")
  if k_cache.shape != v_cache.shape or tuple(k_cache.shape) != (b, s, n, h):
    raise ValueError(f"cache shapes {tuple(k_cache.shape)}, "
                     f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
  reason = KernelLimitError(h, page_size, dtype)
  if reason is not None:
    raise ValueError(reason)
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
  CheckAligned("FlashDecode", tensors)
  out = torch.empty_like(q)
  if b == 0:
    return out
  _, _, per_sm, sms = Geometry(q.device, dtype)
  lib = _Lib()
  code = KV_DTYPES[dtype]
  scratch = None
  if dtype == torch.bfloat16:
    splits = NumSplitsBf16(b * n, time_step, s, h, sms, per_sm)
    if b * n > 65535:
      raise ValueError(f"B x N = {b * n} rows exceed the bfloat16 kernel's "
                       "grid (65535)")
    slots = CtaSlots(s, h, time_step, splits)
    if slots > MAX_CTA_SLOTS:
      raise ValueError(
          f"time_step {time_step} over {splits} splits gives each block "
          f"{slots} slots of scores, above the bfloat16 kernel's "
          f"{MAX_CTA_SLOTS}")
  else:
    splits = NumSplits(b * n, time_step, s, h, sms, per_sm, dtype.itemsize)
    scratch = torch.empty(
        lib.FlashDecodeScratchFloats(b, s, n, h, splits, code),
        dtype=torch.float32, device=q.device)
  stream = torch.cuda.current_stream(q.device).cuda_stream
  rc = lib.FlashDecode(
      q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
      None if cache_paddings is None else cache_paddings.data_ptr(),
      out.data_ptr(), None if scratch is None else scratch.data_ptr(), b, s,
      n, h, int(time_step), splits, page_size, code, q_code, stream)
  if rc != 0:
    raise RuntimeError("FlashDecode kernel launch failed: "
                       + lib.FlashDecodeErrorString(rc).decode())
  kv_name = kv_quant.DtypeName(dtype)
  FlashDecode.launches += 1
  FlashDecode.launches_by_dtype[kv_name] += 1
  FlashDecode.launches_by_q_dtype[kv_quant.DtypeName(q.dtype)][kv_name] += 1
  return out


# -- public entry ------------------------------------------------------------


def FlashDecode(q, k_cache, v_cache, time_step: int, *, page_size: int,
                cache_paddings=None):
  """Paged single-token decode attention.

  q: [B, 1, N, H], the newest query, ALREADY scaled (nothing is applied
  inside), float32 or bfloat16 (the output takes q's dtype).
  k_cache/v_cache: [B, S, N, H] float32 or bfloat16 with slots [0,
  time_step] live (the caller writes slot time_step first); S a multiple
  of page_size.
  time_step: host int. cache_paddings: optional [B, S] float32, 1.0 =
  never attend this slot. Returns [B, 1, N, H].

  CPU tensors run the plain version; CUDA tensors launch the kernel for
  q's and the cache's dtypes (counting one call in `FlashDecode.launches`,
  in `FlashDecode.launches_by_dtype` by the cache's dtype and in
  `FlashDecode.launches_by_q_dtype` by both) or raise."""
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


# kernel launches, in all, by cache dtype and by (q dtype, cache dtype) (the
# plain version counts none)
FlashDecode.launches = 0
FlashDecode.launches_by_dtype = NewLaunchCounts()
FlashDecode.launches_by_q_dtype = NewQLaunchCounts()


def SupportedShape(max_len: int, page_size: int) -> bool:
  """Whether a [B, max_len, N, H] cache can take the paged path."""
  return page_size > 0 and max_len % page_size == 0 and max_len >= page_size
