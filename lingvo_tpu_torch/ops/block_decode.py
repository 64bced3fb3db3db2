"""Block-table paged decode attention over a global KV page pool (port of lingvo_tpu/ops/block_decode.py).

The attention read of the legacy serving step (`MultiHeadedAttention
.PagedStep`). K/V live in a global pool of pages `[num_pages, page_size,
N, H]`; row b's logical slot s lives at pool page `block_tables[b, s //
page_size]`, offset `s % page_size`. Table entries past a row's live
pages are unspecified (freed pages may already belong to another row) and
never influence the output. q arrives PRE-SCALED.

- `BlockDecode`: one query per row over slots [0, seq_lens[b]); a row with
  seq_len 0 is inactive and returns exactly 0. Two implementations of one
  function: the CUDA kernel `ops/csrc/block_decode.cu` (a thread-block
  cluster of `NumSplits` blocks per (row, head), each block taking a run
  of the row's live pages, merged in the same launch), launched for CUDA
  tensors, and `_PlainBlockDecode`, the reference twin `_XlaBlockDecode`'s
  loop over the batch's live pages through the shared page step
  (`ragged_block_attend._PageAttend`), used for CPU tensors and as the
  kernel's yardstick. A CUDA tensor launches the kernel or raises.
  `SplitPages` and `SplitMaxima` are the kernel's split geometry on the
  CPU: which pages each block of a row takes, and the maxima a bfloat16
  pool's probabilities are rounded against; `KernelLimitError` says
  which shapes the kernel takes (the attention gate reads it too).
- `BlockPrefill`: C chunk queries per row, causal within the chunk, for
  the legacy engine's mixed steps. Plain PyTorch on every device: the
  reference computes it outside any Pallas kernel too.
- `GatherPages` / `GatherScales`: the dense [B, T * P, N, H] view of a
  row's pages and the [B, T * P, N] view of its scale sidecars.

Pools are float32, bfloat16, or int8 with float32 scale sidecars
`k_scale`/`v_scale` [num_pages, N, page_size] (quant/kv.py). Every read
of an int8 page goes through `_DequantPages` before the float page step,
so the int8 op equals the float op on the pre-dequantized pool bit for
bit; a bfloat16 page's probabilities are rounded to bfloat16 before P.V,
as in the reference.

q is float32 or bfloat16 (fprop_dtype=bfloat16): both ops multiply the
widened q, sum in float32 and return q's dtype, as the reference's
`_DotF32` and `_Finish(l, acc, q.dtype)`; the kernel has a bfloat16-q
instantiation for each pool dtype.
"""

from __future__ import annotations

import ctypes

import torch

from lingvo_tpu_torch.ops import cuda_build
from lingvo_tpu_torch.ops.ragged_block_attend import (
    KV_DTYPES, NEG_INF, CheckAligned, CheckKvOperands, CheckQDtype,
    NewLaunchCounts, NewQLaunchCounts, _DequantPages, _Finish, _PageAttend)
from lingvo_tpu_torch.quant import kv as kv_quant

MAX_PAGE_SIZE = 128   # kernel limits
# head dims: powers of two whose slot row is at least one 16-byte copy
HEAD_DIMS = (4, 8, 16, 32, 64, 128)
MIN_ROW_BYTES = 16
MAX_SPLITS = 8        # blocks of a (row, head): the portable cluster size
SPLIT_SLOTS = 64      # table slots a split is sized for
MAX_CTA_SLOTS = 8192  # slots whose scores one block holds


def KernelLimitError(head_dim: int, page_size: int, dtype=torch.float32,
                     t_pages: int | None = None) -> str | None:
  """Why the CUDA kernel cannot take this shape, or None if it can: head
  dim in HEAD_DIMS with a slot row of at least 16 bytes (8 for bfloat16,
  16 for int8), page_size 1..MAX_PAGE_SIZE, a float32, bfloat16 or int8
  pool, and (given the table width) at most MAX_CTA_SLOTS slots of scores
  per block. The wrapper raises it; the attention gate reads it."""
  if dtype not in KV_DTYPES:
    return ("BlockDecode kernel takes float32, bfloat16 or int8 pools, "
            f"not {dtype}")
  if head_dim not in HEAD_DIMS or head_dim * dtype.itemsize < MIN_ROW_BYTES:
    return (f"head dim {head_dim}: the {dtype} BlockDecode kernel takes one "
            f"of {HEAD_DIMS} with a slot row of at least {MIN_ROW_BYTES} "
            "bytes")
  if not 1 <= page_size <= MAX_PAGE_SIZE:
    return (f"page_size {page_size} outside the BlockDecode kernel's "
            f"[1, {MAX_PAGE_SIZE}]")
  if t_pages is not None:
    slots = CtaSlots(t_pages, page_size, NumSplits(t_pages, page_size))
    if slots > MAX_CTA_SLOTS:
      return (f"a table of {t_pages} pages of {page_size} gives a block "
              f"{slots} slots of scores, above the kernel's {MAX_CTA_SLOTS}")
  return None


def NumSplits(t_pages: int, page_size: int) -> int:
  """The kernel's blocks per (row, head), one cluster: from the table's
  width and the page size alone (never seq_lens, so no host sync), about
  SPLIT_SLOTS table slots a block, at most MAX_SPLITS and t_pages."""
  want = -(-t_pages * page_size // SPLIT_SLOTS)
  return max(1, min(MAX_SPLITS, t_pages, want))


def CtaSlots(t_pages: int, page_size: int, splits: int) -> int:
  """The most slots one block of `splits` takes: ceil(t_pages / splits)
  whole pages."""
  return -(-t_pages // splits) * page_size


def SplitPages(seq_len: int, page_size: int, t_pages: int, splits: int):
  """The kernel's split of one row: [(first page, end page)] of each of
  the `splits` blocks, in rank order. The row's live pages,
  min(ceil(seq_len / P), t_pages) (none for seq_len <= 0), are cut into
  contiguous runs [s live / S, (s + 1) live / S); a run may be empty."""
  live = min(-(-seq_len // page_size), t_pages) if seq_len > 0 else 0
  return [(s * live // splits, (s + 1) * live // splits)
          for s in range(splits)]


def SplitMaxima(page_max, runs):
  """The maxima a bfloat16 pool's probabilities are rounded against, as
  the kernel computes them: page_max [live] float32, the max score of
  each live page of a row; runs, `SplitPages`. Block s knows its own
  pages' maxima and, after the cluster's exchange, every block's max:
  page j of block s rounds against max(the maxima of the blocks before s,
  the running max of s's pages through j). Returns (M [live], the row's
  max)."""
  neg = torch.tensor(NEG_INF, dtype=torch.float32)
  totals = [torch.max(page_max[a:b]) if b > a else neg for a, b in runs]
  m = torch.empty_like(page_max)
  before = neg
  for (a, b), total in zip(runs, totals):
    if b > a:
      m[a:b] = torch.maximum(before, torch.cummax(page_max[a:b], 0).values)
    before = torch.maximum(before, total)
  return m, before


def GatherPages(pool, block_tables):
  """pool [NP, P, N, H] + tables [B, T] -> dense [B, T*P, N, H]: row b's
  logical slots in order (out-of-range entries clamp; callers mask dead
  slots)."""
  b, t_pages = block_tables.shape
  np_total, page, n, h = pool.shape
  pages = pool[torch.clamp(block_tables.long(), 0, np_total - 1)]
  return pages.reshape(b, t_pages * page, n, h)


def GatherScales(scales, block_tables):
  """sidecar [NP, N, P] + tables [B, T] -> dense [B, T*P, N]: the scales
  in logical-slot order, aligned with `GatherPages`."""
  b, t_pages = block_tables.shape
  np_total, n, page = scales.shape
  s = scales[torch.clamp(block_tables.long(), 0, np_total - 1)]  # [B,T,N,P]
  return torch.swapaxes(s, 2, 3).reshape(b, t_pages * page, n)


# -- plain PyTorch version (the CPU path) -----------------------------------


def _PlainBlockDecode(q, k_pool, v_pool, block_tables, seq_lens,
                      page_size: int, k_scale=None, v_scale=None):
  """q: [B, N, H]; pools [NP, P, N, H]; tables [B, T] int32; seq_lens [B]
  int32 -> [B, N, H]. k_scale / v_scale [NP, N, P]: int8 pools.

  Trip count ceil(max(seq_lens) / P), at most T; rows whose length falls
  short of the batch max see their extra pages fully masked (a no-op
  through _PageAttend, as in the reference twin)."""
  b, n, h = q.shape
  np_total, page = k_pool.shape[0], k_pool.shape[1]
  if page != page_size:
    raise ValueError(f"pool pages of {page}, page_size {page_size}")
  t_pages = block_tables.shape[1]
  dev = q.device
  lens = seq_lens.to(torch.int64)
  max_len = int(lens.max()) if b else 0
  trip = min(max((max_len + page_size - 1) // page_size, 0), t_pages)
  tables = torch.clamp(block_tables.to(torch.int64), 0, np_total - 1)
  m = torch.full((b, n, 1), NEG_INF, dtype=torch.float32, device=dev)
  l = torch.zeros((b, n, 1), dtype=torch.float32, device=dev)
  acc = torch.zeros((b, n, h), dtype=torch.float32, device=dev)
  offsets = torch.arange(page_size, dtype=torch.int64, device=dev)
  for j in range(trip):
    pid = tables[:, j]
    slot = j * page_size + offsets                              # [P]
    keep = (slot[None, :] < lens[:, None]).float()[:, None, :]  # [B, 1, P]
    k_page, v_page = k_pool[pid], v_pool[pid]
    if k_scale is not None:
      k_page = _DequantPages(k_page, k_scale[pid])
      v_page = _DequantPages(v_page, v_scale[pid])
    m, l, acc = _PageAttend(q.float(), k_page, v_page, keep, m, l, acc)
  return _Finish(l, acc, q.dtype)


# -- the CUDA kernel ---------------------------------------------------------


_lib = None   # the loaded kernel library, with its C signatures declared


def _Lib():
  global _lib
  if _lib is None:
    lib = cuda_build.Load("block_decode")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.BlockDecode.argtypes = [vp] * 8 + [ci] * 9 + [vp]
    lib.BlockDecode.restype = ci
    lib.BlockDecodeGeometry.argtypes = [ci] * 5 + [vp]
    lib.BlockDecodeGeometry.restype = ci
    lib.BlockDecodeErrorString.argtypes = [ci]
    lib.BlockDecodeErrorString.restype = ctypes.c_char_p
    _lib = lib
  return _lib


def _CudaBlockDecode(q, k_pool, v_pool, block_tables, seq_lens, page_size,
                     k_scale, v_scale, kv_dtype):
  b, n, h = q.shape
  np_total, p = k_pool.shape[0], k_pool.shape[1]
  t_pages = block_tables.shape[1]
  q_code = CheckQDtype("BlockDecode", q)
  if k_pool.shape != v_pool.shape or k_pool.shape[2:] != (n, h):
    raise ValueError(f"pool shapes {tuple(k_pool.shape)}, "
                     f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
  if p != page_size:
    raise ValueError(f"page_size {page_size}, pool pages of {p}")
  if block_tables.shape[0] != b or t_pages < 1:
    raise ValueError(f"block_tables {tuple(block_tables.shape)} for {b} rows")
  reason = KernelLimitError(h, p, k_pool.dtype, t_pages)
  if reason is not None:
    raise ValueError(reason)
  if b * n > 65535:
    raise ValueError(f"B x N = {b * n} rows exceed the kernel's grid (65535)")
  for name, x in (("block_tables", block_tables), ("seq_lens", seq_lens)):
    if x.dtype != torch.int32:
      raise TypeError(f"{name} must be int32, got {x.dtype}")
  if tuple(seq_lens.shape) != (b,):
    raise ValueError(f"seq_lens shape {tuple(seq_lens.shape)} != ({b},)")
  tensors = [q, k_pool, v_pool, block_tables, seq_lens]
  tensors += [] if k_scale is None else [k_scale, v_scale]
  for x in tensors:
    if x.device != q.device:
      raise ValueError(f"tensor on {x.device}, q on {q.device}")
  CheckAligned("BlockDecode", tensors)
  out = torch.empty_like(q)
  if b == 0:
    return out
  lib = _Lib()
  stream = torch.cuda.current_stream(q.device).cuda_stream
  rc = lib.BlockDecode(
      q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
      None if k_scale is None else k_scale.data_ptr(),
      None if v_scale is None else v_scale.data_ptr(),
      block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), b, n, h,
      np_total, p, t_pages, KV_DTYPES[k_pool.dtype], q_code,
      NumSplits(t_pages, p), stream)
  if rc != 0:
    raise RuntimeError("BlockDecode kernel launch failed: "
                       + lib.BlockDecodeErrorString(rc).decode())
  BlockDecode.launches += 1
  BlockDecode.launches_by_dtype[kv_dtype] += 1
  BlockDecode.launches_by_q_dtype[kv_quant.DtypeName(q.dtype)][kv_dtype] += 1
  return out


def KernelGeometry(head_dim: int, page_size: int, t_pages: int,
                   dtype=torch.float32) -> dict:
  """The kernel's launch geometry on the current device: splits (the
  cluster size), threads and dynamic shared bytes per block, slots of a
  warp's tile, resident blocks per SM."""
  splits = NumSplits(t_pages, page_size)
  geo = (ctypes.c_int * 4)()
  lib = _Lib()
  rc = lib.BlockDecodeGeometry(head_dim, page_size, t_pages, splits,
                               KV_DTYPES[dtype], geo)
  if rc != 0:
    raise RuntimeError("BlockDecodeGeometry failed: "
                       + lib.BlockDecodeErrorString(rc).decode())
  return dict(splits=splits, threads=geo[0], smem_bytes=geo[1],
              tile_slots=geo[2], blocks_per_sm=geo[3])


# -- public entries ----------------------------------------------------------


def BlockDecode(q, k_pool, v_pool, block_tables, seq_lens, *, page_size: int,
                k_scale=None, v_scale=None):
  """Single-query block-table paged decode attention.

  q: [B, 1, N, H], the newest query per row, ALREADY scaled, float32 or
  bfloat16 (the output takes q's dtype; its K/V was written to the pool
  first, at slot seq_len - 1).
  k_pool/v_pool: [num_pages, page_size, N, H] page pools, float32,
  bfloat16 or int8.
  block_tables: [B, pages_per_seq] int32 physical page ids.
  seq_lens: [B] int32 live-slot counts; 0 marks an inactive row (output 0).
  k_scale/v_scale: [num_pages, N, page_size] float32 sidecars of int8
  pools (both, and only for int8 pools).
  Returns [B, 1, N, H].

  CPU tensors run the plain version; CUDA tensors launch the kernel for
  q's and the pools' dtypes (counting one launch in `BlockDecode.launches`,
  in `BlockDecode.launches_by_dtype` by the pools' dtype and in
  `BlockDecode.launches_by_q_dtype` by both) or raise."""
  kv_dtype = CheckKvOperands(k_pool, v_pool, k_scale, v_scale)
  if q.ndim != 4 or q.shape[1] != 1:
    raise ValueError(f"q must be [B, 1, N, H], got {tuple(q.shape)}")
  q3 = q[:, 0]
  if q.device.type == "cpu":
    out = _PlainBlockDecode(q3, k_pool, v_pool, block_tables, seq_lens,
                            page_size, k_scale=k_scale, v_scale=v_scale)
  elif q.device.type == "cuda":
    out = _CudaBlockDecode(q3.contiguous(), k_pool, v_pool, block_tables,
                           seq_lens, page_size, k_scale, v_scale, kv_dtype)
  else:
    raise ValueError(f"BlockDecode runs on cpu or cuda, not {q.device}")
  return out[:, None]


# kernel launches, in all, by pool dtype and by (q dtype, pool dtype) (the
# plain version counts none)
BlockDecode.launches = 0
BlockDecode.launches_by_dtype = NewLaunchCounts()
BlockDecode.launches_by_q_dtype = NewQLaunchCounts()


def BlockPrefill(q, k_pool, v_pool, block_tables, q_pos, in_len, *,
                 page_size: int, k_scale=None, v_scale=None):
  """Multi-query paged attention for chunked-prefill steps.

  q: [B, C, N, H] pre-scaled chunk queries; query c of row b sits at slot
  q_pos[b] + c and attends its row's slots <= q_pos[b] + c (the chunk's
  K/V were written to the pool first). in_len: [B] int32 valid-query
  counts; queries c >= in_len[b] return 0. One loop over the batch's live
  pages with an online softmax, as the reference. A slot at or past
  q_pos + in_len is masked for every query of its row and its V row is
  not read. k_scale/v_scale: [NP, N, P] float32 sidecars of int8 pools,
  dequantized on read; bfloat16 pools round p to bfloat16 before P.V.
  -> [B, C, N, H]."""
  CheckKvOperands(k_pool, v_pool, k_scale, v_scale)
  b, c, n, h = q.shape
  np_total, page = k_pool.shape[0], k_pool.shape[1]
  if page != page_size:
    raise ValueError(f"pool pages of {page}, page_size {page_size}")
  t_pages = block_tables.shape[1]
  dev = q.device
  q_pos = q_pos.to(torch.int64)
  in_len = in_len.to(torch.int64)
  tables = torch.clamp(block_tables.to(torch.int64), 0, np_total - 1)
  cols = torch.arange(c, dtype=torch.int64, device=dev)
  pos = q_pos[:, None] + cols[None]                             # [B, C]
  valid = cols[None] < in_len[:, None]                          # [B, C]
  end = q_pos + in_len                                          # [B]
  max_end = int(end.max()) if b else 0
  trip = min(max((max_end + page_size - 1) // page_size, 0), t_pages)
  qf = q.float()
  m = torch.full((b, c, n, 1), NEG_INF, dtype=torch.float32, device=dev)
  l = torch.zeros((b, c, n, 1), dtype=torch.float32, device=dev)
  acc = torch.zeros((b, c, n, h), dtype=torch.float32, device=dev)
  offsets = torch.arange(page_size, dtype=torch.int64, device=dev)
  for j in range(trip):
    pid = tables[:, j]
    k_page, v_page = k_pool[pid], v_pool[pid]                   # [B, P, N, H]
    if k_scale is not None:
      k_page = _DequantPages(k_page, k_scale[pid])
      v_page = _DequantPages(v_page, v_scale[pid])
    slot = j * page_size + offsets                              # [P]
    keep = ((slot[None, None, :] <= pos[:, :, None])
            & valid[:, :, None])                                # [B, C, P]
    s = torch.einsum("bcnh,bpnh->bcnp", qf, k_page.float())
    s = torch.where(keep[:, :, None, :], s, NEG_INF)
    m_cur = torch.amax(s, dim=-1, keepdim=True)                 # [B, C, N, 1]
    m_new = torch.maximum(m, m_cur)
    m_safe = torch.where(m_new <= NEG_INF * 0.5, 0.0, m_new)
    p = torch.exp(s - m_safe)
    alpha = torch.exp(m - m_new)
    l = alpha * l + torch.sum(p, dim=-1, keepdim=True)
    live = (slot[None, :] < end[:, None])[:, :, None, None]     # [B, P, 1, 1]
    v_live = torch.where(live, v_page.float(), 0.0)
    acc = alpha * acc + torch.einsum(
        "bcnp,bpnh->bcnh", p.to(v_page.dtype).float(), v_live)
    m = m_new
  return _Finish(l, acc, q.dtype)
