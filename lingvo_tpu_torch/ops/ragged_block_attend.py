"""Packed-token ragged paged attention (port of lingvo_tpu/ops/ragged_block_attend.py).

One op serves every row shape of the continuous-batching step: the batch
axis is a PACKED TOKEN axis. Token t belongs to block-table row
`row_of[t]` and attends over that row's KV slots [0, q_end[t]), so a
decode row is one token, a prefill chunk several tokens with ascending
`q_end` (causal within the chunk for free), and `q_end[t] == 0` marks a
padding token whose output is exactly 0. q arrives PRE-SCALED. Tree rows
add a 64-bit in-step ancestor mask (`q_start`, `anc_lo`, `anc_hi`); chain
rows carry the sentinel -1/-1, which keeps every column visible.

Layout contract (the serving engine maintains it): a row's logical slot s
lives at pool page `block_tables[row, s // P]`, offset `s % P`; each
token's own K/V was written before the call; table entries past a row's
live pages are unspecified and must never influence the output.

Two implementations of one function:

- the CUDA kernel `ops/csrc/ragged_block_attend.cu` (tiles of up to 16
  tokens of one row, each tile's live pages read once per head and split
  across blocks for long rows; `TileSchedule` states its schedule),
  launched for CUDA tensors;
- `_PlainRaggedAttend`, a loop over pages with the reference twin's
  per-page op order (`_XlaRaggedAttend` and `flash_decode._PageAttend`),
  used for CPU tensors and as the kernel's yardstick on the card.

`RaggedAttend` picks between them by the device of the tensors it is
given, and only by that: a CUDA tensor launches the kernel or raises.

Pool storage: float32, bfloat16, or int8 with float32 scale sidecars
`k_scale`/`v_scale` [num_pages, N, page_size] (quant/kv.py). An int8
page is dequantized on read (`_DequantPages`: int8 x scale in
float32) and then goes through the float path's page step, so the
int8 op equals the float op on the pre-dequantized pool bit for bit. A
bfloat16 page is read as float32, and its probabilities are rounded to
bfloat16 before P.V, as the reference's `p.astype(v_page.dtype)` does.

q is float32, or bfloat16 under fprop_dtype=bfloat16: the reference
multiplies the widened q (`_DotF32`), sums in float32 and rounds the
output to q's dtype (`_Finish`). Each pool dtype's kernel has a
bfloat16-q instantiation that does the same, so it equals the float32-q
kernel on the widened q with its output rounded, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from lingvo_tpu_torch.ops import cuda_build
from lingvo_tpu_torch.quant import kv as kv_quant

NEG_INF = -1.0e30   # the reference's flash_attention.NEG_INF
MIN_PAGE_SIZE, MAX_PAGE_SIZE, MAX_HEAD_DIM = 8, 128, 256  # kernel limits
MAX_TOKENS = 1 << 16


# -- plain PyTorch version (the CPU path) -----------------------------------


def _PageAttend(q, k_page, v_page, keep, m, l, acc):
  """One page of online-softmax attention for every token at once.

  q: [T, N, H] (pre-scaled float32), k_page/v_page: [T, P, N, H] float32
  or bfloat16, keep: f32 [T, 1, P] (1.0 = attend), m/l: f32 [T, N, 1],
  acc: f32 [T, N, H]. The reference `_PageAttend`, batched over tokens:
  the pages are read as float32, and p is rounded to v_page's dtype
  before P.V (a no-op for float32). A masked slot gets probability
  exactly 0 and its V row is not read (replaced by 0), so stale bytes in
  dead slots, even non-finite ones, never reach acc."""
  s = torch.einsum("tnh,tpnh->tnp", q, k_page.float())
  s = torch.where(keep > 0.5, s, NEG_INF)                 # [T, N, P]
  m_cur = torch.amax(s, dim=-1, keepdim=True)             # [T, N, 1]
  m_new = torch.maximum(m, m_cur)
  # all-masked-so-far rows have m_new = NEG_INF; exp(s - m_new) would turn
  # masked entries into exp(0) = 1 (the reference's m_safe guard)
  m_safe = torch.where(m_new <= NEG_INF * 0.5, 0.0, m_new)
  p = torch.exp(s - m_safe)
  alpha = torch.exp(m - m_new)
  l_new = alpha * l + torch.sum(p, dim=-1, keepdim=True)
  v_live = torch.where(keep.transpose(1, 2)[..., None] > 0.5,
                       v_page.float(), 0.0)
  pv = torch.einsum("tnp,tpnh->tnh", p.to(v_page.dtype).float(), v_live)
  return m_new, l_new, acc * alpha + pv


def _Finish(l, acc, dtype):
  return (acc / torch.clamp(l, min=1e-20)).to(dtype)


def _AncestorOk(slot, c, lo, hi):
  """In-step ancestor visibility (the reference `_AncestorOk`).

  c = slot - q_start; bit clip(c, 0, 63) of the token's (lo | hi << 32)
  mask says whether that step column is an ancestor-or-self. Chain rows
  ship lo = hi = -1, so every bit reads 1."""
  cc = torch.clamp(c, 0, 63)
  word = torch.where(cc < 32, lo, hi).to(torch.int64) & 0xFFFFFFFF
  sh = torch.where(cc < 32, cc, cc - 32)
  return ((word >> sh) & 1) == 1


def _DequantPages(pages, scales):
  """pages [..., P, N, H] int8 + scales [..., N, P] f32 -> f32 pages: the
  reference `block_decode._DequantPages`, the one dequantize-on-read every
  int8 read goes through."""
  s = torch.swapaxes(scales.float(), -1, -2)[..., None]
  return pages.float() * s


def _PlainRaggedAttend(q, k_pool, v_pool, block_tables, row_of, q_end,
                       page_size: int, q_start, anc_lo, anc_hi,
                       k_scale=None, v_scale=None):
  """q: [T, N, H]; pools [NP, P, N, H]; tables [B, t_pages] int32;
  row_of/q_end/q_start/anc_lo/anc_hi [T] int32 -> [T, N, H]. k_scale /
  v_scale [NP, N, P]: int8 pools, dequantized page by page.

  Trip count ceil(max(q_end) / P) over per-token gathered pages; tokens
  whose horizon ends earlier see their extra pages fully masked (a no-op
  through _PageAttend, exactly as in the reference twin)."""
  t, n, h = q.shape
  np_total = k_pool.shape[0]
  t_pages = block_tables.shape[1]
  dev = q.device
  ends = q_end.to(torch.int64)
  starts, lo, hi = (x.to(torch.int64) for x in (q_start, anc_lo, anc_hi))
  max_end = int(ends.max()) if t else 0
  trip = min(max((max_end + page_size - 1) // page_size, 0), t_pages)
  tables = torch.clamp(block_tables.to(torch.int64), 0, np_total - 1)
  rows = torch.clamp(row_of.to(torch.int64), 0, tables.shape[0] - 1)
  tok_tables = tables[rows]                                 # [T, t_pages]
  m = torch.full((t, n, 1), NEG_INF, dtype=torch.float32, device=dev)
  l = torch.zeros((t, n, 1), dtype=torch.float32, device=dev)
  acc = torch.zeros((t, n, h), dtype=torch.float32, device=dev)
  offsets = torch.arange(page_size, dtype=torch.int64, device=dev)
  for j in range(trip):
    pid = tok_tables[:, j]
    slot = j * page_size + offsets                          # [P]
    causal = slot[None, :] < ends[:, None]                  # [T, P]
    ok = _AncestorOk(slot[None, :], slot[None, :] - starts[:, None],
                     lo[:, None], hi[:, None])
    keep = (causal & ok).to(torch.float32)[:, None, :]      # [T, 1, P]
    k_page, v_page = k_pool[pid], v_pool[pid]
    if k_scale is not None:
      k_page = _DequantPages(k_page, k_scale[pid])
      v_page = _DequantPages(v_page, v_scale[pid])
    m, l, acc = _PageAttend(q.float(), k_page, v_page, keep, m, l, acc)
  return _Finish(l, acc, q.dtype)


# -- pool operands ----------------------------------------------------------


# the storage dtypes of the pools and caches, by the code the CUDA kernels
# take (csrc/kv_storage.cuh `KvDtype`)
KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def CheckKvOperands(k_pool, v_pool, k_scale, v_scale) -> str:
  """Raises unless the pools share one storage dtype that the ops take,
  int8 pools come with float32 [num_pages, N, page_size] sidecars and
  other pools with none. Returns the dtype's name."""
  if (k_scale is None) != (v_scale is None):
    raise ValueError("pass k_scale and v_scale together or neither")
  if k_pool.dtype != v_pool.dtype or k_pool.dtype not in KV_DTYPES:
    raise TypeError(f"pools must share one of {list(KV_DTYPES)}, got "
                    f"{k_pool.dtype}, {v_pool.dtype}")
  if (k_pool.dtype == torch.int8) != (k_scale is not None):
    raise ValueError("int8 pools take k_scale and v_scale; float32 and "
                     "bfloat16 pools take none")
  if k_scale is not None:
    want = (k_pool.shape[0], k_pool.shape[2], k_pool.shape[1])
    for x in (k_scale, v_scale):
      if x.dtype != torch.float32 or tuple(x.shape) != want:
        raise ValueError(f"scale sidecars must be float32 {list(want)}, got "
                         f"{x.dtype} {list(x.shape)}")
  return kv_quant.DtypeName(k_pool.dtype)


def CheckAligned(name, tensors):
  """The kernels read 16 bytes at a time: raise unless every tensor is
  contiguous and starts on a 16-byte boundary."""
  for x in tensors:
    if not x.is_contiguous() or x.data_ptr() % 16:
      raise ValueError(f"{name} kernel takes contiguous tensors that start "
                       "on a 16-byte boundary")


def NewLaunchCounts() -> dict:
  """A wrapper's launches by the pools' storage dtype."""
  return {kv_quant.DtypeName(d): 0 for d in KV_DTYPES}


# the dtypes of q and of the output, by the code the CUDA kernels take
# (csrc/kv_storage.cuh `ActDtype`): float32, or bfloat16 under
# fprop_dtype=bfloat16 (q widened on load, the output rounded once)
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def CheckQDtype(name: str, q) -> int:
  """Raises TypeError unless the kernels take q's dtype; returns its
  code."""
  if q.dtype not in Q_DTYPES:
    raise TypeError(f"{name} kernel takes a float32 or bfloat16 q, got "
                    f"{q.dtype}")
  return Q_DTYPES[q.dtype]


def NewQLaunchCounts() -> dict:
  """A wrapper's launches by q's dtype, then by the pools' storage dtype:
  one count per instantiation of the kernel."""
  return {kv_quant.DtypeName(d): NewLaunchCounts() for d in Q_DTYPES}


# -- the CUDA kernel ---------------------------------------------------------


# The kernel's tile schedule (csrc/ragged_block_attend.cu): tiles of at
# most TILE_TOKENS consecutive live tokens of one row, each tile's live
# pages cut into ceil(live slots / SPLIT_SLOTS) page ranges, at most
# MAX_SPLITS and at most one per page; bfloat16 pools are never split.
TILE_TOKENS, SPLIT_SLOTS, MAX_SPLITS = 16, 64, 8
ITEM_FIELDS = ("tok0", "len", "row", "page_begin", "page_end", "split",
               "nsplit", "tile")


def TileSchedule(row_of, q_end, page_size: int, t_pages: int, num_rows: int,
                 split: bool = True):
  """The kernel's work items, int32 [items, 8] with the columns of
  ITEM_FIELDS, as its schedule kernel builds them on the card from row_of
  and q_end ([T] ints, numpy or CPU tensors).

  A tile starts at every live token (q_end > 0) whose index is a multiple
  of TILE_TOKENS, whose predecessor is padding, or whose row_of differs
  from its predecessor's, and holds the live tokens of its row up to the
  next such start: it never crosses a row_of change, and padding tokens
  belong to none. Its pages are ceil(max q_end / page_size) (at most
  t_pages); split s of nsplit owns pages [s pages // nsplit, (s + 1) pages
  // nsplit). Items are in token order, splits in order."""
  row_of = np.asarray(row_of, np.int64)
  q_end = np.asarray(q_end, np.int64)
  t = len(q_end)
  items = []
  tile = 0
  for i in range(t):
    if q_end[i] <= 0 or not (i % TILE_TOKENS == 0 or q_end[i - 1] <= 0
                             or row_of[i] != row_of[i - 1]):
      continue
    n = 1
    while (i + n < t and (i + n) % TILE_TOKENS and q_end[i + n] > 0
           and row_of[i + n] == row_of[i]):
      n += 1
    pages = min(-(-int(q_end[i:i + n].max()) // page_size), t_pages)
    want = -(-pages * page_size // SPLIT_SLOTS)
    nsplit = max(1, min(want, MAX_SPLITS, pages)) if split else 1
    row = min(max(int(row_of[i]), 0), num_rows - 1)
    for s_ in range(nsplit):
      items.append((i, n, row, s_ * pages // nsplit,
                    (s_ + 1) * pages // nsplit, s_, nsplit, tile))
    tile += 1
  return np.asarray(items, np.int32).reshape(-1, len(ITEM_FIELDS))


_lib = None   # the loaded kernel library, with its C signatures declared


def _Lib():
  global _lib
  if _lib is None:
    lib = cuda_build.Load("ragged_block_attend")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.RaggedAttend.argtypes = [vp] * 15 + [ci] * 13 + [vp]
    lib.RaggedAttend.restype = ci
    lib.RaggedSchedule.argtypes = [vp] * 2 + [ci] * 9 + [vp] * 2 + [ci, vp]
    lib.RaggedSchedule.restype = ci
    lib.RaggedAttendGeometry.argtypes = [ci] * 4 + [vp]
    lib.RaggedAttendGeometry.restype = ci
    lib.RaggedAttendErrorString.argtypes = [ci]
    lib.RaggedAttendErrorString.restype = ctypes.c_char_p
    _lib = lib
  return _lib


def _Raise(lib, what, rc):
  if rc != 0:
    raise RuntimeError(f"{what} failed: "
                       + lib.RaggedAttendErrorString(rc).decode())


def KernelGeometry(head_dim: int, page_size: int, t_pages: int,
                   kv_dtype: str = "float32"):
  """(threads, shared bytes per block, resident blocks per SM, blocks of
  a launch) of the attention kernel at these shapes on the current
  device."""
  lib = _Lib()
  geo = (ctypes.c_int * 4)()
  code = KV_DTYPES[getattr(torch, kv_dtype)]
  _Raise(lib, "RaggedAttendGeometry", lib.RaggedAttendGeometry(
      head_dim, page_size, t_pages, code, geo))
  return tuple(geo)


@functools.lru_cache(maxsize=None)
def _GridBlocks(device_index: int, head_dim: int, page_size: int,
                t_pages: int, kv_dtype: str) -> int:
  """The persistent grid of a launch at these shapes on that card (asked
  once: the occupancy query costs host time on every serving step)."""
  with torch.cuda.device(device_index):
    return KernelGeometry(head_dim, page_size, t_pages, kv_dtype)[3]


def _Scratch(t, n, h, bf16, device):
  """The kernel's scratch in one allocation: (the buffer, and the
  addresses of the schedule's workspace, int32 [2 + 8 t MAX_SPLITS], the
  split counters, int32 [t n], and, unless bf16 (no splits), the splits'
  partial (acc, m, l), float32 [t MAX_SPLITS n (h + 4)]), each on a
  16-byte boundary."""
  ws_n = -(-(2 + len(ITEM_FIELDS) * t * MAX_SPLITS) // 4) * 4
  counters_n = -(-(t * n) // 4) * 4
  part_n = 0 if bf16 else t * MAX_SPLITS * n * (h + 4)
  buf = torch.empty((ws_n + counters_n + part_n,), dtype=torch.int32,
                    device=device)
  base = buf.data_ptr()
  return (buf, base, base + 4 * ws_n,
          None if bf16 else base + 4 * (ws_n + counters_n))


def DeviceSchedule(row_of, q_end, page_size: int, t_pages: int,
                   num_rows: int, num_heads: int, split: bool = True):
  """The work items of the card's schedule kernel for CUDA row_of and
  q_end, as numpy [items, 8] (the columns of ITEM_FIELDS): what
  `TileSchedule` computes on the host. Runs the schedule kernel alone,
  outside the launch count."""
  t = row_of.shape[0]
  buf, ws, counters, _ = _Scratch(t, num_heads, 4, True, row_of.device)
  lib = _Lib()
  stream = torch.cuda.current_stream(row_of.device).cuda_stream
  _Raise(lib, "RaggedSchedule", lib.RaggedSchedule(
      row_of.data_ptr(), q_end.data_ptr(), t, num_rows, t_pages, page_size,
      TILE_TOKENS, SPLIT_SLOTS, MAX_SPLITS, int(split), num_heads, ws,
      counters, t * MAX_SPLITS, stream))
  ws = buf.cpu().numpy()
  return ws[2:2 + len(ITEM_FIELDS) * ws[0]].reshape(-1, len(ITEM_FIELDS))


def KernelLimitError(head_dim: int, page_size: int) -> str | None:
  """Why the CUDA kernel cannot take this shape, or None if it can: a
  head dim that is a multiple of 4 up to MAX_HEAD_DIM, page_size in
  [MIN_PAGE_SIZE, MAX_PAGE_SIZE]. The wrapper raises it; the attention
  gate reads it."""
  if head_dim % 4 or not 0 < head_dim <= MAX_HEAD_DIM:
    return (f"head dim {head_dim}: the RaggedAttend kernel takes a multiple "
            f"of 4 up to {MAX_HEAD_DIM}")
  if not MIN_PAGE_SIZE <= page_size <= MAX_PAGE_SIZE:
    return (f"page_size {page_size} outside the RaggedAttend kernel's "
            f"[{MIN_PAGE_SIZE}, {MAX_PAGE_SIZE}]")
  return None


def _CudaRaggedAttend(q, k_pool, v_pool, block_tables, row_of, q_end,
                      page_size, q_start, anc_lo, anc_hi, k_scale, v_scale,
                      kv_dtype):
  t, n, h = q.shape
  np_total, p = k_pool.shape[0], k_pool.shape[1]
  b, t_pages = block_tables.shape
  q_code = CheckQDtype("RaggedAttend", q)
  if k_pool.shape != v_pool.shape or k_pool.shape[2:] != (n, h):
    raise ValueError(f"pool shapes {tuple(k_pool.shape)}, "
                     f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
  if p != page_size:
    raise ValueError(f"page_size {page_size}, pool pages of {p}")
  reason = KernelLimitError(h, p)
  if reason is not None:
    raise ValueError(reason)
  if t > MAX_TOKENS:
    raise ValueError(f"{t} packed tokens above the kernel's {MAX_TOKENS}")
  ints = [block_tables, row_of, q_end, q_start, anc_lo, anc_hi]
  for name, x in zip(("block_tables", "row_of", "q_end", "q_start",
                      "anc_lo", "anc_hi"), ints):
    if x.dtype != torch.int32:
      raise TypeError(f"{name} must be int32, got {x.dtype}")
    if name != "block_tables" and tuple(x.shape) != (t,):
      raise ValueError(f"{name} shape {tuple(x.shape)} != ({t},)")
  scales = [] if k_scale is None else [k_scale, v_scale]
  for x in [q, k_pool, v_pool] + ints + scales:
    if x.device != q.device:
      raise ValueError(f"tensor on {x.device}, q on {q.device}")
  CheckAligned("RaggedAttend", [q, k_pool, v_pool] + ints + scales)
  out = torch.empty_like(q)
  if t == 0:
    return out
  lib = _Lib()
  _, ws, counters, part = _Scratch(t, n, h, kv_dtype == "bfloat16", q.device)
  blocks = _GridBlocks(q.device.index, h, p, t_pages, kv_dtype)
  stream = torch.cuda.current_stream(q.device).cuda_stream
  rc = lib.RaggedAttend(
      q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
      None if k_scale is None else k_scale.data_ptr(),
      None if v_scale is None else v_scale.data_ptr(),
      block_tables.data_ptr(), row_of.data_ptr(), q_end.data_ptr(),
      q_start.data_ptr(), anc_lo.data_ptr(), anc_hi.data_ptr(),
      out.data_ptr(), ws, counters, part, t, n, h, np_total, p, b,
      t_pages, TILE_TOKENS, SPLIT_SLOTS, MAX_SPLITS,
      KV_DTYPES[k_pool.dtype], q_code, blocks, stream)
  _Raise(lib, "RaggedAttend kernel launch", rc)
  RaggedAttend.launches += 1
  RaggedAttend.launches_by_dtype[kv_dtype] += 1
  RaggedAttend.launches_by_q_dtype[kv_quant.DtypeName(q.dtype)][kv_dtype] += 1
  return out


# -- public entry ------------------------------------------------------------


def RaggedAttend(q, k_pool, v_pool, block_tables, row_of, q_end, *,
                 page_size: int, k_scale=None, v_scale=None,
                 q_start=None, anc_lo=None, anc_hi=None):
  """Packed-token ragged paged attention — decode, prefill and tree rows
  in one call.

  q: [T, N, H] packed query tokens, already scaled, float32 or bfloat16
  (the output takes q's dtype); every token's K/V was written to the pool
  before the call.
  k_pool/v_pool: [num_pages, page_size, N, H] page pools, float32,
  bfloat16 or int8.
  block_tables: [B, pages_per_seq] int32 physical page ids.
  row_of / q_end: [T] int32 row of each token and one past its highest
  attendable slot (0 = padding token, output 0).
  k_scale/v_scale: [num_pages, N, page_size] float32 sidecars of int8
  pools (both, and only for int8 pools).
  q_start/anc_lo/anc_hi: [T] int32 tree operands, all three or none
  (none = chain semantics).

  CPU tensors run the plain version; CUDA tensors launch the kernel for
  q's and the pools' dtypes (counting one launch in
  `RaggedAttend.launches`, in `RaggedAttend.launches_by_dtype` by the
  pools' dtype and in `RaggedAttend.launches_by_q_dtype` by both) or
  raise."""
  kv_dtype = CheckKvOperands(k_pool, v_pool, k_scale, v_scale)
  tree_args = (q_start is not None, anc_lo is not None, anc_hi is not None)
  if any(tree_args) and not all(tree_args):
    raise ValueError("pass q_start, anc_lo and anc_hi together or none")
  if q.ndim != 3:
    raise ValueError(f"q must be [T, N, H], got {tuple(q.shape)}")
  if q_start is None:   # chain semantics: the -1/-1 sentinel sees every slot
    t = q.shape[0]
    q_start = torch.zeros((t,), dtype=torch.int32, device=q.device)
    anc_lo = anc_hi = torch.full((t,), -1, dtype=torch.int32, device=q.device)
  if q.device.type == "cpu":
    return _PlainRaggedAttend(q, k_pool, v_pool, block_tables, row_of, q_end,
                              page_size, q_start, anc_lo, anc_hi,
                              k_scale=k_scale, v_scale=v_scale)
  if q.device.type != "cuda":
    raise ValueError(f"RaggedAttend runs on cpu or cuda, not {q.device}")
  return _CudaRaggedAttend(q, k_pool, v_pool, block_tables, row_of, q_end,
                           page_size, q_start, anc_lo, anc_hi, k_scale,
                           v_scale, kv_dtype)


# kernel launches, in all, by pool dtype and by (q dtype, pool dtype) (the
# plain version counts none)
RaggedAttend.launches = 0
RaggedAttend.launches_by_dtype = NewLaunchCounts()
RaggedAttend.launches_by_q_dtype = NewQLaunchCounts()
