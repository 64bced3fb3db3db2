"""Ragged row descriptors for the packed serving step (port of lingvo_tpu/core/ragged.py).

One serving step packs every row's tokens on a single token axis of
static width T: a decode row contributes 1 token, a prefill row a chunk.
`RaggedRows` is the routing metadata of that pack:

- the TOKEN view (`row_of`, `col_of`, `pos`, `valid`, `pos_ids`,
  `anc_lo`, `anc_hi`, all [T]): each token scatters its K/V through its
  row's block table at global slot `pos` and attends over its own prefix;
  padding tokens (`valid` False) write to the trash page.
- the ROW view (`row_q_pos`, `row_len` [B]; `row_cols`, `col_parent`
  [B, wmax]).

`BuildRaggedRows` is the reference's host-side numpy builder, unchanged
(tree rows included: `pos_ids` and the 64-bit ancestor masks); `ToTorch`
moves its output to the device the model runs on.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RaggedRows(NamedTuple):
  """Per-token + per-row routing for one packed ragged step.

  Members are numpy arrays as built, torch tensors once on the device.
  T = packed token width, B = engine slots, wmax = widest row."""
  row_of: object     # [T] int32  slot index of each token
  col_of: object     # [T] int32  token's column within its row
  pos: object        # [T] int32  global kv slot the token writes/reads
  valid: object      # [T] bool   False = padding token
  row_q_pos: object  # [B] int32  row's first-token global position
  row_len: object    # [B] int32  tokens the row carries this step
  row_cols: object   # [B, wmax] int32  token-axis gather indices
  pos_ids: object    # [T] int32  logical position (rotary); == pos on chains
  anc_lo: object     # [T] int32  in-step ancestor bitmask, columns 0..31
  anc_hi: object     # [T] int32  in-step ancestor bitmask, columns 32..63
  col_parent: object  # [B, wmax] int32  parent column (-1 = row state)


MAX_TREE_COLS = 64  # anc_lo/anc_hi bit budget


def TreeDepths(parents) -> np.ndarray:
  """Draft-node depths from DFS parent pointers (-1 = child of the root)."""
  parents = np.asarray(parents, np.int32)
  depth = np.zeros(parents.shape, np.int32)
  for j, p in enumerate(parents):
    assert p < j, (j, p)
    depth[j] = 1 if p < 0 else depth[p] + 1
  return depth


def TreeAncestorMasks(parents) -> tuple[np.ndarray, np.ndarray]:
  """Per-COLUMN ancestor bitmasks (lo, hi) from DFS parent pointers.

  Column 0 is the root; draft j lives at column j+1. Bit c of column
  mask[j] is set iff step column c is an ancestor-or-self of column j."""
  parents = np.asarray(parents, np.int32)
  r = parents.shape[0]
  assert r + 1 <= MAX_TREE_COLS, (r, MAX_TREE_COLS)
  masks = np.zeros((r + 1,), np.int64)
  masks[0] = 1
  for j, p in enumerate(parents):
    col = j + 1
    masks[col] = masks[p + 1] | (np.int64(1) << col)
  lo = (masks & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
  hi = ((masks >> 32) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
  return lo, hi


def BuildRaggedRows(row_lens, row_q_pos, t: int, wmax: int,
                    row_parents=None) -> RaggedRows:
  """Host-side builder: per-row (q_pos, len) -> a packed RaggedRows.

  row_lens/row_q_pos: [B] ints. Rows are packed in slot order; the caller
  guarantees sum(row_lens) <= t and max(row_lens) <= wmax. Returns numpy
  arrays. row_parents: optional {slot: [row_len-1] parent pointers} for
  TREE rows; other rows are chains (pos_ids == pos, masks -1)."""
  row_lens = np.asarray(row_lens, np.int32)
  row_q_pos = np.asarray(row_q_pos, np.int32)
  b = row_lens.shape[0]
  assert int(row_lens.sum()) <= t, (row_lens, t)
  assert int(row_lens.max(initial=0)) <= wmax, (row_lens, wmax)
  row_of = np.zeros((t,), np.int32)
  col_of = np.zeros((t,), np.int32)
  pos = np.zeros((t,), np.int32)
  valid = np.zeros((t,), bool)
  row_cols = np.zeros((b, wmax), np.int32)
  pos_ids = np.zeros((t,), np.int32)
  anc_lo = np.full((t,), -1, np.int32)
  anc_hi = np.full((t,), -1, np.int32)
  col_parent = np.tile(np.arange(-1, wmax - 1, dtype=np.int32), (b, 1))
  cursor = 0
  for i in range(b):
    n = int(row_lens[i])
    if n == 0:
      continue
    sl = slice(cursor, cursor + n)
    row_of[sl] = i
    col_of[sl] = np.arange(n)
    pos[sl] = row_q_pos[i] + np.arange(n)
    valid[sl] = True
    row_cols[i, :n] = np.arange(cursor, cursor + n)
    parents = None if row_parents is None else row_parents.get(i)
    if parents is not None:
      parents = np.asarray(parents, np.int32)
      assert parents.shape == (n - 1,), (parents.shape, n)
      depths = np.concatenate([[0], TreeDepths(parents)]).astype(np.int32)
      lo, hi = TreeAncestorMasks(parents)
      pos_ids[sl] = row_q_pos[i] + depths
      anc_lo[sl] = lo
      anc_hi[sl] = hi
      col_parent[i, 1:n] = parents + 1
    else:
      pos_ids[sl] = pos[sl]
    cursor += n
  return RaggedRows(row_of=row_of, col_of=col_of, pos=pos, valid=valid,
                    row_q_pos=row_q_pos, row_len=row_lens,
                    row_cols=row_cols, pos_ids=pos_ids,
                    anc_lo=anc_lo, anc_hi=anc_hi, col_parent=col_parent)


def ToTorch(rows: RaggedRows, device) -> RaggedRows:
  """The numpy descriptor as contiguous tensors on `device` (int32 index
  members, bool `valid`), ready for RaggedStep."""
  return RaggedRows(*(torch.as_tensor(np.ascontiguousarray(m)).to(device)
                      for m in rows))
