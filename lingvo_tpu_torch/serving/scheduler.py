"""Continuous-batching request scheduler, fifo subset (port of lingvo_tpu/serving/scheduler.py).

Owns the host-side serving state machine: a FIFO of waiting requests, B
decode slots and the page allocator. Each engine iteration is
admit -> build -> (device step) -> commit:

- `Admit` moves queued requests into free slots while the allocator can
  reserve their WHOLE worst-case footprint (ceil((prompt + max_new) /
  page_size) pages) up front, so an admitted sequence never runs out of
  pages mid-flight; pool pressure shows up only as queueing. Head-of-line
  blocking is intentional (no starvation of long requests). A pure
  O(1)-mixer stack (`needs_kv_pages=False`) takes no pages: a free slot is
  admission. With a `state_pool`, admission acquires the slot's mixer
  state and retirement releases it.
- `BuildRaggedStep` packs every live slot into ONE [T]-token step: decode
  rows first (1 token each), then prefill rows take the leftover budget in
  slot order. `BuildStep` (the legacy step mode) lays the slots out as
  [B, C] rows instead: C = 1 when every live row decodes, else C =
  prefill_chunk and each prefilling row takes its next chunk.
- `CommitRaggedStep` / `CommitStep` fold the sampled tokens back in:
  advance prompt cursors, turn finished prefills into decoders (their
  first generated token is the draw at the last prompt token), append
  decode tokens, retire sequences on max_new/EOS and free their slot and
  pages.
- Every step carries each row's sampling stream: `row_seeds` (the
  request's seed) and `row_pos` (its tokens generated so far), so a
  request's draw at output position t is a function of (engine seed,
  request seed, t) alone, whichever slot or step decodes it.
- `Cancel` retires a queued request at once and marks an admitted one
  cancelled; `EvictCancelled`, called before `Admit`, frees the slots and
  pages of those, and a commit drops their tokens.

Priority scheduling, prefix sharing and speculative rows come with later
serving slices. The scheduler is device-free (Python + numpy), as in the
reference.
"""

from __future__ import annotations

import collections
import enum
from typing import Optional

import numpy as np

from lingvo_tpu_torch.core import ragged
from lingvo_tpu_torch.serving import kv_cache


class SeqState(enum.Enum):
  QUEUED = "queued"
  PREFILL = "prefill"
  DECODE = "decode"
  FINISHED = "finished"
  CANCELLED = "cancelled"


class Request:
  """One user request: prompt ids + generation budget.

  seed: the request's sampling seed (its row stream). Defaults to the
  request id, so a resubmitted request with the same id and seed draws
  the same continuation; kept modulo 2**31."""

  def __init__(self, req_id, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None, seed: Optional[int] = None):
    prompt = [int(t) for t in prompt]
    if not prompt:
      raise ValueError("empty prompt")
    if max_new_tokens < 1:
      raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    self.id = req_id
    self.prompt = prompt
    self.max_new = int(max_new_tokens)
    self.eos_id = eos_id
    if seed is None:
      seed = req_id if isinstance(req_id, int) else abs(hash(req_id))
    self.seed = int(seed) % (2**31)


class Sequence:
  """A request's in-flight decode state (slot-resident)."""

  def __init__(self, request: Request):
    self.req = request
    self.state = SeqState.QUEUED
    self.pos = 0          # tokens WRITTEN to the KV cache so far
    self.out = []         # generated tokens (out[-1] may not be cached yet)
    self.finish_reason = None

  @property
  def id(self):
    return self.req.id

  @property
  def prompt_remaining(self) -> int:
    return len(self.req.prompt) - self.pos


class StepBatch:
  """One [B, C] legacy device step (numpy; the engine moves it on device)."""

  def __init__(self, ids, q_pos, in_len, rows, mixed: bool,
               prompt_tokens: int, row_seeds, row_pos):
    self.ids = ids          # [B, C] int32
    self.q_pos = q_pos      # [B] int32
    self.in_len = in_len    # [B] int32 (0 = inactive row)
    self.rows = rows        # slot -> Sequence or None, frozen at build time
    self.mixed = mixed      # True if any prefill row rode this step
    self.prompt_tokens = prompt_tokens
    # sampling inputs: the request's seed and its output index (tokens
    # generated so far)
    self.row_seeds = row_seeds  # [B] int32
    self.row_pos = row_pos      # [B] int32


class RaggedBatch:
  """One packed ragged device step (numpy; the engine moves it on device)."""

  def __init__(self, tok_ids, rows_desc: ragged.RaggedRows, rows,
               mixed: bool, prompt_tokens: int, row_seeds, row_pos):
    self.tok_ids = tok_ids        # [T] int32 packed token stream
    self.rows_desc = rows_desc    # core/ragged.RaggedRows (numpy members)
    self.rows = rows              # slot -> Sequence or None, frozen at build
    self.mixed = mixed            # True if any prompt token rode this step
    self.prompt_tokens = prompt_tokens
    self.row_seeds = row_seeds    # [B] int32, as StepBatch
    self.row_pos = row_pos        # [B] int32


class Scheduler:
  """Admission + step building + commit over B slots and a page pool."""

  def __init__(self, max_slots: int, allocator: kv_cache.PageAllocator,
               table_pages: int, needs_kv_pages: bool = True,
               state_pool: Optional[kv_cache.StateSlotPool] = None):
    """table_pages: block-table width (pages per sequence), the static
    max_seq_len / page_size bound. needs_kv_pages: False for pure
    O(1)-mixer stacks (no attention layer writes the page pool): admission
    is then bounded by slots only and the allocator is never charged.
    state_pool: slot ownership of the O(1) mixer states (acquired on admit,
    released on retirement)."""
    assert max_slots >= 1 and table_pages >= 1
    self.max_slots = max_slots
    self.alloc = allocator
    self.table_pages = table_pages
    self.needs_kv_pages = needs_kv_pages
    self.state_pool = state_pool
    self.waiting = collections.deque()        # of Sequence (QUEUED)
    self.slots: list[Optional[Sequence]] = [None] * max_slots
    self._by_id: dict[object, Sequence] = {}
    # block tables as one stable [B, table_pages] array, rewritten on
    # admit only (steady-state decode steps reuse it as-is)
    self.block_tables = np.zeros((max_slots, table_pages), np.int32)
    self.admitted = 0
    self.finished = 0
    self.cancelled = 0
    self.rejected_overlong = 0
    self.slots_live_peak = 0

  # -- submission ------------------------------------------------------------

  def Submit(self, request: Request) -> Sequence:
    total = len(request.prompt) + request.max_new
    if self.alloc.PagesFor(total) > self.table_pages:
      self.rejected_overlong += 1
      raise ValueError(
          f"request {request.id!r} needs {self.alloc.PagesFor(total)} pages "
          f"(prompt {len(request.prompt)} + max_new {request.max_new}) but "
          f"block tables hold {self.table_pages}")
    seq = Sequence(request)
    self._by_id[request.id] = seq
    self.waiting.append(seq)
    return seq

  def Cancel(self, req_id) -> bool:
    """Marks a request cancelled; resources return at the next boundary.
    False when it is unknown, finished or already cancelled."""
    seq = self._by_id.get(req_id)
    if seq is None or seq.state in (SeqState.FINISHED, SeqState.CANCELLED):
      return False
    if seq.state is SeqState.QUEUED:
      self.waiting.remove(seq)
      self._Retire(seq, SeqState.CANCELLED, "cancelled")
      self.cancelled += 1
      return True
    seq.state = SeqState.CANCELLED   # slot/pages reclaimed by EvictCancelled
    seq.finish_reason = "cancelled"
    return True

  # -- boundary phases -------------------------------------------------------

  def EvictCancelled(self) -> list:
    """Frees slots/pages of mid-flight cancellations. Call before Admit."""
    evicted = []
    for i, seq in enumerate(self.slots):
      if seq is not None and seq.state is SeqState.CANCELLED:
        self.slots[i] = None
        self.alloc.Free(seq.id)
        if self.state_pool is not None:
          self.state_pool.Release(seq.id)
        self.cancelled += 1
        evicted.append(seq)
    return evicted

  def Admit(self) -> list:
    """Admits waiting requests (fifo, the only mode ported)."""
    return self._AdmitFifo()

  def _AdmitFifo(self) -> list:
    """Admits waiting requests into free slots while pages last; stops at
    the first head that does not fit (head-of-line blocking)."""
    admitted = []
    for i in range(self.max_slots):
      if self.slots[i] is not None or not self.waiting:
        continue
      seq = self.waiting[0]
      pages = []
      if self.needs_kv_pages:
        need = self.alloc.PagesFor(len(seq.req.prompt) + seq.req.max_new)
        if not self.alloc.CanAllocate(need):
          break
        pages = self.alloc.Allocate(seq.id, need)
      self.waiting.popleft()
      self.slots[i] = seq
      seq.state = SeqState.PREFILL
      self.block_tables[i, :] = 0
      self.block_tables[i, :len(pages)] = pages
      if self.state_pool is not None:
        self.state_pool.Acquire(seq.id, i)
      self.admitted += 1
      self.slots_live_peak = max(
          self.slots_live_peak, sum(s is not None for s in self.slots))
      admitted.append(seq)
    return admitted

  def HasWork(self) -> bool:
    return any(s is not None for s in self.slots) or bool(self.waiting)

  # -- legacy [B, C] step ------------------------------------------------------

  def BuildStep(self, prefill_chunk: int) -> Optional[StepBatch]:
    """Lays the live slots out as one [B, C] step (None if idle): C = 1
    when every live row decodes, else C = prefill_chunk; a prefilling row
    takes its next min(C, prompt_remaining) prompt tokens, a decode row
    feeds its last draw in column 0."""
    rows = list(self.slots)
    if not any(s is not None for s in rows):
      return None
    mixed = any(s is not None and s.state is SeqState.PREFILL for s in rows)
    c = prefill_chunk if mixed else 1
    b = self.max_slots
    ids = np.zeros((b, c), np.int32)
    q_pos = np.zeros((b,), np.int32)
    in_len = np.zeros((b,), np.int32)
    row_seeds = np.zeros((b,), np.int32)
    row_pos = np.zeros((b,), np.int32)
    prompt_tokens = 0
    for i, seq in enumerate(rows):
      if seq is None:
        continue
      q_pos[i] = seq.pos
      row_seeds[i] = seq.req.seed
      row_pos[i] = len(seq.out)
      if seq.state is SeqState.PREFILL:
        n = min(c, seq.prompt_remaining)
        ids[i, :n] = seq.req.prompt[seq.pos:seq.pos + n]
        in_len[i] = n
        prompt_tokens += n
      else:   # DECODE: feed the last draw (writes it to the cache)
        ids[i, 0] = seq.out[-1]
        in_len[i] = 1
    return StepBatch(ids, q_pos, in_len, rows, mixed, prompt_tokens,
                     row_seeds, row_pos)

  def CommitStep(self, batch: StepBatch, sampled: np.ndarray) -> list:
    """Folds one legacy step's draws [B, C] back in: a finishing prefill
    row reads the draw at its last prompt column, a decode row column 0.
    Returns [(request_id, token, finished)] events in slot order."""
    events = []
    for i, seq in enumerate(batch.rows):
      if seq is None or seq.state is SeqState.CANCELLED:
        continue   # cancelled mid-step: drop the token, evict at boundary
      if seq.state is SeqState.PREFILL:
        n = int(batch.in_len[i])
        seq.pos += n
        if seq.prompt_remaining > 0:
          continue                       # more prompt chunks to go
        tok = int(sampled[i, n - 1])
        seq.state = SeqState.DECODE
      elif seq.state is SeqState.DECODE:
        seq.pos += 1                     # the fed-back token is now cached
        tok = int(sampled[i, 0])
      else:
        continue
      events.append(self._Emit(i, seq, tok))
    return events

  def _Emit(self, i: int, seq: Sequence, tok: int) -> tuple:
    """Appends tok to slot i's sequence and retires it on max_new/EOS;
    returns its (request_id, token, finished) event."""
    seq.out.append(tok)
    done_eos = seq.req.eos_id is not None and tok == seq.req.eos_id
    if not done_eos and len(seq.out) < seq.req.max_new:
      return (seq.id, tok, False)
    self.slots[i] = None
    self.finished += 1
    self._Retire(seq, SeqState.FINISHED, "eos" if done_eos else "length")
    return (seq.id, tok, True)

  def _Retire(self, seq: Sequence, state: SeqState, reason: str):
    seq.state = state
    seq.finish_reason = reason
    self.alloc.Free(seq.id)   # idempotent
    if self.state_pool is not None:
      self.state_pool.Release(seq.id)   # idempotent

  # -- unified ragged step ----------------------------------------------------

  def BuildRaggedStep(self, t: int, wmax: int) -> Optional[RaggedBatch]:
    """Packs every live slot into ONE [T]-token ragged step (None if idle).

    t: packed token width, static (max_slots + prefill token budget).
    wmax: widest row the step admits. Decode rows are packed first, one
    token each; prefill rows then take the leftover budget in slot order,
    up to min(wmax, budget, prompt_remaining) tokens. Rows that fit no
    budget this step ride with row_len == 0."""
    rows = list(self.slots)
    if not any(s is not None for s in rows):
      return None
    b = self.max_slots
    row_len = np.zeros((b,), np.int32)
    row_q_pos = np.ones((b,), np.int32)  # empty slot: 1 (reference layout)
    row_seeds = np.zeros((b,), np.int32)
    row_pos = np.zeros((b,), np.int32)
    budget = t
    for i, seq in enumerate(rows):
      if seq is None:
        continue
      row_q_pos[i] = seq.pos
      row_seeds[i] = seq.req.seed
      row_pos[i] = len(seq.out)
      if seq.state is SeqState.DECODE:
        row_len[i] = 1
        budget -= 1
    assert budget >= 0, (t, row_len)  # the engine sizes t for every decode row
    prompt_tokens = 0
    for i, seq in enumerate(rows):
      if seq is None or seq.state is not SeqState.PREFILL:
        continue
      n = min(wmax, budget, seq.prompt_remaining)
      row_len[i] = n
      budget -= n
      prompt_tokens += n
    desc = ragged.BuildRaggedRows(row_len, row_q_pos, t, wmax)
    tok_ids = np.zeros((t,), np.int32)
    for i, seq in enumerate(rows):
      n = int(row_len[i])
      if seq is None or n == 0:
        continue
      cols = desc.row_cols[i, :n]
      if seq.state is SeqState.PREFILL:
        tok_ids[cols] = seq.req.prompt[seq.pos:seq.pos + n]
      else:
        tok_ids[cols[0]] = seq.out[-1]   # feeds (and caches) the last draw
    return RaggedBatch(tok_ids, desc, rows, prompt_tokens > 0, prompt_tokens,
                       row_seeds, row_pos)

  def CommitRaggedStep(self, batch: RaggedBatch,
                       sampled_tok: np.ndarray) -> list:
    """Folds one ragged step's per-token draws [T] back in.

    A prefill row reads the draw at its LAST prompt token's column, a
    decode row its only column. Returns [(request_id, token, finished)]
    events in slot order."""
    events = []
    desc = batch.rows_desc
    for i, seq in enumerate(batch.rows):
      if seq is None or seq.state is SeqState.CANCELLED:
        continue   # cancelled mid-step: drop the tokens, evict at boundary
      n = int(desc.row_len[i])
      if seq.state is SeqState.PREFILL:
        if n == 0:
          continue                       # out of token budget this step
        seq.pos += n
        if seq.prompt_remaining > 0:
          continue                       # more prompt tokens to go
        tok = int(sampled_tok[desc.row_cols[i, n - 1]])
        seq.state = SeqState.DECODE
      elif seq.state is SeqState.DECODE:
        seq.pos += 1                     # the fed-back token is now cached
        tok = int(sampled_tok[desc.row_cols[i, 0]])
      else:
        continue
      events.append(self._Emit(i, seq, tok))
    return events

  # -- introspection ---------------------------------------------------------

  def Stats(self) -> dict:
    live = [s for s in self.slots if s is not None]
    return {
        "slots": self.max_slots,
        "slots_live": len(live),
        "slots_prefill": sum(s.state is SeqState.PREFILL for s in live),
        "queue_depth": len(self.waiting),
        "admitted": self.admitted,
        "finished": self.finished,
        "cancelled": self.cancelled,
        "rejected_overlong": self.rejected_overlong,
        "slots_live_peak": self.slots_live_peak,
        "needs_kv_pages": self.needs_kv_pages,
    }
