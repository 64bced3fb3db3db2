"""KV block allocator and O(1)-state slot pool: host-side ownership.

Port of `PageAllocator`, `OutOfPages` and `StateSlotPool` from
lingvo_tpu/serving/kv_cache.py, without the prefix-sharing refcounts and
the preemption spill surface (those come with the prefix-cache and
priority-scheduling slices). The
device side is a plain `[num_pages, page_size, N, H]` pool per layer;
which pages belong to which sequence lives here, in Python, updated
between steps. A min-heap free list always hands out the lowest free
page, so the live set stays packed toward the low end of the pool.
"""

from __future__ import annotations

import heapq


class OutOfPages(Exception):
  """Raised by Allocate when the pool cannot satisfy the request."""


class PageAllocator:
  """Owns [0, num_pages) of the device pool; sequences hold disjoint sets.

  Not thread-safe on its own: the serving engine serializes all calls
  under its lock. The trash page the engine appends to the device pool is
  outside [0, num_pages) and never managed here."""

  def __init__(self, num_pages: int, page_size: int, page_bytes: int = 0):
    assert num_pages > 0 and page_size > 0, (num_pages, page_size)
    self.num_pages = num_pages
    self.page_size = page_size
    # device bytes one logical page costs across every layer's pool
    self.page_bytes = int(page_bytes)
    self._free = list(range(num_pages))  # already a valid min-heap
    self._owned: dict[object, list[int]] = {}
    self.peak_in_use = 0

  # -- queries ---------------------------------------------------------------

  @property
  def num_free(self) -> int:
    return len(self._free)

  @property
  def num_in_use(self) -> int:
    return self.num_pages - len(self._free)

  def PagesFor(self, num_tokens: int) -> int:
    """Pages needed to hold num_tokens logical slots."""
    return -(-num_tokens // self.page_size)

  def CanAllocate(self, n: int) -> bool:
    return n <= len(self._free)

  def PagesOf(self, seq_id) -> list[int]:
    """The sequence's pages in logical order (index i = logical page i)."""
    return list(self._owned[seq_id])

  def Stats(self) -> dict:
    out = {
        "num_pages": self.num_pages,
        "page_size": self.page_size,
        "in_use": self.num_in_use,
        "free": self.num_free,
        "utilization": self.num_in_use / self.num_pages,
        "peak_in_use": self.peak_in_use,
        "num_sequences": len(self._owned),
    }
    if self.page_bytes:
      out["page_bytes"] = self.page_bytes
      out["pool_bytes"] = self.page_bytes * self.num_pages
    return out

  # -- mutations -------------------------------------------------------------

  def Allocate(self, seq_id, n: int) -> list[int]:
    """Grants n MORE pages to seq_id (appended to its logical order).

    All-or-nothing: raises OutOfPages without side effects if fewer than n
    pages are free."""
    if n > len(self._free):
      raise OutOfPages(f"need {n} pages, {len(self._free)} free")
    got = [heapq.heappop(self._free) for _ in range(n)]
    self._owned.setdefault(seq_id, []).extend(got)
    self.peak_in_use = max(self.peak_in_use, self.num_in_use)
    return got

  def Free(self, seq_id) -> int:
    """Returns seq_id's pages to the pool; the count released. Idempotent."""
    pages = self._owned.pop(seq_id, [])
    for pg in pages:
      heapq.heappush(self._free, pg)
    return len(pages)


class StateSlotPool:
  """Ownership of O(1) mixer-state slots (one per engine slot).

  Device-side the state is a `[num_slots, ...]` tensor per SSM layer
  (ssm.GatedSSMLayer.InitPagedStates); row i belongs to whichever sequence
  the scheduler placed in slot i, and is reset on the device on that
  sequence's first step (q_pos == 0), so acquiring a slot never touches the
  device. Host bookkeeping only, serialized by the engine's lock.

  bytes_per_slot: per-sequence mixer-state bytes across all SSM layers
  (the sum of StateBytesPerSlot), constant in sequence length."""

  def __init__(self, num_slots: int, bytes_per_slot: int):
    assert num_slots > 0 and bytes_per_slot >= 0, (num_slots, bytes_per_slot)
    self.num_slots = num_slots
    self.bytes_per_slot = int(bytes_per_slot)
    self._slot_of: dict[object, int] = {}
    self._owner: dict[int, object] = {}
    self.peak_in_use = 0

  @property
  def num_in_use(self) -> int:
    return len(self._slot_of)

  @property
  def num_free(self) -> int:
    return self.num_slots - len(self._slot_of)

  def Acquire(self, seq_id, slot: int):
    """Binds seq_id to engine slot `slot` (which must be free)."""
    assert 0 <= slot < self.num_slots, (slot, self.num_slots)
    assert slot not in self._owner, (
        f"slot {slot} already owned by {self._owner[slot]!r}")
    assert seq_id not in self._slot_of, seq_id
    self._slot_of[seq_id] = slot
    self._owner[slot] = seq_id
    self.peak_in_use = max(self.peak_in_use, self.num_in_use)

  def Release(self, seq_id) -> bool:
    """Unbinds seq_id's slot. Idempotent, as PageAllocator.Free."""
    slot = self._slot_of.pop(seq_id, None)
    if slot is None:
      return False
    del self._owner[slot]
    return True

  def Stats(self) -> dict:
    return {
        "num_slots": self.num_slots,
        "bytes_per_slot": self.bytes_per_slot,
        "in_use": self.num_in_use,
        "free": self.num_free,
        "peak_in_use": self.peak_in_use,
        "state_bytes_in_use": self.num_in_use * self.bytes_per_slot,
    }
