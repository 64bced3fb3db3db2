"""Async device infeed and deferred telemetry for program host loops (port of lingvo_tpu/runners/infeed.py).

- `DeviceInfeed`: ONE background producer thread pulls host batches from
  the input generator into a bounded FIFO queue while the device computes
  the previous steps. On a CUDA device it also places them: each batch is
  pinned, copied on a side stream, and an event recorded after the copy.
  The consumer makes its own stream wait on that event and marks each
  tensor it hands on as used by its stream (`record_stream`), so the
  caching allocator does not give a batch's memory back to the side
  stream while a step still reads it. One producer and a FIFO make the
  consumed sequence the one the generator yields inline.
- `DeferredTelemetry`: ONE background worker runs the post-loop metric
  fetch and the summary writes, so the host never waits on them between
  two device loops. Jobs run in submission order.

Producer and worker exceptions are latched and re-raised at the consumer
(`Get()` / `Future.result()`), so the train loop, and the executor's
transient-retry path above it, sees the real error instead of a silent
end of data. A failed side-stream copy is such an error: there is no
quiet fallback to placing on the consumer.

The reference's multi-process placement probe waits for the parallelism
slice (ROADMAP item 11): the port runs one process.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Iterator

import torch

_EOS = object()  # end-of-stream sentinel (never a valid batch)

# Producer threads that outlived their Stop() join (blocked inside the
# input generator), keyed by input stream: a new producer over the same
# stream, from any DeviceInfeed, must wait these out or fail loudly rather
# than race the generator and break batch order.
_LINGERING_LOCK = threading.Lock()
_LINGERING: dict[Any, threading.Thread] = {}


def _Tensors(item) -> list:
  if isinstance(item, torch.Tensor):
    return [item]
  if isinstance(item, dict):
    return [t for v in item.values() for t in _Tensors(v)]
  if isinstance(item, (list, tuple)):
    return [t for v in item for t in _Tensors(v)]
  return []


class DeviceInfeed:
  """Bounded background producer queue feeding device (or host) batches.

  Args:
    make_iter: callable returning a FRESH iterator of host batches; invoked
      once per producer start (and again after `Reset`).
    place_fn: optional host->device placement, applied per batch on the
      producer thread (on a side stream of `device` when it is CUDA) so
      the copy overlaps compute.
    depth: queue capacity, which bounds host and device memory while the
      device lags.
    name: thread-name prefix for debugging.
    stream_key: identity of the underlying input stream (e.g.
      `id(generator)`), serializing producers across DeviceInfeed
      instances that share it (see _LINGERING).
    device: the device `place_fn` places on.
  """

  def __init__(self, make_iter: Callable[[], Iterator[Any]],
               place_fn: Callable[[Any], Any] | None = None,
               depth: int = 2, name: str = "infeed", stream_key: Any = None,
               device: torch.device | None = None):
    self._stream_key = stream_key if stream_key is not None else id(self)
    self._make_iter = make_iter
    self._place_fn = place_fn
    self._depth = max(1, int(depth))
    self._name = name
    self._cuda = (place_fn is not None and device is not None and
                  torch.device(device).type == "cuda")
    self._device = device
    self._side_stream = None
    self._thread: threading.Thread | None = None
    self._queue: "queue.Queue" | None = None
    self._stop: threading.Event | None = None
    self._error: BaseException | None = None
    self._done = False
    self.wait_s = 0.0  # cumulative consumer blocking time (starvation)

  @property
  def healthy(self) -> bool:
    return self._error is None

  def QueueDepth(self) -> int:
    q = self._queue
    return q.qsize() if q is not None else 0

  def _JoinLingering(self) -> None:
    """Waits out a producer over this stream that outlived its Stop()."""
    with _LINGERING_LOCK:
      lingering = _LINGERING.pop(self._stream_key, None)
    if lingering is not None and lingering.is_alive():
      # an earlier Stop() timed out while its producer was blocked inside
      # the generator; two producers on one generator would break batch
      # order, so wait it out or fail
      lingering.join(timeout=30.0)
      if lingering.is_alive():
        with _LINGERING_LOCK:
          _LINGERING[self._stream_key] = lingering
        raise RuntimeError(
            f"{self._name}: previous producer thread is still blocked in "
            "the input generator; refusing to seek the stream or start a "
            "second producer over it")

  def _EnsureStarted(self) -> None:
    if self._thread is not None or self._done:
      return
    self._JoinLingering()
    if self._cuda and self._side_stream is None:
      self._side_stream = torch.cuda.Stream(device=self._device)
    self._queue = queue.Queue(maxsize=self._depth)
    self._stop = threading.Event()
    self._thread = threading.Thread(
        target=self._Produce, args=(self._queue, self._stop),
        name=f"{self._name}-producer", daemon=True)
    self._thread.start()

  def _Place(self, item):
    """(placed item, event after its copy or None)."""
    if self._place_fn is None:
      return item, None
    if not self._cuda:
      return self._place_fn(item), None
    with torch.cuda.stream(self._side_stream):
      placed = self._place_fn(item)
      event = torch.cuda.Event()
      event.record(self._side_stream)
    return placed, event

  def _Produce(self, q: "queue.Queue", stop: threading.Event) -> None:
    # q/stop come as arguments: a Reset() from the consumer swaps the
    # members, and an abandoned producer must honor ITS stop event
    try:
      for item in self._make_iter():
        item = self._Place(item)
        while not stop.is_set():
          try:
            q.put(item, timeout=0.2)
            break
          except queue.Full:
            continue
        if stop.is_set():
          return
    except BaseException as e:  # noqa: BLE001 - surfaced at Get()
      if not stop.is_set():
        # a stopped producer's late exception must not poison the latch a
        # Reset() just cleared
        self._error = e
    finally:
      while not stop.is_set():
        try:
          q.put(_EOS, timeout=0.2)
          return
        except queue.Full:
          continue

  def Get(self) -> Any | None:
    """Next batch, or None at end-of-stream (latched).

    Re-raises a producer exception (also latched: a dead producer must not
    masquerade as end of data). Blocking time accumulates in `wait_s`.
    """
    self._EnsureStarted()
    if self._done:
      if self._error is not None:
        raise self._error
      return None
    t0 = time.perf_counter()
    item = self._queue.get()
    self.wait_s += time.perf_counter() - t0
    if item is _EOS:
      self._done = True
      if self._error is not None:
        raise self._error
      return None
    batch, event = item
    if event is not None:
      stream = torch.cuda.current_stream(self._device)
      stream.wait_event(event)
      for t in _Tensors(batch):
        t.record_stream(stream)
    return batch

  def Iter(self) -> Iterator[Any]:
    """Generator view over Get() (finite-stream consumers, e.g. eval)."""
    while True:
      item = self.Get()
      if item is None:
        return
      yield item

  def Stop(self) -> None:
    """Stops the producer and discards queued batches. Safe to call twice."""
    thread, q, stop = self._thread, self._queue, self._stop
    self._thread = None
    self._queue = None
    self._stop = None
    if stop is not None:
      stop.set()
    if q is not None:
      try:
        while True:
          q.get_nowait()
      except queue.Empty:
        pass
    if thread is not None:
      # a producer blocked inside the generator parks after its current
      # pull; do not hang on it here, but remember it so that a restart
      # cannot race it on the same generator (_EnsureStarted)
      thread.join(timeout=5.0)
      if thread.is_alive():
        with _LINGERING_LOCK:
          _LINGERING[self._stream_key] = thread

  def Reset(self) -> None:
    """Stop + clear the latched end/error state; the next Get() starts a
    fresh `make_iter()` iterator. When it returns, no producer of this
    stream pulls from the generator any more (one still blocked there is
    waited out, or RuntimeError), so the caller may seek it."""
    self.Stop()
    self._JoinLingering()
    self._done = False
    self._error = None


class DeferredTelemetry:
  """Single-worker executor for post-loop metric fetches and summary
  writes. One worker: jobs complete in submission order. The consumer
  bounds the window (`TrainProgram.Run` keeps at most `pipeline_depth`
  unresolved loops), so the results the
  executor reads lag dispatch by at most that many loops."""

  def __init__(self, name: str = "telemetry"):
    self._name = name
    self._pool: ThreadPoolExecutor | None = None

  def Submit(self, fn: Callable[[], Any]) -> Future:
    if self._pool is None:
      self._pool = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix=self._name)
    return self._pool.submit(fn)

  def Shutdown(self) -> None:
    """Waits for in-flight jobs; the next Submit() lazily restarts."""
    pool, self._pool = self._pool, None
    if pool is not None:
      pool.shutdown(wait=True)
