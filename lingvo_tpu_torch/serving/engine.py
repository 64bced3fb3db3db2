"""ServingLoop: the continuous-batching serving engine (port of lingvo_tpu/serving/engine.py).

Glues the layers below into a running service:

    ops/ragged_block_attend.py   the packed-token paged attention kernel
    ops/ssd_scan.py              the SSM mixers' chunked scan kernel
    serving/kv_cache.py          host-side page and state-slot ownership
    serving/scheduler.py         admission / step building / retirement
    serving/spec_decode.py       the mixer census
    quant/kv.py                  the KV census: pool dtype and page price

Two step modes, as in the reference:
- 'ragged' (the default): every iteration packs its work onto one [T]
  token axis (core/ragged.py): a decode row contributes 1 token, a
  prefilling row a token-budgeted prompt chunk, with T = max_batch +
  prefill_chunk fixed at construction, as in the reference's one
  compiled step; the attention read is the ragged kernel.
- 'legacy': every iteration is a [B, C] step through `PagedStep`
  (scheduler.BuildStep): C = 1 when every live row decodes, and the
  attention read is the block-decode kernel (ops/block_decode.py); C =
  prefill_chunk when a row is still prefilling, and the read is the plain
  `BlockPrefill`. Greedy draws are taken per column.

The device pools are updated in place; admission and retirement only
rewrite the int32 block tables between steps.

O(1)-state mixers (core/ssm.py) plug in unchanged: each SSM layer keeps a
[max_batch, N, H, S] state per slot, reset on the device on a sequence's
first step (q_pos == 0). The engine takes a mixer census at construction:
a hybrid stack prices both resources (KV pages for its attention layers,
a `StateSlotPool` for its SSM layers), and a pure-SSM stack admits
pageless, bounded by slots only (`paged_path == "ssm"`).

KV pools are float32, bfloat16 or int8 (`kv_cache_dtype`, overriding
the task's; quant/kv.py): an int8 pool quantizes each token on write and
keeps float32 scale sidecars, which its page price counts, and the
kernels dequantize it on read. `Stats()` reports the pool's dtype, its
bytes per token, and `quantized_steps`.

int8 weights (`serve_int8_weights=True`, quant/weights.py): the engine
rewrites the task's theta once, at construction, into `Int8Weight`
leaves (per-channel scales, one set per repeat layer) and binds it to the
task for its own steps (`base_layer.ServedTheta`): every projection of a
step, the tied logits included, runs the int8 matmul
(ops/int8_matmul.py). The task's float parameters stay as they are, so a
float engine or a trainer on the same task computes what it did. `Stats()`
reports `serve_int8_weights`.

Ported: both step modes, fifo scheduling, greedy sampling, float32,
bfloat16 and int8 KV pools, int8 weights. Speculative decoding, the prefix
cache, priority scheduling and temperature > 0 raise NotImplementedError
naming the slice that brings them; so does int8 serving of a stack with
SSM mixers, which the reference cannot run either.

Two front doors, as in the reference:
- async: `Start()` + `Submit(prompt, max_new) -> StreamHandle`, tokens
  stream out per request as they are committed; `Stop()` drains.
- sync: `RunBatch(prompts, prompt_lens)` drives the loop inline and
  returns `[B, max_new]` outputs in submission order.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import ragged as ragged_lib
from lingvo_tpu_torch.core import sampling
from lingvo_tpu_torch.quant import kv as kv_quant
from lingvo_tpu_torch.quant import weights as quant_weights
from lingvo_tpu_torch.serving import kv_cache
from lingvo_tpu_torch.serving import scheduler as scheduler_lib
from lingvo_tpu_torch.serving import spec_decode

_END = object()   # stream sentinel


class StreamHandle:
  """Per-request streaming output + lifecycle handle."""

  def __init__(self, req_id, submit_time: float):
    self.id = req_id
    self._q = queue.Queue()
    self._tokens = []
    self._done = threading.Event()
    self.finish_reason: Optional[str] = None
    self.submit_time = submit_time
    self.first_token_time: Optional[float] = None
    self.finish_time: Optional[float] = None

  # engine-side
  def _Push(self, token: int):
    if self.first_token_time is None:
      self.first_token_time = time.perf_counter()
    self._tokens.append(token)
    self._q.put(token)

  def _Finish(self, reason: str):
    self.finish_reason = reason
    self.finish_time = time.perf_counter()
    self._done.set()
    self._q.put(_END)

  # user-side
  def Tokens(self, timeout: Optional[float] = None):
    """Yields tokens as they are generated; returns on completion."""
    while True:
      item = self._q.get(timeout=timeout)
      if item is _END:
        return
      yield item

  def Result(self, timeout: Optional[float] = None) -> list:
    """Blocks until the request finishes; returns all generated tokens."""
    if not self._done.wait(timeout=timeout):
      raise TimeoutError(f"request {self.id!r} still running")
    return list(self._tokens)


_COUNTER_KEYS = ("steps", "decode_steps", "mixed_steps", "tokens_emitted",
                 "prompt_tokens", "quantized_steps")


class ServingLoop:
  """Continuous-batching decode service over a block-table page pool."""

  def __init__(self, task, *, page_size: int, num_pages: int,
               max_batch: int, max_seq_len: int, prefill_chunk: int = 8,
               default_max_new: int = 32, eos_id: Optional[int] = None,
               temperature: float = 0.0,
               kv_cache_dtype: Optional[str] = None,
               serve_int8_weights: bool = False, spec=None,
               prefix_cache=None, step_mode: str = "ragged",
               scheduler_mode: str = "fifo", device=None):
    """task: a TransformerLm (exposing InitPagedDecodeState, RaggedStep
    and PagedStep) that holds its weights on `device`. num_pages:
    allocator-owned pages (the device pool gets one extra trash page).
    max_seq_len: static per-sequence capacity (block-table width =
    ceil(max_seq_len / page_size)). prefill_chunk: prompt tokens a ragged
    step packs beyond one token per slot (the reference's default
    prefill_token_budget), and the width C of a legacy mixed step.
    step_mode: 'ragged' or 'legacy' (see the module docstring).
    kv_cache_dtype: overrides the task's layer-level kv_cache_dtype for
    this engine's page pool (None keeps it): 'float32', 'bfloat16', or
    'int8' (quantize-on-write pages with scale sidecars).
    serve_int8_weights: serve an int8 rewrite of the task's theta (every
    projection an int8 matmul; see the module docstring). device: where
    the engine runs; None means CUDA and raises when there is none. The
    other arguments name reference features that raise until ported."""
    if step_mode not in ("ragged", "legacy"):
      raise ValueError(f"step_mode must be 'ragged' or 'legacy', got "
                       f"{step_mode!r}")
    if spec is not None:
      raise NotImplementedError(
          "speculative decoding comes with the spec-decode serving slice")
    if prefix_cache is not None and prefix_cache is not False:
      raise NotImplementedError(
          "the prefix cache comes with the prefix-cache serving slice")
    if scheduler_mode != "fifo":
      raise NotImplementedError(
          f"scheduler_mode={scheduler_mode!r} comes with the priority-"
          "scheduling slice; the port schedules fifo")
    if temperature > 0.0:
      raise NotImplementedError(
          "temperature > 0 sampling comes with a later serving slice; the "
          "port samples greedily")
    if task.fprop_dtype != torch.float32:
      raise NotImplementedError(
          f"serving at fprop_dtype={task.fprop_dtype} comes with ROADMAP "
          "item 15 of the port; the engine serves float32 activations")
    assert page_size >= 1 and num_pages >= 1 and max_batch >= 1
    assert max_seq_len >= page_size
    self.device = base_layer.ResolveDevice(device)
    if task.device != self.device:
      raise ValueError(f"the task lives on {task.device}, the engine was "
                       f"asked to run on {self.device}")
    # float32 everywhere: matmuls and convolutions in full float32, never
    # TF32 (the reference's numerics; the parity tests assume it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    self._task = task
    self.serve_int8_weights = bool(serve_int8_weights)
    self._served = None
    if serve_int8_weights:
      quant_weights.CheckInt8Servable(task)
      theta, _ = quant_weights.Int8ServingTheta(task.ThetaTree())
      self._served = base_layer.ServedTheta(task, theta)
    self.step_mode = step_mode
    self.prefill_chunk = prefill_chunk
    self.page_size = page_size
    self.num_pages = num_pages
    self.max_batch = max_batch
    self.default_max_new = default_max_new
    self.eos_id = eos_id
    self.temperature = float(temperature)
    # KV census before allocating: the effective pool dtype prices a page
    # by the attention layers' K/V and scale sidecars only, never by the
    # SSM slot states
    kv_census = kv_quant.StackKvCensus(task, kv_cache_dtype) or {}
    self.kv_cache_dtype = kv_census.get("kv_cache_dtype")
    self.kv_bytes_per_token = kv_census.get("kv_bytes_per_token", 0)
    self._kv_quantized = self.kv_cache_dtype == "int8"
    # mixer census: which resource(s) the stack's serving state occupies
    self.mixers = spec_decode.MixerCensus(task)
    self.state_pool = None
    if self.mixers["num_ssm"] > 0:
      self.state_pool = kv_cache.StateSlotPool(
          max_batch, self.mixers["decode_state_bytes_per_slot"])
    # pool page num_pages (the +1) is the trash page padding writes hit;
    # num_slots sizes the SSM layers' per-slot states
    with torch.no_grad():
      self._states = task.InitPagedDecodeState(num_pages + 1, page_size,
                                               max_batch, kv_cache_dtype)
    self.alloc = kv_cache.PageAllocator(
        num_pages, page_size,
        page_bytes=page_size * self.kv_bytes_per_token)
    self.sched = scheduler_lib.Scheduler(
        max_batch, self.alloc, self.alloc.PagesFor(max_seq_len),
        needs_kv_pages=self.mixers["num_attention"] > 0,
        state_pool=self.state_pool)
    # unified ragged step geometry: one token per slot (every decode row)
    # plus the prefill token budget (prefill_chunk); wmax is the widest row
    self._ragged_t = max_batch + prefill_chunk
    self._ragged_wmax = prefill_chunk
    # what the step's paged attention lowers to: the CUDA kernel or the
    # plain version, '-int8' on an int8 pool (the reference's
    # _ClassifyPath); 'ssm' = no attention layer, the page pool is unused
    if self.mixers["num_attention"] == 0:
      self.paged_path = "ssm"
    else:
      self.paged_path = ("cuda" if self.device.type == "cuda" else "plain") + (
          "-int8" if self._kv_quantized else "")
    self._counters = {k: 0 for k in _COUNTER_KEYS}
    self._handles: dict = {}
    self._lock = threading.RLock()
    self._work = threading.Condition(self._lock)
    self._thread: Optional[threading.Thread] = None
    self._running = False
    self._seq_counter = 0

  # -- async API -------------------------------------------------------------

  def Start(self):
    with self._lock:
      if self._running:
        return self
      self._running = True
      self._thread = threading.Thread(target=self._Loop, daemon=True,
                                      name="serving-loop")
      self._thread.start()
    return self

  def Stop(self, timeout: float = 60.0):
    """Finishes in-flight and queued work, then stops the loop thread."""
    with self._lock:
      if not self._running:
        return
      self._work.notify_all()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
      with self._lock:
        if not self.sched.HasWork():
          break
      time.sleep(0.005)
    with self._lock:
      self._running = False
      self._work.notify_all()
    if self._thread is not None:
      self._thread.join(timeout=timeout)
      if self._thread.is_alive():
        raise TimeoutError("serving loop did not stop")
      self._thread = None

  def Submit(self, prompt, max_new_tokens: Optional[int] = None,
             eos_id=_END) -> StreamHandle:
    """Queues a request; returns its streaming handle immediately."""
    max_new = max_new_tokens or self.default_max_new
    eos = self.eos_id if eos_id is _END else eos_id
    with self._lock:
      self._seq_counter += 1
      req_id = self._seq_counter
      req = scheduler_lib.Request(req_id, prompt, max_new, eos)
      total = len(req.prompt) + req.max_new
      if self.sched.needs_kv_pages and (
          self.alloc.PagesFor(total) > self.alloc.num_pages):
        raise ValueError(
            f"request needs {self.alloc.PagesFor(total)} pages; the pool "
            f"only has {self.alloc.num_pages} — it could never be admitted")
      self.sched.Submit(req)
      handle = StreamHandle(req_id, time.perf_counter())
      self._handles[req_id] = handle
      self._work.notify_all()
    return handle

  def _Loop(self):
    while True:
      with self._lock:
        if not self._running:
          return
        if not self.sched.HasWork():
          self._work.wait(timeout=0.05)
          continue
      self.StepOnce()

  # -- core step (shared by sync and async modes) ----------------------------

  def StepOnce(self) -> int:
    """One admit -> device step -> commit iteration through the step
    mode's program; returns the number of committed-token events."""
    if self.step_mode == "legacy":
      return self._StepOnceLegacy()
    with self._lock:
      self.sched.Admit()
      batch = self.sched.BuildRaggedStep(self._ragged_t, self._ragged_wmax)
      if batch is None:
        return 0
      tables = np.array(self.sched.block_tables)  # freeze under the lock
    dev = self.device
    rows = ragged_lib.ToTorch(batch.rows_desc, dev)
    with torch.no_grad(), self._Theta():
      logits, self._states = self._task.RaggedStep(
          torch.as_tensor(batch.tok_ids).to(dev)[None], self._states,
          torch.as_tensor(tables).to(dev), rows)
      sampled = sampling.SampleFromLogits(logits[0],
                                          temperature=self.temperature)
    sampled = sampled.cpu().numpy()
    with self._lock:
      events = self.sched.CommitRaggedStep(batch, sampled)
      self._Count(batch, events)
    return len(events)

  def _StepOnceLegacy(self) -> int:
    """One admit -> [B, C] PagedStep -> commit iteration (the reference
    `_StepOnceLegacy`, without speculation): greedy draws per column."""
    with self._lock:
      self.sched.Admit()
      batch = self.sched.BuildStep(self.prefill_chunk)
      if batch is None:
        return 0
      tables = np.array(self.sched.block_tables)  # freeze under the lock
    on_dev = lambda a: torch.as_tensor(a).to(self.device)
    with torch.no_grad(), self._Theta():
      logits, self._states = self._task.PagedStep(
          on_dev(batch.ids), self._states, on_dev(tables),
          on_dev(batch.q_pos), on_dev(batch.in_len))
      sampled = sampling.SampleFromLogits(logits,
                                          temperature=self.temperature)
    sampled = sampled.cpu().numpy()
    with self._lock:
      events = self.sched.CommitStep(batch, sampled)
      self._Count(batch, events)
    return len(events)

  def _Theta(self):
    """The context a step runs in: the int8 serving theta active, or the
    task's own parameters."""
    return (self._served.Active() if self._served is not None
            else contextlib.nullcontext())

  def _Count(self, batch, events):
    """Counts a committed step and streams its events (caller holds the
    lock)."""
    self._counters["steps"] += 1
    self._counters["mixed_steps" if batch.mixed else "decode_steps"] += 1
    self._counters["prompt_tokens"] += batch.prompt_tokens
    if self._kv_quantized:
      self._counters["quantized_steps"] += 1
    self._PushEvents(events)

  def _PushEvents(self, events):
    """Streams committed tokens to their handles (caller holds the lock)."""
    for req_id, tok, finished in events:
      self._counters["tokens_emitted"] += 1
      h = self._handles.get(req_id)
      if h is None:
        continue
      h._Push(tok)
      if finished:
        h._Finish(self.sched._by_id[req_id].finish_reason)

  # -- sync mode ---------------------------------------------------------------

  def RunBatch(self, prompts: np.ndarray, prompt_lens: np.ndarray,
               max_new_tokens: Optional[int] = None) -> np.ndarray:
    """Decodes a fixed prompt set inline; returns [B, max_new] int32.

    eos is ignored here: every request decodes exactly max_new tokens."""
    if self._thread is not None:
      raise RuntimeError("RunBatch drives the loop inline; Stop() first")
    prompts = np.asarray(prompts)
    max_new = max_new_tokens or self.default_max_new
    handles = []
    for i in range(prompts.shape[0]):
      ln = int(prompt_lens[i])
      handles.append(self.Submit(prompts[i, :ln], max_new, eos_id=None))
    while True:
      with self._lock:
        if not self.sched.HasWork():
          break
      self.StepOnce()
    out = np.zeros((prompts.shape[0], max_new), np.int32)
    for i, h in enumerate(handles):
      toks = h.Result(timeout=0)
      out[i, :len(toks)] = toks
    return out

  # -- introspection ---------------------------------------------------------

  def Stats(self) -> dict:
    """Atomic engine snapshot; its keys are a subset of the reference's."""
    with self._lock:
      stats = dict(self._counters)
      stats["paged_path"] = self.paged_path
      stats["kv_cache_dtype"] = self.kv_cache_dtype
      stats["kv_bytes_per_token"] = self.kv_bytes_per_token
      stats["serve_int8_weights"] = self.serve_int8_weights
      stats["scheduler"] = self.sched.Stats()
      stats["kv_pages"] = self.alloc.Stats()
      stats["mixers"] = dict(self.mixers)
      if self.state_pool is not None:
        stats["state_slots"] = self.state_pool.Stats()
    return stats
