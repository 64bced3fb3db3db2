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
  prefill_token_budget fixed at construction, as in the reference's one
  compiled step; the attention read is the ragged kernel. Each slot with
  tokens in the step draws one token, at its last token's column, with
  its stream: the one the commit reads.
- 'legacy': every iteration is a [B, C] step through `PagedStep`
  (scheduler.BuildStep): C = 1 when every live row decodes, and the
  attention read is the block-decode kernel (ops/block_decode.py); C =
  prefill_chunk when a row is still prefilling, and the read is the plain
  `BlockPrefill`. Each row with input draws at its last input column.

Sampling (core/sampling.py): temperature 0 (the default) is the argmax.
With temperature > 0 (and an optional top_k) each request samples from
its own stream: the draw at output position t of a request with seed s
is a pure function of (engine sample_seed, s, t), so a continuation is
replayable whichever slot or batch neighbours the scheduler gave it. On
the card the draw is one launch of the sampling kernel a step, of at most
max_batch rows (ops/sample_tokens.py).

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

A stack with an attention layer the paged kernels do not serve (a logit
cap, or on the card a shape outside the step mode's kernel limits) runs
the layers' gather-dense fallback, exactly, but without the paged read:
`paged_path` is then 'dense' and every step counts in
`dense_fallback_steps`, as in the reference, so the fallback is never
silent.

int8 weights (`serve_int8_weights=True`, quant/weights.py): the engine
rewrites the task's theta once, at construction, into `Int8Weight`
leaves (per-channel scales, one set per repeat layer) and binds it to the
task for its own steps (`base_layer.ServedTheta`): every projection of a
step, the tied logits included, runs the int8 matmul
(ops/int8_matmul.py). The task's float parameters stay as they are, so a
float engine or a trainer on the same task computes what it did. `Stats()`
reports `serve_int8_weights`.

bfloat16 activations (a task at fprop_dtype=bfloat16, the reference's
training recipe): the engine casts the task's weights (or their int8
rewrite's scales) to bfloat16 once, at construction, and binds them the
same way, so a step copies no weight; with `kv_cache_dtype` unset the
pools are bfloat16, as the reference allocates them in the fprop dtype.
The attention kernels take the bfloat16 q and write a bfloat16 output.

`UpdateTheta(theta)` swaps the served weights between steps: the new
values are copied into the task's parameters in place (and the int8
rewrite or the bfloat16 cast is redone); in-flight sequences go on under
the new weights, as in the reference.

Ported: both step modes, fifo scheduling, greedy and seeded temperature /
top-k sampling, float32 and bfloat16 activations, float32, bfloat16 and
int8 KV pools, int8 weights, cancellation, the hot weight swap, the
prefill token budget and the gather-dense fallback.
Speculative decoding, the prefix cache and priority scheduling raise
NotImplementedError naming the slice that brings them; so does int8
serving of a stack with SSM mixers, which the reference cannot run
either.

Two front doors, as in the reference:
- async: `Start()` + `Submit(prompt, max_new) -> StreamHandle`, tokens
  stream out per request as they are committed; `Cancel()` mid-flight;
  `Stop()` drains, `Stop(drain=False)` cancels what is left.
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
from lingvo_tpu_torch.core import threefry
from lingvo_tpu_torch.core.nested_map import NestedMap
from lingvo_tpu_torch.quant import kv as kv_quant
from lingvo_tpu_torch.quant import weights as quant_weights
from lingvo_tpu_torch.serving import kv_cache
from lingvo_tpu_torch.serving import scheduler as scheduler_lib
from lingvo_tpu_torch.serving import spec_decode

_END = object()   # stream sentinel


class StreamHandle:
  """Per-request streaming output + lifecycle handle."""

  def __init__(self, req_id, engine, submit_time: float):
    self.id = req_id
    self._engine = engine
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

  def Cancel(self) -> bool:
    return self._engine.Cancel(self.id)

  @property
  def done(self) -> bool:
    return self._done.is_set()


_COUNTER_KEYS = ("steps", "decode_steps", "mixed_steps", "tokens_emitted",
                 "prompt_tokens", "quantized_steps", "dense_fallback_steps")


class ServingLoop:
  """Continuous-batching decode service over a block-table page pool."""

  def __init__(self, task, *, page_size: int, num_pages: int,
               max_batch: int, max_seq_len: int, prefill_chunk: int = 8,
               default_max_new: int = 32, eos_id: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0,
               sample_seed: int = 0,
               kv_cache_dtype: Optional[str] = None,
               serve_int8_weights: bool = False, spec=None,
               prefix_cache=None, step_mode: str = "ragged",
               prefill_token_budget: Optional[int] = None,
               scheduler_mode: str = "fifo", device=None):
    """task: a TransformerLm (exposing InitPagedDecodeState, RaggedStep
    and PagedStep) that holds its weights on `device`. num_pages:
    allocator-owned pages (the device pool gets one extra trash page).
    max_seq_len: static per-sequence capacity (block-table width =
    ceil(max_seq_len / page_size)). prefill_chunk: the width C of a
    legacy mixed step, and the default prefill_token_budget.
    temperature / top_k / sample_seed: sampling controls (the module
    docstring); temperature <= 0 is the argmax and draws nothing.
    step_mode: 'ragged' or 'legacy' (see the module docstring).
    prefill_token_budget: ragged mode only, the prompt tokens the packed
    step reserves beyond one token per slot (None: prefill_chunk); decode
    capacity left idle by empty slots flows to prefill on top of it.
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
    if serve_int8_weights:
      quant_weights.CheckInt8Servable(task)
    # the int8 rewrite, or the bfloat16 cast of the weights of a task at
    # fprop_dtype=bfloat16, made once here and bound for the steps (None:
    # the task's parameters serve as they are)
    self._served = quant_weights.ServingTheta(task, self.serve_int8_weights)
    self._serves_theta = self._served is not None
    self.step_mode = step_mode
    self.prefill_chunk = prefill_chunk
    self.page_size = page_size
    self.num_pages = num_pages
    self.max_batch = max_batch
    self.default_max_new = default_max_new
    self.eos_id = eos_id
    self.temperature = float(temperature)
    self.top_k = int(top_k)
    self.sample_seed = int(sample_seed)
    self._key = threefry.PRNGKey(self.sample_seed)   # on the host
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
    # plus the prefill token budget; wmax is the widest row
    self.prefill_token_budget = int(prefill_token_budget or prefill_chunk)
    self._ragged_t = max_batch + self.prefill_token_budget
    self._ragged_wmax = max(1, self.prefill_token_budget)
    self.paged_path = self._ClassifyPath(kv_cache_dtype, max_seq_len)
    self._counters = {k: 0 for k in _COUNTER_KEYS}
    self._handles: dict = {}
    self._lock = threading.RLock()
    # held by a step's device work and by UpdateTheta's copy (taken before
    # _lock there; a step never holds both), so a swap lands between steps
    self._theta_lock = threading.Lock()
    self._work = threading.Condition(self._lock)
    self._thread: Optional[threading.Thread] = None
    self._running = False
    self._seq_counter = 0

  def _ClassifyPath(self, kv_cache_dtype, max_seq_len: int) -> str:
    """What the step's paged attention lowers to (the reference's
    `_ClassifyPath`): 'cuda' (the kernels) or 'plain' (their plain
    versions, on the CPU), with '-int8' on an int8 pool; 'dense' when any
    attention layer takes the gather-dense fallback, as its own gate
    decides for this engine's step mode, page size, pool dtype and table
    width (`MultiHeadedAttention.BlockDecodeEligible`); 'ssm' with no
    attention layer, when the page pool is never read."""
    attens = [m for m, _ in spec_decode.MixerLayers(self._task)
              if not hasattr(m, "StateBytesPerSlot")]
    if not attens:
      return "ssm"
    t_pages = self.alloc.PagesFor(max_seq_len)
    for a in attens:
      dtype = getattr(torch, a.KvCacheDtype(kv_cache_dtype))
      if not a.BlockDecodeEligible(self.page_size, dtype, t_pages,
                                   ragged=self.step_mode == "ragged"):
        return "dense"
    return ("cuda" if self.device.type == "cuda" else "plain") + (
        "-int8" if self._kv_quantized else "")

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

  def Stop(self, drain: bool = True, timeout: float = 60.0):
    """drain=True finishes in-flight and queued work first; drain=False
    cancels it. Then stops the loop thread."""
    with self._lock:
      if not self._running:
        return
      if not drain:
        for h in list(self._handles.values()):
          if not h.done:
            self.Cancel(h.id)   # RLock: reentrant under self._lock
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
             eos_id=_END, seed: Optional[int] = None) -> StreamHandle:
    """Queues a request; returns its streaming handle immediately.

    seed: the request's sampling seed (default: its request id), seen only
    at temperature > 0: the same seed gives the same continuation."""
    max_new = max_new_tokens or self.default_max_new
    eos = self.eos_id if eos_id is _END else eos_id
    with self._lock:
      self._seq_counter += 1
      req_id = self._seq_counter
      req = scheduler_lib.Request(req_id, prompt, max_new, eos, seed=seed)
      total = len(req.prompt) + req.max_new
      if self.sched.needs_kv_pages and (
          self.alloc.PagesFor(total) > self.alloc.num_pages):
        raise ValueError(
            f"request needs {self.alloc.PagesFor(total)} pages; the pool "
            f"only has {self.alloc.num_pages} — it could never be admitted")
      self.sched.Submit(req)
      handle = StreamHandle(req_id, self, time.perf_counter())
      self._handles[req_id] = handle
      self._work.notify_all()
    return handle

  def Cancel(self, req_id) -> bool:
    """Cancels a request: a queued one at once, an admitted one at the
    next step boundary (its slot and pages come back then, and a token of
    the step in flight is dropped). Its handle finishes with reason
    "cancelled". False when it is unknown or already done."""
    with self._lock:
      ok = self.sched.Cancel(req_id)
      if ok:
        h = self._handles.get(req_id)
        if h is not None and not h.done:
          h._Finish("cancelled")
      return ok

  def UpdateTheta(self, theta, persist_prefix: Optional[bool] = None):
    """Hot-swaps the served weights. theta: a tree with the structure of
    the task's `ThetaTree()` (tensors of the parameters' shapes; a repeat
    stack's leaf a `StackedLeaf` or one tensor stacked on a leading layer
    axis); its values are copied into the task's parameters in place,
    between steps.
    Under serve_int8_weights the int8 rewrite is redone from them; if
    that raises, every step raises until an UpdateTheta succeeds.
    At fprop_dtype=bfloat16 the weights' bfloat16 cast is redone from
    them. In-flight sequences continue under the new weights.
    persist_prefix says whether a prefix cache keeps its pages across the
    swap; the engine has no prefix cache, so the flag has no effect, as
    in the reference's engine without one."""
    del persist_prefix   # read only by a prefix cache
    new = dict(NestedMap(theta).FlattenItems())
    own = dict(self._task.ThetaTree().FlattenItems())
    if sorted(new) != sorted(own):
      raise ValueError(
          f"UpdateTheta takes the task's ThetaTree structure: missing "
          f"{sorted(set(own) - set(new))}, unknown "
          f"{sorted(set(new) - set(own))}")
    for key, prm in own.items():
      if tuple(new[key].shape) != tuple(prm.shape):
        raise ValueError(f"UpdateTheta: {key} has shape "
                         f"{tuple(new[key].shape)}, the task's "
                         f"{tuple(prm.shape)}")
    with self._theta_lock, self._lock, torch.no_grad():
      for key, prm in own.items():
        if isinstance(prm, base_layer.StackedLeaf):
          src = new[key]
          src = src.layers if isinstance(src, base_layer.StackedLeaf) else src
          for i, layer in enumerate(prm.layers):
            layer.copy_(torch.as_tensor(src[i]))
        else:
          prm.copy_(torch.as_tensor(new[key]))
      if self._serves_theta:
        # one served copy on the card at a time: the old one goes first,
        # and until the new one is built every step raises (_CheckServed)
        # rather than serve the task's own parameters
        self._served = None
        self._served = quant_weights.ServingTheta(self._task,
                                                  self.serve_int8_weights)

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
    self._CheckServed()   # before the step takes anything from the queue
    if self.step_mode == "legacy":
      return self._StepOnceLegacy()
    with self._lock:
      self.sched.EvictCancelled()
      self.sched.Admit()
      batch = self.sched.BuildRaggedStep(self._ragged_t, self._ragged_wmax)
      if batch is None:
        return 0
      tables = np.array(self.sched.block_tables)  # freeze under the lock
    dev = self.device
    desc = batch.rows_desc
    rows = ragged_lib.ToTorch(desc, dev)
    # each slot with tokens this step draws at its last token's column,
    # the one CommitRaggedStep reads
    live = np.nonzero(desc.row_len > 0)[0]
    cols = desc.row_cols[live, desc.row_len[live] - 1]
    folds = self._Folds(batch, live, cols)
    with self._theta_lock, torch.no_grad(), self._Theta():
      logits, self._states = self._task.RaggedStep(
          torch.as_tensor(batch.tok_ids).to(dev)[None], self._states,
          torch.as_tensor(tables).to(dev), rows)
      sampled = self._Sample(logits[0], folds)
    sampled = self._Scatter(sampled, folds, cols, (len(batch.tok_ids),))
    with self._lock:
      events = self.sched.CommitRaggedStep(batch, sampled)
      self._Count(batch, events)
    return len(events)

  def _StepOnceLegacy(self) -> int:
    """One admit -> [B, C] PagedStep -> commit iteration (the reference
    `_StepOnceLegacy`, without speculation): a draw per column."""
    with self._lock:
      self.sched.EvictCancelled()
      self.sched.Admit()
      batch = self.sched.BuildStep(self.prefill_chunk)
      if batch is None:
        return 0
      tables = np.array(self.sched.block_tables)  # freeze under the lock
    on_dev = lambda a: torch.as_tensor(a).to(self.device)
    # each row with input draws at its last input column, the one
    # CommitStep reads, as a row of the [B x C, V] logits
    b, c = batch.ids.shape
    live = np.nonzero(batch.in_len > 0)[0]
    cols = live * c + batch.in_len[live] - 1
    folds = self._Folds(batch, live, cols)
    with self._theta_lock, torch.no_grad(), self._Theta():
      logits, self._states = self._task.PagedStep(
          on_dev(batch.ids), self._states, on_dev(tables),
          on_dev(batch.q_pos), on_dev(batch.in_len))
      sampled = self._Sample(
          logits if folds is None else logits.reshape(b * c, -1), folds)
    sampled = self._Scatter(sampled, folds, cols, (b, c))
    with self._lock:
      events = self.sched.CommitStep(batch, sampled)
      self._Count(batch, events)
    return len(events)

  def _Folds(self, batch, live, cols):
    """The step's draws on the device, [B', 3] int32: for each slot in
    `live` its seed, its output position and `cols`, the row of the
    step's flattened logits it draws; None at temperature 0 (or with
    nothing to draw). One copy, made with the step's other inputs before
    the forward is enqueued, so that it does not wait on the forward."""
    if self.temperature <= 0.0 or not len(live):
      return None
    folds = np.stack([batch.row_seeds[live], batch.row_pos[live], cols],
                     axis=1)
    return torch.as_tensor(folds.astype(np.int32)).to(self.device)

  def _Sample(self, logits, folds):
    """The argmax of every row of logits [..., V] at temperature 0 (or
    with no folds), else one seeded draw of each row folds[:, 2] of
    logits [N, V] with its stream (folds[:, 0] the seed, folds[:, 1] the
    position)."""
    if folds is None:
      return sampling.SampleFromLogits(logits)
    return sampling.SampleFromLogits(
        logits, self._key, self.temperature, self.top_k,
        row_seeds=folds[:, 0], positions=folds[:, 1], rows=folds[:, 2])

  def _Scatter(self, sampled, folds, cols, shape):
    """The step's tokens as the host array of `shape` its commit reads:
    the argmax's as they are, or the draws at the flat positions `cols`
    (the rest 0, never read). A draw of -1 (the kernel's mark of a row
    index outside the logits) raises."""
    sampled = sampled.cpu().numpy()
    if folds is None:
      return sampled
    if (sampled < 0).any():
      raise RuntimeError(f"the step drew token -1 (rows {cols.tolist()} of "
                         f"{int(np.prod(shape))})")
    out = np.zeros(shape, np.int32)
    out.reshape(-1)[cols] = sampled
    return out

  def _Theta(self):
    """The context a step runs in: the served theta (int8, or cast to
    bfloat16) active, or the task's own parameters."""
    if not self._serves_theta:
      return contextlib.nullcontext()
    self._CheckServed()
    return self._served.Active()

  def _CheckServed(self):
    """Raises while an engine that serves a theta of its own has none
    (the rewrite or cast of its last UpdateTheta failed)."""
    if self._serves_theta and self._served is None:
      what = "int8 rewrite" if self.serve_int8_weights else "bfloat16 cast"
      raise RuntimeError(
          f"the engine serves its own theta and the {what} of the last "
          "UpdateTheta failed; call UpdateTheta again")

  def _Count(self, batch, events):
    """Counts a committed step and streams its events (caller holds the
    lock)."""
    self._counters["steps"] += 1
    self._counters["mixed_steps" if batch.mixed else "decode_steps"] += 1
    self._counters["prompt_tokens"] += batch.prompt_tokens
    if self.paged_path == "dense":
      self._counters["dense_fallback_steps"] += 1
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
