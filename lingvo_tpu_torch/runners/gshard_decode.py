"""GShard decode job: batch-synchronous LM decode on every new checkpoint (port of lingvo_tpu/runners/gshard_decode.py).

A job that watches a trainer's checkpoint directory and, for every new
checkpoint, continues a fixed prompt set with the LM and appends the
results to a JSONL file. Per `DecodeOnce`:

- the prompts are RIGHT-aligned to a bucketed width P (`_RightAlign`,
  `py_utils.RoundUpToBucket` over `len_buckets`): row i's prompt sits in
  cache slots [P - len_i, P) and the left-pad slots are masked forever
  through `cache_paddings`, so every row samples from slot P on; rotary
  attention depends only on relative position, so the numerics match an
  unpadded batch;
- init: a dense KV cache of P + max_decode_steps slots per layer
  (`TransformerLm.InitDecodeState`);
- prefill: the prompt primes the cache through `TransformerLm.Prefill`,
  `prefill_chunk_size` tokens per pass (0 = the whole prompt), each pass
  reading only the written prefix (live_len); `use_legacy_prime=True`
  primes it one `ExtendStep` per token instead (the A/B reference);
- sample: max_decode_steps draws, each fed back through `ExtendStep`,
  whose read is the paged flash-decode kernel when the attention template
  sets `decode_page_size`. Greedy at temperature 0; at temperature > 0
  (and an optional top_k) the step keys are Split(PRNGKey(restored
  step), max_decode_steps) and row i draws from FoldIn(keys[t], i), the
  first draw from the prefill's last logits with keys[0], so a row's
  continuation does not depend on its batch neighbours.

The three phases of one (P, max_decode_steps) pair are built once and
reused by every call that buckets to it (`_decode_fns`). The telemetry of
the last call is a plain dict with the reference schema's keys
(`GSHARD_TELEMETRY_KEYS`, copied); prefill_s and decode_s are wall times
taken after the card has finished each phase.

`serve_int8_weights=True` decodes on an int8 rewrite of each restored
theta (quant/weights.py): every projection, the tied logits included,
runs the int8 matmul (ops/int8_matmul.py). The rewrite is built once per
restored checkpoint step and bound to the task for the decode only
(`base_layer.ServedTheta`); the task's float parameters stay as
restored. A task at fprop_dtype=bfloat16 decodes bfloat16 activations:
its weights (or the int8 rewrite's scales) are cast to bfloat16 once per
restored step and bound the same way, and its caches are bfloat16 unless
`kv_cache_dtype` says otherwise.

The status server (serve_port) raises NotImplementedError naming the
slice that brings it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch

from lingvo_tpu_torch.core import checkpointer as checkpointer_lib
from lingvo_tpu_torch.core import py_utils
from lingvo_tpu_torch.core import sampling
from lingvo_tpu_torch.core import threefry
from lingvo_tpu_torch.quant import kv as kv_quant
from lingvo_tpu_torch.quant import weights as quant_weights

# Decode shape buckets (slots, ascending). Wider prompts run at their
# exact width.
DEFAULT_LEN_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)

# The reference observe/schema.py GSHARD_TELEMETRY_KEYS, in its order.
GSHARD_TELEMETRY_KEYS = (
    "prefill_s", "decode_s", "total_s",
    "prompt_tokens", "decode_tokens", "tokens_per_sec",
    "decode_state_bytes_per_seq",
    "kv_cache_dtype", "kv_bytes_per_token", "serve_int8_weights",
    "draft_tokens", "accepted_tokens", "accepted_len_hist",
    "spec_branches", "spec_width_clamps", "accepted_depth_hist",
    "prefix_hit_tokens", "prefix_cache", "step_programs",
    "preemptions", "spilled_pages", "restored_pages", "host_bytes",
)

# The prefix_cache section of a surface without a prefix cache (the
# reference schema's DisabledPrefixCacheStats).
_PREFIX_CACHE_KEYS = ("cached_pages", "cached_tokens", "cow_copies",
                      "evictions", "hit_tokens", "hits", "misses",
                      "refreshed_pages", "stale_pages")


class GShardDecode:
  """Streams LM continuations of a fixed prompt set on every checkpoint."""

  def __init__(self, task, train_dir: str, output_path: str,
               max_decode_steps: int = 32, temperature: float = 0.0,
               top_k: int = 0, poll_interval_secs: float = 10.0,
               timeout_secs: float = 3600.0,
               prefill_chunk_size: int = 0,
               use_legacy_prime: bool = False,
               serve_int8_weights: bool = False,
               len_buckets=DEFAULT_LEN_BUCKETS,
               serve_port=None):
    """task: a TransformerLm (InitDecodeState / Prefill / ExtendStep) on
    the device to decode on; each DecodeOnce restores a checkpoint of the
    port's format (core/checkpointer.py) into it. temperature / top_k:
    sampling controls (core/sampling.py); temperature <= 0 is the argmax.
    prefill_chunk_size:
    prompt tokens per prefill pass (0 = the whole prompt).
    use_legacy_prime: prime the cache with one ExtendStep per prompt token
    instead. serve_int8_weights: decode on an int8 rewrite of each
    restored theta. len_buckets: prompt-width buckets."""
    if serve_int8_weights:
      quant_weights.CheckInt8Servable(task)
    if serve_port is not None:
      raise NotImplementedError(
          "the status server (serve_port) comes with the observability "
          "slice of the port (ROADMAP item 11)")
    self._task = task
    self._train_dir = train_dir
    self._output_path = output_path
    self._max_steps = max_decode_steps
    self._temperature = float(temperature)
    self._top_k = int(top_k)
    self._checkpointer = checkpointer_lib.Checkpointer(train_dir)
    self._poll_interval = poll_interval_secs
    self._timeout = timeout_secs
    self._last_step = -1
    self._prefill_chunk = prefill_chunk_size
    self._use_legacy_prime = use_legacy_prime
    self._len_buckets = tuple(len_buckets)
    self._serve_int8_weights = bool(serve_int8_weights)
    # (checkpoint step, its ServedTheta): the int8 rewrite, or the bfloat16
    # cast of a task at fprop_dtype=bfloat16, runs once per restored step
    self._served = None
    # (init_fn, prefill_fn, sample_fn) per bucketed (p_len, t_max)
    self._decode_fns = {}
    self._last_telemetry = None

  def _GetDecodeFn(self, p_len: int, t_max: int):
    """(init_fn, prefill_fn, sample_fn) for a (p_len, t_max) pair."""
    cache_key = (p_len, t_max)
    if cache_key in self._decode_fns:
      return self._decode_fns[cache_key]
    task = self._task
    total = p_len + t_max
    chunk = self._prefill_chunk if self._prefill_chunk > 0 else p_len
    legacy_prime = self._use_legacy_prime
    temp, top_k = self._temperature, self._top_k

    def _Init(batch_size):
      return task.InitDecodeState(batch_size, total)

    def _CachePaddings(prompt_lens):
      # slot s is pad for row i iff s < P - len_i
      slot = torch.arange(total, device=prompt_lens.device)[None, :]
      return (slot < (p_len - prompt_lens)[:, None]).float()   # [B, total]

    def _Prefill(prompts, prompt_lens, states):
      """prompts [B, P] right-aligned -> (last logits [B, V], states)."""
      cache_paddings = _CachePaddings(prompt_lens)
      if legacy_prime:
        for t in range(p_len):
          logits, states = task.ExtendStep(prompts[:, t:t + 1], states,
                                           cache_paddings=cache_paddings)
        return logits, states
      for start in range(0, p_len, chunk):
        ids_c = prompts[:, start:start + chunk]
        chunk_logits, states = task.Prefill(
            ids_c, states, cache_paddings=cache_paddings,
            live_len=start + ids_c.shape[1])
      return chunk_logits[:, -1, :], states

    def _SampleLoop(last_logits, prompt_lens, key, states):
      """Draws fed back t_max times -> continuations [B, t_max]; row i of
      step t draws from FoldIn(Split(key, t_max)[t], i)."""
      cache_paddings = _CachePaddings(prompt_lens)
      keys = rows = None
      if temp > 0.0:   # greedy draws nothing at random
        keys = threefry.Split(key, t_max)
        rows = torch.arange(last_logits.shape[0], dtype=torch.int32,
                            device=last_logits.device)
      logits, out = last_logits, []
      for t in range(t_max):
        nxt = sampling.SampleFromLogits(
            logits, None if keys is None else keys[t], temp, top_k,
            row_seeds=rows)
        out.append(nxt)
        logits, states = task.ExtendStep(nxt[:, None], states,
                                         cache_paddings=cache_paddings)
      return torch.stack(out, dim=1)

    fns = (_Init, _Prefill, _SampleLoop)
    self._decode_fns[cache_key] = fns
    return fns

  @staticmethod
  def _RightAlign(prompts: np.ndarray, prompt_lens: np.ndarray,
                  width: int | None = None) -> np.ndarray:
    """Shifts each row's first len_i tokens to the row's END (left-pad).

    width: output row width (>= prompts.shape[1]; defaults to it), the
    bucketed prompt width, with the bucketing pad folded into the
    left-pad."""
    prompts = np.asarray(prompts)
    p = prompts.shape[1]
    w = p if width is None else int(width)
    if w < p:
      raise ValueError(f"width {w} is narrower than the prompts' {p}")
    out = np.zeros((prompts.shape[0], w), prompts.dtype)
    lens = np.asarray(prompt_lens)
    if lens.shape[0] != prompts.shape[0] or (lens < 0).any() or (
        lens > p).any():
      rng = f"[{lens.min()}, {lens.max()}]" if lens.size else "[]"
      raise ValueError(
          f"prompt_lens must be [batch={prompts.shape[0]}] with values in "
          f"[0, {p}]; got shape {lens.shape}, values in {rng}")
    for i, ln in enumerate(lens):
      ln = int(ln)
      out[i, w - ln:] = prompts[i, :ln]
    return out

  def _Sync(self):
    if self._task.device.type == "cuda":
      torch.cuda.synchronize(self._task.device)

  def DecodeOnce(self, step: int, prompts: np.ndarray,
                 prompt_lens: np.ndarray) -> list:
    """Restores checkpoint `step` into the task, decodes max_decode_steps
    tokens after every prompt, appends one JSONL record per row to the
    output file and returns the records."""
    prompts = np.asarray(prompts)
    if prompts.shape[1] == 0:
      raise ValueError("prompts must have width >= 1 (got [B, 0]); the "
                       "prefill loop needs at least one chunk")
    _, restored = self._checkpointer.Restore(self._task, step=step)
    if self._served is None or self._served[0] != restored:
      self._served = None   # one served copy on the card at a time
      self._served = (restored, quant_weights.ServingTheta(
          self._task, self._serve_int8_weights))
    served = self._served[1]
    theta_ctx = (contextlib.nullcontext() if served is None
                 else served.Active())
    p_len = py_utils.RoundUpToBucket(prompts.shape[1], self._len_buckets)
    init_fn, prefill_fn, sample_fn = self._GetDecodeFn(p_len, self._max_steps)
    aligned = self._RightAlign(prompts, prompt_lens, width=p_len)
    b = prompts.shape[0]
    dev = self._task.device
    states = init_fn(b)
    # decode-state bytes per sequence: KV caches grow with p_len +
    # max_decode_steps
    state_bytes = sum(x.numel() * x.element_size() for x in states.Flatten()
                      if isinstance(x, torch.Tensor))
    lens_dev = torch.as_tensor(np.asarray(prompt_lens)).to(dev)
    self._Sync()
    with theta_ctx:
      t0 = time.perf_counter()
      last_logits, states = prefill_fn(torch.as_tensor(aligned).to(dev),
                                       lens_dev, states)
      self._Sync()
      t1 = time.perf_counter()
      out = sample_fn(last_logits, lens_dev, threefry.PRNGKey(restored),
                      states)
      self._Sync()
      t2 = time.perf_counter()
    out = out.cpu().numpy()
    self._last_step = restored
    decode_s = t2 - t1
    # the KV census: a bfloat16 or int8 cache is never silent (None / 0
    # for a task without an LM stack)
    census = kv_quant.StackKvCensus(self._task) or {}
    telemetry = dict(
        prefill_s=t1 - t0,
        decode_s=decode_s,
        total_s=t2 - t0,
        prompt_tokens=int(np.sum(prompt_lens)),
        decode_tokens=b * self._max_steps,
        tokens_per_sec=(b * self._max_steps / decode_s
                        if decode_s > 0 else 0.0),
        decode_state_bytes_per_seq=state_bytes // b,
        kv_cache_dtype=census.get("kv_cache_dtype"),
        kv_bytes_per_token=census.get("kv_bytes_per_token", 0),
        serve_int8_weights=self._serve_int8_weights,
        # batch-synchronous decode drafts nothing, caches no prefix and
        # never preempts: the shared serving keys are zero here
        draft_tokens=0, accepted_tokens=0, accepted_len_hist=[],
        spec_branches=0, spec_width_clamps=0, accepted_depth_hist=[],
        prefix_hit_tokens=0,
        prefix_cache=dict({k: 0 for k in _PREFIX_CACHE_KEYS}, enabled=False),
        # a (prefill, sample) pair per (p_len, t_max) bucket
        step_programs=2 * len(self._decode_fns),
        preemptions=0, spilled_pages=0, restored_pages=0, host_bytes=0)
    self._last_telemetry = telemetry
    results = []
    with open(self._output_path, "a") as f:
      for i in range(b):
        rec = {
            "checkpoint_step": int(restored),
            "prompt_ids": [int(x) for x in prompts[i, :int(prompt_lens[i])]],
            "output_ids": [int(x) for x in out[i]],
            "telemetry": telemetry,
        }
        f.write(json.dumps(rec) + "\n")
        results.append(rec)
    return results

  def Run(self, prompts: np.ndarray, prompt_lens: np.ndarray,
          max_steps: int | None = None):
    """Polls for new checkpoints and decodes each, until a step >=
    max_steps (the reference reads the task's train.max_steps, which the
    port's train params do not carry; None = no step limit), a FINISHED
    marker in train_dir, or timeout_secs without a new checkpoint."""
    finished = os.path.join(self._train_dir, "FINISHED")
    last_new = time.time()
    try:
      while True:
        latest = self._checkpointer.LatestStep()
        if latest is not None and latest > self._last_step:
          self.DecodeOnce(latest, prompts, prompt_lens)
          last_new = time.time()
          print(f"[gshard_decode] decoded @ step {latest}", flush=True)
          if ((max_steps is not None and latest >= max_steps)
              or os.path.exists(finished)):
            return
        elif os.path.exists(finished):
          return
        elif time.time() - last_new > self._timeout:
          return
        else:
          time.sleep(self._poll_interval)
    finally:
      self._checkpointer.Close()
