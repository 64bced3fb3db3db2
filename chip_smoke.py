#!/usr/bin/env python3
"""Drives the lingvo_tpu_torch port on one NVIDIA GPU, phase by phase.

    python3 chip_smoke.py

1. Versions, the card's name and power limit, the TF32 flags (off).
2. Builds every CUDA kernel of the port from the sources in this checkout,
   one nvcc per source, all started together; prints each build's seconds
   and ptxas registers, shared memory and spills.
3. Holds the ragged paged-attention kernel against its plain PyTorch
   version on the card, at the serving step's shapes (N=16, H=128, T=264,
   page_size 16 with 64-page tables, then page_size 128; then H=64, the
   hybrid's heads, at page_size 16), on a pack of decode rows, two prefill
   chunks, a tree row with real ancestor masks and padding tokens, with
   freed pages, stale slots and table entries past each row's pages
   poisoned with NaN; then at page 16, H=128 on a decode-only pack (8
   live tokens, 256 padding) and on a pack of tile edges (a prefill chunk
   across a 16-token tile edge; a tree row and a short prefill inside one
   tile, which would otherwise cross three rows). Tolerance: float32, max
   abs difference <= 1e-5; two calls bitwise equal; the card's tile
   schedule equal to `TileSchedule`. Prints the schedule's tiles and work
   items and the kernel's grid, threads, shared memory per block and
   resident blocks per SM. Times the kernel, the plain version and the
   bound.
4. Holds the chunked SSD-scan kernel against `_ChunkedPlain` on the card
   at the hybrid's serving shape ([8, 256, 16] with S = H = 64, chunk 64:
   rows of mixed live lengths padded as identity steps, a reset, a nonzero
   initial state), its training shape ([8, 1024, 16], two segments of
   512), a decode-only pack (every row 1 live step of 256, one row idle:
   3 of a row's 4 chunks are identity chunks) and a long T (1100: 18
   chunks, runs of 2 and 3 per cluster block): y and the final state
   finite and within 2e-5 x max(1, max|want|), two calls bitwise equal.
   Prints each launch's grid, cluster size, threads, shared memory per
   block, registers and spills (`ssd_scan.KernelGeometry`); times the
   kernel and the plain version beside two bounds: the full-work bound
   (every chunk's four products) and the live-work bound, the work this
   call's data needs (`_ScanLiveWork`: each chunk cut at its last nonzero
   v, the inter product only where the state can be nonzero), which is
   the `bound_ms` of the kernels line.
5. Serving main path: DenseLm1B at full width and depth (random weights
   from a seeded torch.Generator) through `ServingLoop`: 8 requests with
   prompts of 64..768 tokens, 32 new tokens each, through
   Start/Submit/Result/Stop. Checks the streams, and that the ragged kernel
   ran exactly 24 times per step and no other kernel ran. Before that, a
   DenseLmTiny engine on the card must reproduce the same model's CPU
   streams. After the counted run, the same requests are served again with
   torch.profiler on over the first 4 and the last 4 steps, which also
   counts the cudaStreamSynchronize calls per step.
6. Hybrid serving main path: DenseLmSsmHybridTiny on the card must
   reproduce its CPU streams; then DenseLmSsmHybrid at full width and
   depth (d 1024, 12 layers, attention every 6th, SSM state 64, chunk 64;
   random weights from a seeded torch.Generator) serves the same 8 requests
   through Start/Submit/Result/Stop. Checks exactly 10 scan and 2 ragged
   launches per step and no training kernel; prints ms/step, tok/s, TTFT,
   TPOT, peak memory and a torch.profiler split of busy time (GEMMs, scan,
   ragged, rest). Each serving model is freed before the next phase.
7. Holds the flash-attention forward, dK/dV and dQ kernels against the
   plain version at the training step's shapes ([8, 1024, 16, 128], causal,
   two segments of 512, one row ending in 100 padding tokens): out, lse,
   dq, dk, dv finite and within the printed tolerances, and two calls of
   each kernel bitwise equal; prints each kernel's grid, threads, shared
   memory per block and resident blocks per SM. Times each kernel, the plain
   version, the bound and SDPA with the same boolean mask.
8. Holds the fused-xent statistics kernel against `_PlainStats` at
   [8192, 2048] x [32000, 2048] (block 1280, cap 30), at block 1536
   with label smoothing 0.1 (a ragged vocab tail), at 8192 + 37 rows (a
   partial row tile) and in the [D, V] layout at V 31923 (a partial last
   vocab tile): lse, label logit and logit sum within tolerance, argmax
   equal except on near-ties, two calls bitwise equal. The vocab splits
   (7 tiles of 128 columns at the main shape) do not fall on the
   reference's block edges. Prints the grid (row tiles x vocab splits),
   threads, shared memory per block and resident blocks per SM.
9. Training main path: DenseLmTiny (flash on, xent block 1280, warmup 2)
   trains 3 steps on the card and on the CPU from the same weights (losses
   and theta within 1e-4); then DenseLm1B (flash on, xent block 1280,
   remat 'full', random weights from a seeded generator) through
   `TrainProgram` on `SyntheticLmInput(seed 0)`: 1 warm-up step, then 4
   counted steps with every kernel count set to 0 just before. Checks
   finite loss and grad_norm, no skipped step, and exactly 48 / 24 / 24 / 1
   launches per step of the flash forward, dK/dV, dQ and xent kernels (and
   0 of the ragged and scan kernels); prints ms per step, tokens per
   second, model FLOPs and achieved TFLOP/s, peak memory, and a
   torch.profiler breakdown of one more step.
10. Holds the block-decode kernel against its plain version on the card
   at the legacy serving step's shapes (q [8, 1, 16, 128], pools
   [513, 16, 16, 128], tables [8, 64]; seq_lens from 1 to 1024 and one
   inactive row), then at page 128 (pools [65, 128, 16, 128], tables
   [8, 8]), then on a decode-only pack shaped like phase 12's steps (8
   rows of phase 5's prompts, 64..768 tokens, plus 1..32 generated; page
   16, tables [8, 64]), with the pages and table entries past each row's
   last live page and the stale slots of that page poisoned with NaN.
   Tolerance 1e-5, two calls bitwise equal, one kernel node per call (a
   CUDA graph capture: the cluster merges its splits in the launch);
   prints the cluster size (`NumSplits`) and the launch geometry. Times
   the kernel, the plain version and the bound (library_ms null: no single
   PyTorch call reads block tables).
11. Holds the flash-decode kernel against its plain version at the
   GShardDecode step's shapes ([8, 1152, 16, 128], page 128, the left-pad
   cache paddings of the 8 prompts below in a 1024 bucket) at t = 1151 and
   t = 700. Tolerance 1e-5, and two calls bitwise equal; prints the split
   count at each t and the split kernel's grid, threads, shared memory per
   block and resident blocks per SM. Times the kernel, the plain version,
   the bound and SDPA over the whole cache with the same boolean mask.
12. Legacy serving main path: DenseLmTiny with step_mode='legacy' on the
   card must reproduce its CPU streams; then DenseLm1B (the weights of
   phase 5) through `ServingLoop(step_mode='legacy')` with phase 5's
   geometry and requests. Checks exactly 24 block-decode launches per
   decode-only step and none on mixed steps, no other kernel, and streams
   equal to phase 5's ragged streams; prints ms/step, tok/s and the
   profiled busy split of 4 decode-only steps.
13. GShardDecode main path: DenseLmTiny (decode_page_size 4) on the card
   must reproduce its CPU continuations from one port checkpoint; then
   DenseLm1B with decode_page_size 128: its random weights are written as
   a port checkpoint to a temporary directory (deleted at the end; write
   and read seconds printed) and `DecodeOnce` continues the 8 prompts
   (bucket 1024) by 128 tokens with prefill chunks of 256. Checks exactly
   24 x 128 = 3072 flash-decode launches and no other kernel; prints
   prefill_s, decode_s, tokens/s and peak memory; then prefills again (a
   1008 bucket, so the cache keeps 1024 slots) and profiles 16 decode
   steps (device busy per step, flash-decode share). First, the prefill's
   cache read (`attention._TileAttend`) at DenseLm1B's shapes: the last
   rows of a 256-query chunk must get bitwise the state of the same
   queries read as chunks of 130 and 2 (what makes a trimmed prefill
   equal the full read).
14. Holds the int8 and bfloat16 instantiations of the ragged kernel
   (phase 3's shapes and packs: page 16 and 128 at H = 128, page 16 at
   H = 64, the decode-only and tile-edge packs at page 16; the schedule
   and geometry of each instantiation printed as in phase 3) and
   of the block-decode kernel (phase 10's: page 16 and 128) against their
   plain versions. The pools are phase 3's and 10's, quantized per (slot,
   head) into int8 pools with [NP, N, P] scale sidecars, or rounded to
   bfloat16; every slot the read must skip (freed pages, table entries
   past a row's horizon, stale slots of its last page) holds a NaN scale
   and int8 values of 127 / -128, or a bfloat16 NaN. q and K are dyadic
   (`_Dyadic`: q.k exact in any summation order, so kernel and plain
   version round the same probabilities to bfloat16). Checks: within 1e-5
   of the plain version, two calls bitwise equal, the int8 kernel bitwise
   equal to the float32 kernel on the dequantized pool, and the float32
   kernel on the widened bfloat16 pools (a kernel that rounds no p) more
   than 1e-5 off the plain bfloat16 version; a block-decode call is one
   kernel node, and its cluster geometry is printed. Times
   each instantiation, the float32 kernel on the same pack, the plain
   version at the main shape, and the bound (1 byte per int8 element plus
   4 per live (slot, head) of each sidecar; 2 per bfloat16 element).
15. The flash-decode kernel on a bfloat16 cache against its plain version
   at phase 11's shapes, paddings and NaN poison (t = 1151 and 700), on
   dyadic q and K: within 1e-5 (the kernel rounds each p against the
   running max through its page's end, as the reference does), two calls
   bitwise equal, the float32 kernel on the widened cache more than
   1e-5 off, and one call exactly one kernel launch (one kernel node when
   a call is captured in a CUDA graph: the cluster kernel merges its
   splits itself; phase 11's float32 call shows its split and combine
   kernels); prints the split count and the cluster geometry; times it
   beside phase 11's float32 time, the plain version, SDPA on the
   bfloat16 cache and the bound.
16. Quantized serving main path: DenseLmTiny on the card must reproduce
   its CPU streams with int8 pools (ragged and legacy) and bfloat16 pools
   (ragged); then DenseLm1B with phase 5's weights, geometry and requests
   through `ServingLoop(kv_cache_dtype=...)`: int8 ragged (exactly 24
   int8 ragged launches per step, no float32 one), int8 legacy (exactly 24
   int8 block-decode launches per decode-only step), bfloat16 ragged and
   bfloat16 legacy, every other count 0 and quantized_steps equal to the
   steps for int8; each step mode first serves float32 pools again, the
   same process's baseline at that point. Prints ms/step, tok/s, peak
   memory, kv_bytes_per_token and pool bytes, the int8 runs' profiles (of
   decode-only steps in legacy mode), and
   (information only) how many of the 8 streams equal phase 5's.
17. GShardDecode on quantized caches: DenseLmTiny with a bfloat16 and an
   int8 cache, card against CPU continuations; then DenseLm1B with a
   bfloat16 cache restored from phase 13's checkpoint through `DecodeOnce`
   (128 steps): exactly 3072 bfloat16 flash-decode launches and no other
   kernel, the telemetry's kv_cache_dtype, and the 16-step profile. (An
   int8 dense cache takes the dequantize-then-attend einsum read, as the
   reference's does: no kernel.)
18. The bfloat16 flash-attention kernels (forward, dK/dV, dQ) against
   their plain versions, the reference Pallas kernels' twins
   (`_PallasForward` / `_PallasBackward`), at phase 7's shapes and
   segments on dyadic q, k, v and do (q.k and do.v exact in any order,
   so both sides round the same p and ds): out, dq, dk and
   dv may differ in at most 1e-3 of their elements by more than 1e-5 x
   max|want| (float32 sums of exact products in other orders, then one
   bfloat16 rounding), and no element by more than one bfloat16 ulp,
   2^-7 |want| + 1e-5 max|want|; lse within 2e-5; two calls of each of
   the three kernels bitwise equal; prints the forward's grid, threads,
   shared memory per block and resident blocks per SM, and the same of
   dK/dV and dQ with their registers and local (spill) bytes per thread
   (`BackwardGeometry(t, h, bfloat16)`), which must be 0. The control,
   p rounded against
   64-key tile maxima instead of the running max through the 1024-key
   reference block, must differ in at least ten times as many out
   elements. Times each kernel, the plain
   versions, the bound (bf16 bytes, 989 TFLOP/s) and SDPA on bfloat16.
19. The bfloat16 fused-xent kernel against `_PlainStats` at phase 8's
   shapes (x and the table in bfloat16, statistics float32): tolerances
   of phase 8, two calls bitwise equal; prints its grid (row tiles x
   vocab splits from `StatsGeometry` at its occupancy), threads, shared
   memory and resident blocks per SM; times it, the plain version and the
   bound.
20. bfloat16 training main path: DenseLmTiny at fprop_dtype=bfloat16
   trains 3 steps (every leaf) on the card and on the CPU from the same
   weights, the CPU's flash calls on the kernels' lowering (the Pallas
   twins, as the card runs the kernels): steps 1-2 loss and grad_norm
   within 5e-5, step 3 loss within 1e-3, the relative update error after
   steps 2 and 3 within 2e-2; the card at fprop float32, the control,
   must fail each bar and miss the loss bars of steps 1-2 by 10x. For the
   record it prints the CPU at its own lowering (the xla twin below 2^21
   elements) and the CPU with oneDNN off (GEMMs in another order) against
   the same run; then
   DenseLm1B at fprop_dtype=bfloat16 (weights and
   Adafactor slots float32; flash on, xent block 1280, remat 'full')
   through `TrainProgram` as phase 9: 1 warm-up, 4 counted steps with
   exactly 48 / 24 / 24 / 1 bfloat16 launches per step (no float32 one),
   finite loss and grad_norm, no skipped step; prints ms/step, tokens/s,
   TFLOP/s against the 989 TFLOP/s bf16 peak, peak memory and a profiled
   step's busy share and split, the 10 aten ops with the largest self
   device time (with counts) and the device time of the remat replay's
   dtype casts.
21. The int8 serving kernels of ops/int8_matmul.py (kernel (a), the
   per-tensor activation quantization, one block or cluster; kernel (b),
   the int8 wgmma GEMM fed by TMA with its two-scale epilogue) against
   their plain versions at the 145 products of a DenseLm1B step
   (q/k/v/post 2048 x 2048, the FFN's 2048 x 8192 and 8192 x 2048, the
   tied logits 2048 x 32000) with m = 264 rows (the ragged step) and m = 8
   (a decode step):
   bitwise equal, two calls bitwise equal, one launch of each a call;
   prints each shape's launch plan (a's cluster, b's orientation, cluster
   of K splits, stages; the built kernel's blocks per SM must be the
   plan's). Times each kernel, both from one `Int8Matmul` call (b
   overlapping a), the plain versions, torch._int_mm (the int32 product
   alone; at m = 8 on x8 padded with zero rows to 24, the fewest it
   takes) and the float32 matmul on the dequantized weight, beside each
   bound (bytes at 3.35 TB/s, operations at 1979 TOP/s), and their sums
   over a step; and the host's enqueue per projection (`Int8Matmul`, both
   kernels from one call, against the float32 matmul): what a host-bound
   step pays.
22. int8-weight serving main path: DenseLmTiny with int8 weights on the
   card must reproduce its CPU streams (ragged, legacy, ragged with int8
   pools); then DenseLm1B with phase 5's weights, geometry and requests
   through `ServingLoop(serve_int8_weights=True)` in ragged and legacy
   step mode (each after a float32-weight run of the same mode, the
   baseline at that point of the process) and ragged with int8 pools:
   exactly 145 launches of each
   int8 kernel per step beside the attention kernels' counts, no other
   kernel; prints ms/step, tok/s, peak memory, the int8 theta's bytes,
   the ragged run's profiled busy split (the int8 kernels' share) and, as
   information,
   how many streams equal phase 5's float32 ones. Then GShardDecode with
   serve_int8_weights: DenseLmTiny card against CPU continuations, and
   DenseLm1B from a port checkpoint (phase 13's setting): exactly 3072
   flash-decode launches and 145 x (4 + 128) of each int8 kernel.
23. Seeded sampling (temperature / top-k). The sampling kernel of
   ops/sample_tokens.py against its plain version at the engine's ragged
   step ([264, 32000], each token folded with its request's (seed,
   position)) and GShardDecode's step ([8, 32000], rows folded into the
   step key), T = 0.7, top_k 0 and 40: equal tokens, the winning
   perturbed value within 1 ulp (the logarithms are libdevice's and
   PyTorch's), two calls bitwise equal, one launch a call; times the
   kernel, the plain version and the top-k threshold (torch.topk) beside
   the bound (the largest of the bytes, threefry's ALU-only operations
   and every instruction at the issue rate). Then DenseLmTiny's
   sampled streams on the card equal the CPU's (ragged and legacy), and
   its sampled GShardDecode continuations. DenseLm1B with phase 5's
   weights and requests (seeds 100..107) at T = 0.8, top_k 40,
   sample_seed 3 through `ServingLoop`: exactly 24 ragged and 1 sampling
   launch a step, profiled; a second run equal stream for stream. The
   random weights' logits are peaked enough that T = 0.8 draws the argmax,
   so the same requests at T = 30 (top_k 0) twice: equal streams, and
   some that differ from the greedy ones; for information, those requests
   in reverse order and one request alone; a cancel of 2 of the 8 after
   their first tokens, after which `Stop` leaves every page free.
   GShardDecode at T = 0.8, top_k 40 from phase 13's weights: 3072
   flash-decode and 128 sampling launches, two calls equal. Kernel (a)'s
   scale on a value where the float32 reciprocal product and the true
   division differ: the product, as the reference's jitted step. Prints
   the sampling kernel's element loop in SASS (instructions by class and
   by pipe).
24. Serving and batch decode at fprop_dtype=bfloat16. The bfloat16-q
   instantiations of the attention kernels on dyadic q and K: the ragged
   kernel over float32, bfloat16 and int8 pools (phase 3's main pack, page
   16, H 128, dead slots poisoned as in phase 14), block decode over the
   three (phase 10's pool), flash decode over bfloat16 and float32 caches
   (phase 11's shapes, t 1151 and 700): each output bfloat16, bitwise
   equal to the float32-q kernel on the widened q rounded to bfloat16
   (the widening is exact), within one bfloat16 ulp of the plain version
   (float32 sums in another order, then one rounding; the elements that
   differ are printed), two calls bitwise equal, padding exactly 0; timed
   beside the bound (q and out at 2 bytes) and, for flash decode, SDPA on
   the same bfloat16 tensors. The int8 kernels with bfloat16 x and y at
   the 145 products (m = 264 and 8): bitwise their float32 runs on the
   widened x (rounded) and the plain versions, timed. Then DenseLmTiny at
   bfloat16 on the card against the CPU: two packed steps' logits within
   TWIN_REL (the card at float32 activations must miss it), and how many
   greedy streams equal the CPU's (information). Then DenseLm1B at
   fprop_dtype=bfloat16 with phase 5's weights: the first packed step's
   logits within a relative L2 gap of 0.1 of the float32 model's; phase
   5's requests at float32 activations (the baseline of this process),
   then at bfloat16 through ServingLoop ragged (exactly 24 bfloat16-q
   ragged launches a step, bfloat16 pools) and legacy (24 bfloat16-q
   block-decode launches a decode-only step), both profiled (busy,
   syncs); the shortest request for 8 tokens sampled (T 0.8, top_k 40)
   over float32 pools, with int8 weights over int8 pools (145 launches of
   each bfloat16 int8 kernel a step), and legacy over float32 and int8
   pools: every request completes and every step's logits are finite.
   GShardDecode from a port checkpoint of the same weights with a
   bfloat16 cache (3072 bfloat16-q flash-decode launches, 16 steps
   profiled) and with a float32 cache (3072 of the split and combine
   kernels' bfloat16-q instantiation). Prints the phase's seconds.
25. Prints the per-kernel JSON line (every kernel and every int8 /
   bfloat16 instantiation, and the bfloat16-q ones; the int8 serving
   kernels and the sampling kernel with "replaces": null), then the
   result line.

Kernel times are device times: CUDA events around the call, after an L2
flush and a spin kernel that covers the host's enqueue (`_TimeMs`).

Exits non-zero, printing no result line, if any phase fails, if CUDA is
not available, or if the lingvo_tpu_torch package is not beside it.
"""

import concurrent.futures
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32, CUDA cores (data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense (data sheet)
INT8_OPS_PER_S = 1979e12       # H100 SXM int8 tensor cores, dense (data sheet)
# int32 shifts, logic ops and compares run on an SM's ALU pipe, 64 lanes a
# clock against 128 float32 lanes, and the float32 rate counts an FMA as 2
# operations (int32 adds may also issue as IMAD on the FMA pipe)
INT32_OPS_PER_S = FP32_FLOPS_PER_S / 4
# an SM issues one warp instruction a clock from each of its 4 schedulers:
# 128 lanes a clock, whatever the pipe
INSTRUCTIONS_PER_S = FP32_FLOPS_PER_S / 2
TOL = 1e-5
# the legacy engine's profiled window: its decode-only steps (the mixed
# steps' plain BlockPrefill makes a profiled window of them cost 60-130 s)
LEGACY_WINDOWS = ("last",)


def _Phase(name):
  print(f"\n== {name}", flush=True)


class _Counts:
  """The kernels' launch counts by name: name -> (wrapper, dtype). A
  wrapper with per-dtype instantiations counts each in its
  `launches_by_dtype` (dtype a name), the attention kernels also by
  (q dtype, pool dtype) in `launches_by_q_dtype` (dtype a pair); the
  others count in `launches`."""

  def __init__(self, **entries):
    self.entries = entries

  def __iter__(self):
    return iter(self.entries)

  @staticmethod
  def _Table(fn, dtype):
    """(the dict that holds the count, its key)."""
    if isinstance(dtype, tuple):
      return fn.launches_by_q_dtype[dtype[0]], dtype[1]
    return fn.launches_by_dtype, dtype

  def Zero(self):
    for fn, dtype in self.entries.values():
      fn.launches = 0
      if dtype is not None:
        table, key = self._Table(fn, dtype)
        table[key] = 0

  def Read(self) -> dict:
    out = {}
    for name, (fn, dtype) in self.entries.items():
      if dtype is None:
        out[name] = fn.launches
      else:
        table, key = self._Table(fn, dtype)
        out[name] = table[key]
    return out


def _MakeCounts(rba, ssd, fa, fx, bd, fd, im, st):
  """Every counted kernel of the port, by name (`_Counts`)."""
  # float32 launches of the kernels with per-dtype instantiations count
  # under the plain name; the attention kernels' names without "q_bf16"
  # are their float32-q instantiations, by pool dtype, those with it the
  # bfloat16-q ones (fprop_dtype=bfloat16)
  f32q = lambda kv: ("float32", kv)
  bf16q = lambda kv: ("bfloat16", kv)
  return _Counts(
      ragged_block_attend=(rba.RaggedAttend, f32q("float32")),
      ragged_block_attend_int8=(rba.RaggedAttend, f32q("int8")),
      ragged_block_attend_bf16=(rba.RaggedAttend, f32q("bfloat16")),
      ragged_block_attend_q_bf16=(rba.RaggedAttend, bf16q("bfloat16")),
      ragged_block_attend_q_bf16_f32pool=(rba.RaggedAttend,
                                          bf16q("float32")),
      ragged_block_attend_q_bf16_int8pool=(rba.RaggedAttend, bf16q("int8")),
      ssd_scan=(ssd.SsdScan, None),
      flash_attention_fwd=(fa.FlashForward, "float32"),
      flash_attention_fwd_bf16=(fa.FlashForward, "bfloat16"),
      flash_attention_dkdv=(fa.FlashDkDv, "float32"),
      flash_attention_dkdv_bf16=(fa.FlashDkDv, "bfloat16"),
      flash_attention_dq=(fa.FlashDq, "float32"),
      flash_attention_dq_bf16=(fa.FlashDq, "bfloat16"),
      fused_xent_fwd=(fx.FusedXentStats, "float32"),
      fused_xent_fwd_bf16=(fx.FusedXentStats, "bfloat16"),
      block_decode=(bd.BlockDecode, f32q("float32")),
      block_decode_int8=(bd.BlockDecode, f32q("int8")),
      block_decode_bf16=(bd.BlockDecode, f32q("bfloat16")),
      block_decode_q_bf16=(bd.BlockDecode, bf16q("bfloat16")),
      block_decode_q_bf16_f32pool=(bd.BlockDecode, bf16q("float32")),
      block_decode_q_bf16_int8pool=(bd.BlockDecode, bf16q("int8")),
      flash_decode=(fd.FlashDecode, f32q("float32")),
      flash_decode_bf16=(fd.FlashDecode, f32q("bfloat16")),
      flash_decode_q_bf16=(fd.FlashDecode, bf16q("bfloat16")),
      flash_decode_q_bf16_f32cache=(fd.FlashDecode, bf16q("float32")),
      int8_act_quant=(im.QuantizeActivations, "float32"),
      int8_matmul=(im.Int8Gemm, "float32"),
      int8_act_quant_bf16=(im.QuantizeActivations, "bfloat16"),
      int8_matmul_bf16=(im.Int8Gemm, "bfloat16"),
      sample_tokens=(st.SampleTokens, None))


def _Check(ok, msg):
  if not ok:
    raise RuntimeError(f"chip_smoke check failed: {msg}")


def _TimeMs(torch, fn, iters, flush_bytes=64 << 20, waits_as=None):
  """Mean device ms of fn() over iters launches, each after an L2 flush
  (a 64 MB write), timed with CUDA events around fn alone. A spin kernel
  after the flush keeps the card busy for twice fn's host enqueue time (at
  least 1 ms), so the start event fires only once fn's launches are queued
  and the events time the device work, not the wrappers' host time.

  Each iteration checks that: the host's enqueue of fn must end before the
  spin does (the spin's device time, read from an event before it). An
  iteration where it did not is timed again with the spin doubled. If the
  enqueue still outlasts a spin four times as long, fn waits on the device
  inside its call, and no spin can cover the host's work after that wait.
  A kernel wrapper must not (waits_as=None: the run fails); a plain
  version may (waits_as names it), and its time then includes that host
  work, which is printed."""
  scratch = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")
  fn()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  fn()
  host_s = time.perf_counter() - t0
  torch.cuda.synchronize()
  spin_cycles = int(2e9 * max(1e-3, 2 * host_s))   # about 2 GHz clocks
  total, done, misses, waits = 0.0, 0, 0, False
  while done < iters:
    scratch.zero_()
    spin, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    spin.record()
    torch.cuda._sleep(spin_cycles)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = spin.elapsed_time(start)
    if enqueue_ms >= spin_ms and not waits:
      misses += 1
      if misses < 3:
        spin_cycles *= 2
        continue
      _Check(waits_as is not None,
             f"_TimeMs: a kernel wrapper's enqueue ({enqueue_ms:.3f} ms) "
             f"outlasted a spin of {spin_ms:.3f} ms: it waits on the device")
      waits = True
      print(f"{waits_as}: waits on the device inside its call; its time "
            f"includes the host's work after the wait")
    total += start.elapsed_time(end)
    done += 1
  return total / iters


def _EnqueueUs(torch, fn, calls=20, reps=20):
  """Host microseconds per call of fn, with the card kept busy by a spin
  of ~10 ms so that every call only enqueues: what a host-bound step pays
  for each call. The spin covering every batch is checked."""
  fn()
  torch.cuda.synchronize()
  total = 0.0
  for _ in range(reps):
    spin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    spin.record()
    torch.cuda._sleep(20_000_000)   # about 10 ms at ~2 GHz
    end.record()
    t0 = time.perf_counter()
    for _ in range(calls):
      fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    _Check(host_s * 1e3 < spin.elapsed_time(end), "_EnqueueUs: the spin "
           "ended before the calls were enqueued")
    total += host_s
  return total / (calls * reps) * 1e6


# The ragged kernel's packs at the serving step's width (T = 264, 8 rows):
# (prompt lens, q_pos, the tree row or None). "main": decode rows, two
# prefill chunks that straddle the kernel's 16-token tile edges, a tree
# row, padding; "decode_only": 8 decode tokens and 256 padding tokens, a
# decode-only step; "edges": a 20-token prefill across a tile edge, then
# a tree row and a 5-token prefill inside one 16-token tile (a tile that
# would cross three rows), across the next edge.
_PACKS = {
    "main": ([1, 1, 1, 1, 1, 128, 120, 7],
             [999, 516, 63, 32, 299, 256, 0, 700], 7),
    "decode_only": ([1] * 8, [700, 999, 512, 800, 333, 901, 640, 777], None),
    "edges": ([1, 20, 7, 5, 1, 1, 1, 1], [611, 300, 800, 64, 5, 900, 17, 420],
              2),
}


def _AttendPack(torch, ragged, page, h, rng, dyadic=False, pack="main"):
  """The kernel-check pack `pack` (`_PACKS`) at page size `page` and head
  dim `h` (see the module docstring); dyadic: q and K made `_Dyadic`."""
  n, t, b, max_seq = 16, 264, 8, 1024
  t_pages = max_seq // page
  num_pages = 512 * 16 // page
  parents = np.array([-1, 0, 1, -1, 3, 4], np.int32)   # 2 branches of 3
  lens, q_pos, tree_row = _PACKS[pack]
  rows = ragged.BuildRaggedRows(
      lens, q_pos, t, 256, None if tree_row is None else {tree_row: parents})
  q_end = np.where(rows.valid, rows.pos + 1, 0).astype(np.int32)
  q_start = rows.row_q_pos[rows.row_of].astype(np.int32)
  row_end = [int(q_end[rows.row_of == r].max()) for r in range(b)]
  need = [-(-e // page) for e in row_end]
  perm = rng.permutation(num_pages)
  owned = np.split(perm[:sum(need)], np.cumsum(need)[:-1])
  freed = perm[sum(need):]
  tables = rng.choice(freed, size=(b, t_pages)).astype(np.int32)
  for r in range(b):
    tables[r, :need[r]] = owned[r]
  shape = (num_pages + 1, page, n, h)
  k_pool = rng.randn(*shape).astype(np.float32)
  v_pool = rng.randn(*shape).astype(np.float32)
  if dyadic:
    k_pool = _Dyadic(k_pool, 1 / 8)
  dead = np.zeros(shape[:2], bool)
  dead[freed] = True                          # freed pages
  for r in range(b):                          # stale slots past each row
    dead[owned[r][-1], row_end[r] - (need[r] - 1) * page:] = True
  clean = (k_pool.copy(), v_pool.copy())
  for pool in (k_pool, v_pool):
    pool[dead] = np.nan
  q = (rng.randn(t, n, h) / np.sqrt(h)).astype(np.float32)
  if dyadic:
    q = _Dyadic(q, 1 / 64)
  live = 2 * sum(row_end) * n                 # each row's live K/V (slot, head)s
  moved = lambda elem: int(live * elem        # bytes per (slot, head)
                           + 2 * q.nbytes     # q read, out written
                           + sum(need) * 4 + 5 * t * 4)  # tables, token ints
  flops = int(4 * q_end.astype(np.int64).sum() * n * h)
  cuda = {k: torch.as_tensor(v).cuda() for k, v in dict(
      q=q, k_pool=k_pool, v_pool=v_pool, tables=tables,
      row_of=rows.row_of, q_end=q_end, q_start=q_start,
      anc_lo=rows.anc_lo, anc_hi=rows.anc_hi).items()}
  return cuda, q_end == 0, moved, flops, dict(clean=clean, dead=dead)


def _RaggedLayout(torch, rba, x, page, h, dtype="float32"):
  """The ragged kernel's schedule on the card for pack x, checked against
  `TileSchedule`, and its launch geometry, printed."""
  t_pages, b = x["tables"].shape[1], x["tables"].shape[0]
  split = dtype != "bfloat16"
  items = rba.DeviceSchedule(x["row_of"], x["q_end"], page, t_pages, b, 16,
                             split=split)
  want = rba.TileSchedule(x["row_of"].cpu().numpy(), x["q_end"].cpu().numpy(),
                          page, t_pages, b, split=split)
  _Check(np.array_equal(items, want), f"ragged P={page} H={h} {dtype}: the "
         "card's tile schedule differs from TileSchedule")
  threads, smem, per_sm, blocks = rba.KernelGeometry(h, page, t_pages, dtype)
  tiles = len(set(items[:, -1].tolist()))
  return (f"schedule: {tiles} tiles, {len(items)} (tile, split) items x 16 "
          f"heads = {16 * len(items)} units (equal to TileSchedule); grid "
          f"({blocks},) persistent blocks, {threads} threads, {smem} B "
          f"shared per block, {per_sm} blocks resident per SM")


def _CheckKernel(torch, rba, ragged, page, rng, h=128, pack="main"):
  x, pad, moved, flops, _ = _AttendPack(torch, ragged, page, h, rng,
                                        pack=pack)
  moved = moved(h * 4)
  args = (x["q"], x["k_pool"], x["v_pool"], x["tables"], x["row_of"],
          x["q_end"])
  tree = dict(q_start=x["q_start"], anc_lo=x["anc_lo"], anc_hi=x["anc_hi"])
  label = f"P={page} H={h} pack {pack}"
  out = rba.RaggedAttend(*args, page_size=page, **tree)
  again = rba.RaggedAttend(*args, page_size=page, **tree)
  plain = rba._PlainRaggedAttend(*args, page, **tree)
  torch.cuda.synchronize()
  _Check(bool(torch.isfinite(out).all()), f"{label}: non-finite")
  _Check(bool((out[torch.as_tensor(pad).cuda()] == 0).all()),
         f"{label}: padding outputs not exactly zero")
  _Check(torch.equal(out, again), f"{label}: two calls differ bitwise")
  err = float((out - plain).abs().max())
  _Check(err <= TOL, f"{label}: kernel vs plain max abs err {err} > {TOL}")
  print(f"ragged {label}: two calls bitwise equal; "
        + _RaggedLayout(torch, rba, x, page, h))
  kernel_ms = _TimeMs(torch, lambda: rba.RaggedAttend(
      *args, page_size=page, **tree), iters=20)
  plain_ms = _TimeMs(torch, lambda: rba._PlainRaggedAttend(
      *args, page, **tree), iters=3, waits_as="plain ragged")
  bytes_ms = moved / HBM_BYTES_PER_S * 1e3
  ops_ms = flops / FP32_FLOPS_PER_S * 1e3
  res = dict(page_size=page, head_dim=h, pack=pack, max_abs_err=err,
             kernel_ms=kernel_ms, plain_ms=plain_ms,
             bound_ms=max(bytes_ms, ops_ms),
             bound_by="bytes" if bytes_ms >= ops_ms else "operations",
             bytes=moved, flops=flops, library_ms=None)
  print(json.dumps(res))
  return res


def _KvStorage(torch, clean, dead, dtype):
  """CUDA K/V pools of the clean float32 pools [NP, P, N, H] stored as
  `dtype`, with the dead slots [NP, P] poisoned: NaN in bfloat16; int8
  values alternating 127 / -128 and NaN scales in the sidecars. Returns
  (k, v, {} or the sidecars as k_scale / v_scale, the dequantized float32
  pools (int8) or None)."""
  from lingvo_tpu_torch.ops import ragged_block_attend as rba
  from lingvo_tpu_torch.quant import kv as kv_quant
  dead_t = torch.as_tensor(dead).cuda()
  pools, scales, deq = [], {}, []
  for name, pool in zip(("k", "v"), clean):
    x = torch.as_tensor(pool).cuda()
    if dtype == "bfloat16":
      x = x.bfloat16()
      x[dead_t] = float("nan")
      pools.append(x)
      continue
    q8, scale = kv_quant.QuantizeKv(x)          # [NP, P, N, H], [NP, P, N]
    q8[dead_t] = torch.where(
        torch.arange(q8.shape[-1], device="cuda") % 2 == 0, 127,
        -128).to(torch.int8)
    scale[dead_t] = float("nan")
    scale = scale.transpose(1, 2).contiguous()  # the sidecar [NP, N, P]
    pools.append(q8)
    scales[f"{name}_scale"] = scale
    deq.append(rba._DequantPages(q8, scale))
  return pools[0], pools[1], scales, (deq or None)


def _Dyadic(x, step):
  """x rounded to a multiple of the power of two `step`: few enough
  significant bits that a dot product of such values is exact in float32
  in any summation order. On dyadic q and K the kernels and their plain
  versions compute the same scores, so a bfloat16 read rounds the same
  probabilities on both sides and only the float32 sums differ."""
  return (np.round(x / step) * step).astype(np.float32)


def _Unrounded(torch, label, got_err, ctl_err):
  """The bfloat16 check's control: the float32 kernel on the widened
  bfloat16 storage rounds no probability, so it must miss the TOL bar
  that the bfloat16 kernel meets."""
  _Check(ctl_err > TOL, f"{label}: the float32 kernel on the widened "
         f"storage (p unrounded) is within {TOL} of the plain bfloat16 "
         f"version ({ctl_err}): the check cannot tell a kernel that skips "
         "the rounding")
  print(f"{label}: bfloat16 kernel max abs err {got_err:.3g}, unrounded "
        f"control {ctl_err:.3g}, bar {TOL}")


def _CheckQuant(torch, label, call, plain, deq_call, zero_rows, bound,
                time_plain, unrounded=None):
  """One quantized instantiation against its plain version on the card:
  finite, padding / inactive rows exactly 0, within TOL of the plain
  version, two calls bitwise equal, (int8) bitwise equal to the float32
  kernel on the dequantized pool, and (bfloat16) the unrounded control
  `unrounded` (the float32 kernel on the widened pools) more than TOL
  off. Times the kernel (and, with time_plain, the plain version)."""
  out, again, want = call(), call(), plain()
  torch.cuda.synchronize()
  _Check(bool(torch.isfinite(out).all()), f"{label}: non-finite")
  _Check(torch.equal(out, again), f"{label}: two calls differ bitwise")
  if zero_rows is not None:
    _Check(bool((out[zero_rows] == 0).all()), f"{label}: padding or "
           "inactive rows not exactly zero")
  err = float((out - want).abs().max())
  _Check(err <= TOL, f"{label}: kernel vs plain max abs err {err} > {TOL}")
  ctl_err = None
  if unrounded is not None:
    ctl_err = float((unrounded() - want).abs().max())
    _Unrounded(torch, label, err, ctl_err)
  same = "n/a"
  if deq_call is not None:
    flt = deq_call()
    torch.cuda.synchronize()
    _Check(torch.equal(out, flt), f"{label}: int8 kernel differs from the "
           "float32 kernel on the dequantized pool")
    same = "bitwise equal"
  ms = _TimeMs(torch, call, 20)
  plain_ms = (_TimeMs(torch, plain, 3, waits_as=f"plain {label}")
              if time_plain else None)
  print(f"{label}: max abs err {err:.3g} (tol {TOL}), two calls bitwise "
        f"equal, vs float32 kernel on the dequantized pool: {same}; kernel "
        f"{ms:.4f} ms, plain "
        f"{'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'}, "
        f"bound {bound[0]:.4f} ms ({bound[1]})")
  return dict(ms=ms, plain_ms=plain_ms, bound=bound, err=err,
              unrounded_err=ctl_err, library_ms=None)


def _CheckQuantRagged(torch, rba, ragged, page, h, rng, time_plain,
                      pack="main"):
  """The ragged kernel's int8 and bfloat16 instantiations at phase 3's
  shapes (its pack `pack` with dyadic q and K, poisoned as `_KvStorage`
  says), beside the float32 kernel on the same pack."""
  x, pad, moved, flops, extra = _AttendPack(torch, ragged, page, h, rng,
                                            dyadic=True, pack=pack)
  ints = (x["tables"], x["row_of"], x["q_end"])
  tree = dict(q_start=x["q_start"], anc_lo=x["anc_lo"], anc_hi=x["anc_hi"])
  call = lambda k, v, **sc: rba.RaggedAttend(x["q"], k, v, *ints,
                                             page_size=page, **sc, **tree)
  float_ms = _TimeMs(torch, lambda: call(x["k_pool"], x["v_pool"]), 20)
  zero = torch.as_tensor(pad).cuda()
  res = {}
  for dtype, elem in (("int8", h + 4), ("bfloat16", 2 * h)):
    k, v, sc, deq = _KvStorage(torch, extra["clean"], extra["dead"], dtype)
    plain = lambda k=k, v=v, sc=sc: rba._PlainRaggedAttend(
        x["q"], k, v, *ints, page, **tree, **sc)
    unrounded = lambda k=k, v=v: call(k.float(), v.float())
    print(f"ragged {dtype} P={page} H={h} pack {pack}: "
          + _RaggedLayout(torch, rba, x, page, h, dtype))
    res[dtype] = _CheckQuant(
        torch, f"ragged {dtype} P={page} H={h} pack {pack}",
        lambda: call(k, v, **sc),
        plain, (lambda: call(*deq)) if deq else None, zero,
        _Bound(moved(elem), flops), time_plain,
        unrounded if dtype == "bfloat16" else None)
    res[dtype]["float_ms"] = float_ms
    del k, v, sc, deq
  print(f"ragged float32 P={page} H={h} on the same pack ({pack}): "
        f"{float_ms:.4f} ms, "
        f"bound {_Bound(moved(4 * h), flops)[0]:.4f} ms")
  return res


def _CheckQuantBlockDecode(torch, bd, page, rng, time_plain):
  """The block-decode kernel's int8 and bfloat16 instantiations at phase
  10's shapes (its pool with dyadic q and K, poisoned as `_KvStorage`
  says), beside the float32 kernel on the same pool."""
  x, moved, flops, extra = _DecodePool(torch, page, rng, dyadic=True)
  rest = (x["tables"], x["lens"])
  call = lambda k, v, **sc: bd.BlockDecode(x["q"], k, v, *rest,
                                           page_size=page, **sc)
  float_ms = _TimeMs(torch, lambda: call(x["k_pool"], x["v_pool"]), 20)
  res = {}
  for dtype, elem in (("int8", 128 + 4), ("bfloat16", 2 * 128)):
    k, v, sc, deq = _KvStorage(torch, extra["clean"], extra["dead"], dtype)
    plain = lambda k=k, v=v, sc=sc: bd._PlainBlockDecode(
        x["q"][:, 0], k, v, *rest, page, **sc)[:, None]
    unrounded = lambda k=k, v=v: call(k.float(), v.float())
    label = f"block decode {dtype} P={page}"
    _OneNode(torch, label, lambda k=k, v=v, sc=sc: call(k, v, **sc))
    print(f"{label}: {_BlockDecodeLayout(torch, bd, x, page, dtype)}; one "
          "kernel node per call")
    res[dtype] = _CheckQuant(
        torch, label, lambda: call(k, v, **sc),
        plain, (lambda: call(*deq)) if deq else None, 0,
        _Bound(moved(elem), flops), time_plain,
        unrounded if dtype == "bfloat16" else None)
    res[dtype]["float_ms"] = float_ms
    del k, v, sc, deq
  print(f"block decode float32 P={page} on the same pool: {float_ms:.4f} ms, "
        f"bound {_Bound(moved(4 * 128), flops)[0]:.4f} ms")
  return res


def _TinyReference(torch, cfg, engine, ragged, step_mode="ragged",
                   kv_cache_dtype=None, serve_int8_weights=False,
                   sample=None):
  """`cfg`, a tiny config, on the card against the same weights on the
  CPU: one packed step's logits, then greedy streams of the engine in
  `step_mode` (sampled ones with `sample`, the engine's sampling
  arguments), both over `kv_cache_dtype` pools, on an int8 serving theta
  with `serve_int8_weights` (the step's projections through the int8
  kernels on the card)."""
  from lingvo_tpu_torch.core import base_layer
  from lingvo_tpu_torch.quant import weights as quant_weights
  p = cfg.Task()
  cpu_lm = p.Instantiate(device="cpu")
  cpu_lm.InstantiateVariables(torch.Generator("cpu").manual_seed(1))
  gpu_lm = p.Instantiate(device="cuda")
  gpu_lm.load_state_dict(cpu_lm.state_dict())
  rows = ragged.BuildRaggedRows([1, 9, 0, 4], [5, 0, 1, 2], 16, 9)
  ids = np.random.RandomState(3).randint(0, 128, size=(1, 16)).astype(np.int32)
  tables = np.arange(16, dtype=np.int32).reshape(4, 4)
  logits = {}
  for name, lm in (("cpu", cpu_lm), ("cuda", gpu_lm)):
    states = lm.InitPagedDecodeState(17, 8, num_slots=4,
                                     kv_cache_dtype=kv_cache_dtype)
    theta = contextlib.nullcontext()
    if serve_int8_weights:
      theta = base_layer.ServedTheta(
          lm, quant_weights.Int8ServingTheta(lm.ThetaTree())[0]).Active()
    with torch.no_grad(), theta:
      out, _ = lm.RaggedStep(torch.as_tensor(ids).to(lm.device), states,
                             torch.as_tensor(tables).to(lm.device),
                             ragged.ToTorch(rows, lm.device))
    logits[name] = out[0, torch.as_tensor(rows.valid)].cpu()
  err = float((logits["cpu"] - logits["cuda"]).abs().max())
  _Check(err <= 1e-4, f"tiny RaggedStep logits cuda vs cpu: {err} > 1e-4")
  rng = np.random.RandomState(4)
  lens = np.array([5, 13, 21, 8, 2, 30], np.int32)
  prompts = rng.randint(1, 128, size=(len(lens), 30)).astype(np.int32)
  kw = dict(page_size=8, num_pages=32, max_batch=4, max_seq_len=64,
            prefill_chunk=8)
  streams = {}
  for name, lm in (("cpu", cpu_lm), ("cuda", gpu_lm)):
    eng = engine.ServingLoop(lm, device=lm.device, step_mode=step_mode,
                             kv_cache_dtype=kv_cache_dtype,
                             serve_int8_weights=serve_int8_weights,
                             **kw, **(sample or {}))
    streams[name] = eng.RunBatch(prompts, lens, max_new_tokens=8)
  kind = f"sampled ({sample})" if sample else "greedy"
  _Check(np.array_equal(streams["cpu"], streams["cuda"]),
         f"tiny {kind} streams differ:\n{streams['cpu']}\n"
         f"{streams['cuda']}")
  print(f"{type(cfg).__name__} reference ({eng.kv_cache_dtype} KV, "
        f"{'int8' if serve_int8_weights else 'float32'} weights, "
        f"paged_path {eng.paged_path}): logits max abs err {err:.3g} "
        f"(<= 1e-4), {len(lens)} {kind} streams of the {step_mode} engine "
        "identical to the CPU path")

SCAN_TOL = 2e-5   # x max(1, max|want|): float32, the two versions sum the
                  # chunk products in other orders and the state carries the
                  # differences from chunk to chunk


def _ScanInputs(torch, ssd, rng, t, live, resets, with_s0):
  """[8, t, 16] rows with S = H = 64: row i is live for live[i] steps and
  padded after (dl = 0, v = 0), (row, step) in resets is a segment start
  (dl = RESET_LOG), s0 nonzero or None. Returns the CUDA tensors and the
  bytes a scan of them must move (each input read once, y and the final
  state written once)."""
  b, n, s, h = 8, 16, 64, 64
  dl = -np.logaddexp(rng.randn(b, t, n), 0.0)
  b_in, c_in = (0.5 * rng.randn(b, t, n, s) for _ in range(2))
  v = 0.5 * rng.randn(b, t, n, h)
  for row, step in resets:
    dl[row, step] = ssd.RESET_LOG
  pad = np.arange(t)[None] >= np.asarray(live)[:, None]
  dl = np.where(pad[..., None], 0.0, dl)
  v = np.where(pad[..., None, None], 0.0, v)
  arrays = [dl, b_in, c_in, v]
  if with_s0:
    arrays.append(0.2 * rng.randn(b, n, h, s))
  x = [torch.as_tensor(a.astype(np.float32)).cuda() for a in arrays]
  moved = sum(a.size for a in arrays) * 4 + (b * t * n * h + b * n * h * s) * 4
  return x, moved


def _ScanFlops(t, q, s_dim, h):
  """Operations one row's scan needs over t steps in chunks of q: per
  chunk of qc steps, the inter-chunk output (c exp(cum)) s_in^T and the
  state update (v exp(cum_Q - cum))^T b, 2 qc S H each, and the causal
  lower triangle (diagonal included) of the two qc x qc products, G = c b^T
  and (G o decay) v, qc (qc + 1) / 2 (S + H) FMAs. The upper triangle is
  masked to 0 and adds nothing to the result, so it is not counted."""
  total = 0
  for start in range(0, t, q):
    qc = min(q, t - start)
    total += 2 * (2 * qc * s_dim * h + qc * (qc + 1) // 2 * (s_dim + h))
  return total


def _ScanLiveWork(torch, x, chunk):
  """The live-work bound's operations and bytes: what this call's data
  needs. Per (row, chunk) of qc steps whose last nonzero v is step kv
  (counted from 1; 0 when v is all zero there): the inter product (c o
  exp(cum)) S^T, 2 qc S H, where the incoming state can be nonzero (s0
  given, or an earlier chunk of the row with kv > 0); U_j over the kv rows,
  2 kv S H; G and the intra product over their causal entries (t' <= t)
  with t' < kv, 2 e (S + H), e = kv (kv + 1) / 2 + (qc - kv) kv. Past kv,
  v is 0 and those terms add only zeros. v is read everywhere; dl and c
  where the state can be nonzero or kv > 0 (elsewhere y = 0 and the state
  stays 0); b on the kv rows only; y and the states once."""
  dl, b_in, c_in, v = x[:4]
  b, t, n = dl.shape
  s_dim, h = b_in.shape[-1], v.shape[-1]
  q = min(chunk, t)
  flops, b_rows, c_rows = 0, 0, 0
  nzv = (v != 0).any(-1)                                  # [B, T, N]
  warm = torch.full((b, n), len(x) > 4, device=dl.device)  # state may be != 0
  for start in range(0, t, q):
    qc = min(q, t - start)
    step = torch.arange(1, qc + 1, device=dl.device)[None, :, None]
    kv = (nzv[:, start:start + qc] * step).amax(1).long()   # [B, N]
    e = kv * (kv + 1) // 2 + (qc - kv) * kv
    flops += int(warm.sum()) * 2 * qc * s_dim * h
    flops += int((2 * kv * s_dim * h + 2 * e * (s_dim + h)).sum())
    b_rows += int(kv.sum())
    c_rows += int((warm | (kv > 0)).sum()) * qc
    warm |= kv > 0
  moved = (c_rows * (1 + s_dim) + v.numel() + b_rows * s_dim
           + b * t * n * h + b * n * h * s_dim * (2 if len(x) > 4 else 1)) * 4
  return flops, moved


def _BoundShare(ms, bound):
  """bound / kernel time; a kernel under a bound (work it skipped) reads
  as 'below', never as more than 100%."""
  return f"{bound / ms:.1%}" if bound <= ms else "below it"


def _CheckScan(torch, ssd, label, x, moved, chunk=64):
  """The scan kernel against `_ChunkedPlain` on the card, two calls
  bitwise equal; prints the launch geometry; times both."""
  dl, b_in, c_in, v = x[:4]
  s0 = x[4] if len(x) > 4 else None
  y, s_fin = ssd.SsdScan(dl, b_in, c_in, v, s0=s0, chunk_size=chunk)
  y2, s_fin2 = ssd.SsdScan(dl, b_in, c_in, v, s0=s0, chunk_size=chunk)
  y_p, s_p = ssd.SsdScan(dl, b_in, c_in, v, s0=s0, chunk_size=chunk,
                         lowering="chunked")
  torch.cuda.synchronize()
  _Check(torch.equal(y, y2) and torch.equal(s_fin, s_fin2),
         f"scan {label}: two calls differ bitwise")
  del y2, s_fin2
  # both against `_ChunkedPlain` in float64 (information: how far each
  # float32 version is from the same formulas in float64)
  b, t, n = dl.shape
  flat = [a.double().transpose(1, 2).reshape(b * n, t, -1)
          for a in (b_in, c_in, v)]
  s0d = (s0.double().reshape(b * n, v.shape[-1], -1) if s0 is not None
         else torch.zeros((b * n, v.shape[-1], b_in.shape[-1]),
                          dtype=torch.float64, device=dl.device))
  y64, s64 = ssd._ChunkedPlain(dl.double().transpose(1, 2).reshape(b * n, t),
                               *flat, s0d, chunk)
  y64 = y64.reshape(b, n, t, -1).transpose(1, 2)
  s64 = s64.reshape(s_fin.shape)
  print(f"scan {label} against float64: kernel y "
        f"{float((y - y64).abs().max()):.3g}, state "
        f"{float((s_fin - s64).abs().max()):.3g}; plain y "
        f"{float((y_p - y64).abs().max()):.3g}, state "
        f"{float((s_p - s64).abs().max()):.3g}")
  del y64, s64, flat
  err = 0.0
  for name, got, want in (("y", y, y_p), ("s_final", s_fin, s_p)):
    _Check(bool(torch.isfinite(got).all()), f"scan {label} {name}: non-finite")
    e = float((got - want).abs().max())
    tol = SCAN_TOL * max(1.0, float(want.abs().max()))
    print(f"scan {label} {name}: max abs err {e:.3g} (tol {tol:.3g})")
    _Check(e <= tol, f"scan {label} {name}: {e} > {tol}")
    err = max(err, e)
  s_dim, h = b_in.shape[-1], v.shape[-1]
  geo = ssd.KernelGeometry(t, s_dim, h, chunk)
  print(f"scan {label}: two calls bitwise equal; grid ({geo['cluster']} x "
        f"{b * n}, {geo['h_groups']}), cluster {geo['cluster']} "
        f"({geo['per_block']} of {geo['chunks']} chunks a block, "
        f"{geo['stages']} ring stages), {geo['threads']} threads, "
        f"{geo['smem']} B shared per block, {geo['regs']} registers, "
        f"{geo['local']} B local, {geo['per_sm']} blocks resident per SM, "
        f"{geo['clusters']} clusters resident")
  flops = _ScanFlops(t, min(chunk, t), s_dim, h) * b * n
  live_flops, live_moved = _ScanLiveWork(torch, x, chunk)
  ms = _TimeMs(torch, lambda: ssd.SsdScan(dl, b_in, c_in, v, s0=s0,
                                          chunk_size=chunk), 20)
  plain_ms = _TimeMs(torch, lambda: ssd.SsdScan(
      dl, b_in, c_in, v, s0=s0, chunk_size=chunk, lowering="chunked"), 3,
      waits_as="plain scan")
  bound = _Bound(moved, flops)
  live = _Bound(live_moved, live_flops)
  print(f"scan {label} [{b}, {t}, {n}] S={s_dim} H={h} chunk {chunk}: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; full-work bound "
        f"{bound[0]:.4f} ms ({bound[1]}; {flops / 1e9:.3f} GFLOP, "
        f"{moved / 1e6:.1f} MB; {_BoundShare(ms, bound[0])}), live-work "
        f"bound {live[0]:.4f} ms ({live[1]}; {live_flops / 1e9:.3f} GFLOP, "
        f"{live_moved / 1e6:.1f} MB; {_BoundShare(ms, live[0])})")
  return dict(ms=ms, plain_ms=plain_ms, bound=bound, live_bound=live,
              err=err, geometry=geo)


def _FlashInputs(torch, rng):
  """The flash check at the training step's shapes: [8, 1024, 16, 128],
  causal, two segments of 512 per row, and row 0's last 100 tokens padding
  (segment 0)."""
  b, t, n, h = 8, 1024, 16, 128
  seg = np.repeat(np.array([[1] * 512 + [2] * 512]), b, axis=0)
  seg[0, -100:] = 0
  seg = seg.astype(np.int32)
  q, k, v, do = (rng.randn(b, t, n, h).astype(np.float32) for _ in range(4))
  keep = (seg[:, :, None] == seg[:, None, :]) & np.tril(
      np.ones((t, t), bool))[None]
  pairs = int(keep.sum()) * n            # attended (query, key) pairs
  x = {k_: torch.as_tensor(a).cuda() for k_, a in
       dict(q=q, k=k, v=v, do=do, seg=seg).items()}
  return x, torch.as_tensor(keep).cuda(), pairs


def _Bound(moved, flops, peak=FP32_FLOPS_PER_S):
  bytes_ms = moved / HBM_BYTES_PER_S * 1e3
  ops_ms = flops / peak * 1e3
  return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _CheckFlash(torch, fa, rng):
  """The three flash kernels against the plain version on the card."""
  x, keep, pairs = _FlashInputs(torch, rng)
  q, k, v, do, seg = x["q"], x["k"], x["v"], x["do"], x["seg"]
  b, t, n, h = q.shape
  out, lse = fa.FlashForward(q, k, v, seg, True)
  out2, lse2 = fa.FlashForward(q, k, v, seg, True)
  out_p, lse_p = fa._PlainForward(q, k, v, seg, True)
  delta = fa.RowDelta(do, out)
  dk, dv = fa.FlashDkDv(q, k, v, seg, do, lse, delta, True)
  dq = fa.FlashDq(q, k, v, seg, do, lse, delta, True)
  dk2, dv2 = fa.FlashDkDv(q, k, v, seg, do, lse, delta, True)
  dq2 = fa.FlashDq(q, k, v, seg, do, lse, delta, True)
  dq_p, dk_p, dv_p = fa._PlainBackward(q, k, v, seg, do, True)
  torch.cuda.synchronize()
  errs = {}
  print("tolerances: out, lse 2e-5 (one float32 softmax over <= 512 keys, "
        "summed in two orders); dq, dk, dv 1e-4 x max|grad| (float32 sums "
        "over up to 512 queries or keys of O(1) products, so the bar scales "
        "with the gradient's size)")
  for name, got, want, tol in (
      ("out", out, out_p, 2e-5), ("lse", lse, lse_p, 2e-5),
      ("dq", dq, dq_p, 1e-4 * float(dq_p.abs().max())),
      ("dk", dk, dk_p, 1e-4 * float(dk_p.abs().max())),
      ("dv", dv, dv_p, 1e-4 * float(dv_p.abs().max()))):
    _Check(bool(torch.isfinite(got).all()), f"flash {name}: non-finite")
    err = float((got - want).abs().max())
    print(f"flash {name}: max abs err {err:.3g} (tol {tol:.3g})")
    _Check(err <= tol, f"flash {name}: max abs err {err} > {tol}")
    errs[name] = err
  _Check(torch.equal(out, out2) and torch.equal(lse, lse2),
         "flash forward: two calls differ bitwise")
  threads, smem, per_sm = fa.ForwardGeometry(t, h)
  print(f"flash forward: two calls bitwise equal; grid ({-(-t // 64)}, "
        f"{b * n}), {threads} threads, {smem} B shared per block, {per_sm} "
        "blocks resident per SM")
  _Check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
         "flash dK/dV: two calls differ bitwise")
  _Check(torch.equal(dq, dq2), "flash dQ: two calls differ bitwise")
  for name, g in fa.BackwardGeometry(t, h).items():
    print(f"flash {name}: two calls bitwise equal; grid ({b * n}, "
          f"{g['tiles']}), {g['threads']} threads, {g['smem']} B shared per "
          f"block, {g['per_sm']} blocks resident per SM")
  del dk2, dv2, dq2
  it = 10
  t_fwd = _TimeMs(torch, lambda: fa.FlashForward(q, k, v, seg, True), it)
  t_dkdv = _TimeMs(torch, lambda: fa.FlashDkDv(q, k, v, seg, do, lse, delta,
                                               True), it)
  t_dq = _TimeMs(torch, lambda: fa.FlashDq(q, k, v, seg, do, lse, delta,
                                           True), it)
  p_fwd = _TimeMs(torch, lambda: fa._PlainForward(q, k, v, seg, True), 3,
                  waits_as="plain flash forward")
  p_bwd = _TimeMs(torch, lambda: fa._PlainBackward(q, k, v, seg, do, True),
                  3, waits_as="plain flash backward")
  # the library yardstick: SDPA with the boolean causal-and-segment mask
  sdpa = torch.nn.functional.scaled_dot_product_attention
  mask = keep[:, None]
  qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
  l_fwd = _TimeMs(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask), it,
                  waits_as="SDPA forward")
  leaves = [a.detach().requires_grad_(True) for a in (qt, kt, vt)]
  with torch.enable_grad():
    ref = sdpa(*leaves, attn_mask=mask)
  dot = do.transpose(1, 2)
  l_bwd = _TimeMs(torch, lambda: torch.autograd.grad(
      ref, leaves, dot, retain_graph=True), it, waits_as="SDPA backward")
  row = b * t * n * h * 4                 # one [b, t, n, h] f32 tensor
  stats = b * n * t * 4                   # one [b, n, t] f32 row statistic
  seg_b = b * t * 4
  res = {
      "fwd": dict(ms=t_fwd, plain_ms=p_fwd, library_ms=l_fwd,
                  bound=_Bound(4 * row + stats + seg_b, 4 * h * pairs),
                  err=max(errs["out"], errs["lse"])),
      "dkdv": dict(ms=t_dkdv, plain_ms=p_bwd, library_ms=l_bwd,
                   bound=_Bound(6 * row + 2 * stats + seg_b, 8 * h * pairs),
                   err=max(errs["dk"], errs["dv"])),
      "dq": dict(ms=t_dq, plain_ms=p_bwd, library_ms=l_bwd,
                 bound=_Bound(5 * row + 2 * stats + seg_b, 6 * h * pairs),
                 err=errs["dq"]),
  }
  for name, r in res.items():
    print(f"flash {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
          f"ms, bound {r['bound'][0]:.3f} ms ({r['bound'][1]}), SDPA "
          f"{r['library_ms']:.3f} ms")
  print(f"flash backward: dK/dV + dQ kernels {t_dkdv + t_dq:.3f} ms vs SDPA "
        f"backward {l_bwd:.3f} ms (the plain backward, {p_bwd:.3f} ms, and "
        "SDPA's each compute dq, dk and dv at once)")
  print(f"attended pairs {pairs} ({pairs / (b * n):.0f} per (b, n))")
  return res


def _Share(torch, got, want):
  """The share of elements of a bf16 result that differ from the plain
  version's by more than 1e-5 x max|want| (the floor spares the noise of
  exact cancellations; one bf16 rounding of a value above it counts)."""
  got, want = got.float(), want.float()
  floor = 1e-5 * float(want.abs().max())
  return float(((got - want).abs() > floor).float().mean())


def _UlpExcess(torch, got, want):
  """(elements off by more than one bf16 ulp, the largest |got - want| /
  (2^-7 |want| + 1e-5 max|want|)): the most that float32 sums of the same
  terms in two orders can move a single bf16 rounding. `_Share` bounds
  how many elements differ, this how far any of them is off."""
  got, want = got.float(), want.float()
  ratio = (got - want).abs() / (
      2.0 ** -7 * want.abs() + 1e-5 * float(want.abs().max()))
  return int((ratio > 1).sum()), float(ratio.max())


# what the kernels JSON line says of the bf16 backward kernels' design
_BF16_BWD_DESIGN = {
    "flash_dkdv_bf16": "wgmma m64n64k16 (S^T, dP^T; SS) and m64n128k16 "
                       "(dV, dK; A from registers) fed by TMA: 128 owned "
                       "keys, two consumer warpgroups, a producer "
                       "warpgroup at setmaxnreg 24 / 240, a 3-stage ring "
                       "of 64-query tiles, gradients stored by TMA",
    "flash_dq_bf16": "wgmma m64n128k16 (S, dP; SS) and m64n128k16 (dQ; A "
                     "from registers) fed by TMA: 128 owned queries, two "
                     "consumer warpgroups, a producer warpgroup at "
                     "setmaxnreg 24 / 240, a 2-stage ring of 128-key tiles, "
                     "dq stored by TMA",
}


def _CheckFlashBf16(torch, fa, rng):
  """The bf16 flash kernels against the Pallas twins at [8, 1024, 16, 128]
  on dyadic q, k, v and do; the tile-max control; times, bounds, SDPA."""
  x, keep, pairs = _FlashInputs(torch, rng)
  # dyadic: q.k and dp = do.v exact in any order, so each bf16 rounding of
  # p and ds rounds the same value on both sides
  q, k, v, do = (torch.round(x[n] * 8) / 8 for n in ("q", "k", "v", "do"))
  q, k, v, do = (a.bfloat16().contiguous() for a in (q, k, v, do))
  seg = x["seg"]
  del x
  b, t, n, h = q.shape
  block_k = fa.FitBlock(t)
  out, lse = fa.FlashForward(q, k, v, seg, True)
  out2, lse2 = fa.FlashForward(q, k, v, seg, True)
  out_p, lse_p = fa._PallasForward(q, k, v, seg, True, block_k)
  delta = fa.RowDelta(do, out)
  dk, dv = fa.FlashDkDv(q, k, v, seg, do, lse, delta, True)
  dq = fa.FlashDq(q, k, v, seg, do, lse, delta, True)
  dk2, dv2 = fa.FlashDkDv(q, k, v, seg, do, lse, delta, True)
  dq2 = fa.FlashDq(q, k, v, seg, do, lse, delta, True)
  dq_p, dk_p, dv_p = fa._PallasBackward(q, k, v, seg, do, lse, delta, True)
  control = fa._PallasForward(q, k, v, seg, True, 64)[0]
  torch.cuda.synchronize()
  print(f"bf16 tolerances: out, dq, dk, dv differ in <= 1e-3 of their "
        f"elements by more than 1e-5 x max|want| (float32 sums of exact "
        f"products in other orders, one bf16 rounding), and no element by "
        f"more than 2^-7 |want| + 1e-5 max|want| (one bf16 ulp); lse 2e-5. "
        f"Reference key block {block_k}")
  errs, shares = {}, {}
  lse_err = float((lse - lse_p).abs().max())
  print(f"flash bf16 lse: max abs err {lse_err:.3g} (tol 2e-5)")
  _Check(lse_err <= 2e-5, f"flash bf16 lse: {lse_err} > 2e-5")
  for name, got, want in (("out", out, out_p), ("dq", dq, dq_p),
                          ("dk", dk, dk_p), ("dv", dv, dv_p)):
    _Check(got.dtype == torch.bfloat16, f"flash bf16 {name}: {got.dtype}")
    _Check(bool(torch.isfinite(got.float()).all()),
           f"flash bf16 {name}: non-finite")
    share = _Share(torch, got, want)
    err = float((got.float() - want.float()).abs().max())
    over, ratio = _UlpExcess(torch, got, want)
    print(f"flash bf16 {name}: {share:.3g} of elements differ (tol 1e-3), "
          f"max abs err {err:.3g}, largest error {ratio:.3g} x its one-ulp "
          f"bar, {over} elements over it (tol 0)")
    _Check(share <= 1e-3, f"flash bf16 {name}: {share} of elements differ")
    _Check(over == 0, f"flash bf16 {name}: {over} elements off by more than "
           f"one bf16 ulp (largest {ratio:.3g} x the bar)")
    errs[name], shares[name] = err, share
  ctl = _Share(torch, control, out_p)
  print(f"control (p rounded at 64-key tile maxima): {ctl:.3g} of out "
        f"elements differ, {ctl / max(_Share(torch, out, out_p), 1e-3):.1f}"
        " x the bar")
  _Check(ctl >= 10 * max(_Share(torch, out, out_p), 1e-3),
         f"the tile-max control differs in only {ctl} of out elements")
  _Check(torch.equal(out, out2) and torch.equal(lse, lse2),
         "flash bf16 forward: two calls differ bitwise")
  threads, smem, per_sm = fa.ForwardGeometry(t, h, torch.bfloat16)
  print(f"flash bf16 forward: two calls bitwise equal; grid ({b * n}, "
        f"{-(-t // 128)}) (heaviest query tiles first), {threads} threads "
        f"(two consumer warpgroups, one TMA producer warp), {smem} B shared "
        f"per block, {per_sm} blocks resident per SM")
  _Check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
         "flash bf16 dK/dV: two calls differ bitwise")
  _Check(torch.equal(dq, dq2), "flash bf16 dQ: two calls differ bitwise")
  geometry = fa.BackwardGeometry(t, h, torch.bfloat16)
  for name, g in geometry.items():
    print(f"flash bf16 {name}: two calls bitwise equal; grid ({b * n}, "
          f"{g['tiles']}) (a (b, n)'s blocks start together, heaviest causal "
          f"tiles first), {g['threads']} threads ("
          + "two consumer warpgroups, a producer warpgroup at setmaxnreg "
          f"24 / 240), {g['smem']} B shared per block, {g['per_sm']} blocks "
          f"resident per SM, {g['regs']} registers per thread at launch, "
          f"{g['local']} B of local (spill) memory per thread")
    _Check(g["local"] == 0, f"flash bf16 {name}: {g['local']} B of local "
           "(spill) memory per thread")
  del control, out2, lse2, dk2, dv2, dq2
  it = 10
  t_fwd = _TimeMs(torch, lambda: fa.FlashForward(q, k, v, seg, True), it)
  t_dkdv = _TimeMs(torch, lambda: fa.FlashDkDv(q, k, v, seg, do, lse, delta,
                                               True), it)
  t_dq = _TimeMs(torch, lambda: fa.FlashDq(q, k, v, seg, do, lse, delta,
                                           True), it)
  p_fwd = _TimeMs(torch, lambda: fa._PallasForward(q, k, v, seg, True,
                                                   block_k), 3,
                  waits_as="plain bf16 flash forward")
  p_bwd = _TimeMs(torch, lambda: fa._PallasBackward(q, k, v, seg, do, lse,
                                                    delta, True), 3,
                  waits_as="plain bf16 flash backward")
  sdpa = torch.nn.functional.scaled_dot_product_attention
  mask = keep[:, None]
  qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
  l_fwd = _TimeMs(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask), it,
                  waits_as="SDPA bf16 forward")
  leaves = [a.detach().requires_grad_(True) for a in (qt, kt, vt)]
  with torch.enable_grad():
    ref = sdpa(*leaves, attn_mask=mask)
  dot = do.transpose(1, 2)
  l_bwd = _TimeMs(torch, lambda: torch.autograd.grad(
      ref, leaves, dot, retain_graph=True), it,
                  waits_as="SDPA bf16 backward")
  row = b * t * n * h * 2                 # one [b, t, n, h] bf16 tensor
  stats = b * n * t * 4                   # one [b, n, t] f32 row statistic
  seg_b = b * t * 4
  res = {
      "fwd": dict(ms=t_fwd, plain_ms=p_fwd, library_ms=l_fwd,
                  bound=_Bound(4 * row + stats + seg_b, 4 * h * pairs,
                               BF16_FLOPS_PER_S),
                  err=max(errs["out"], lse_err), share=shares["out"],
                  control_share=ctl),
      "dkdv": dict(ms=t_dkdv, plain_ms=p_bwd, library_ms=l_bwd,
                   bound=_Bound(6 * row + 2 * stats + seg_b, 8 * h * pairs,
                                BF16_FLOPS_PER_S),
                   err=max(errs["dk"], errs["dv"]),
                   share=max(shares["dk"], shares["dv"]),
                   geometry=geometry["dkdv"]),
      "dq": dict(ms=t_dq, plain_ms=p_bwd, library_ms=l_bwd,
                 bound=_Bound(5 * row + 2 * stats + seg_b, 6 * h * pairs,
                              BF16_FLOPS_PER_S),
                 err=errs["dq"], share=shares["dq"],
                 geometry=geometry["dq"]),
  }
  for name, r in res.items():
    print(f"flash bf16 {name}: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.4f} ms "
          f"({r['bound'][1]}), SDPA bf16 {r['library_ms']:.4f} ms")
  print(f"flash bf16 backward: dK/dV + dQ kernels {t_dkdv + t_dq:.4f} ms vs "
        f"SDPA bf16 backward {l_bwd:.4f} ms")
  return res


def _CheckXent(torch, fx, rng, block, ls, time_it, dtype="float32", m=8192,
               vocab=32000, vd=True):
  """The fused-xent statistics kernel against `_PlainStats` on the card:
  x [m, 2048], the table [vocab, 2048] (vd; else [2048, vocab]), cap 30,
  in `dtype`; two calls bitwise equal."""
  d = 2048
  dt = getattr(torch, dtype)
  x = torch.as_tensor(rng.randn(m, d).astype(np.float32)).cuda().to(dt)
  w = torch.as_tensor((rng.randn(vocab, d) / np.sqrt(d)).astype(
      np.float32)).cuda().to(dt)
  w_arg = w if vd else w.t().contiguous()
  bias = torch.zeros(vocab, device="cuda", dtype=dt)
  labels = torch.as_tensor(rng.randint(0, vocab, m).astype(np.int32)).cuda()
  cfg = fx._Cfg(block_size=block, vocab=vocab, vd=vd, soft_cap=30.0,
                label_smoothing=ls)
  got = fx.FusedXentStats(x, w_arg, bias, labels, cfg)
  again = fx.FusedXentStats(x, w_arg, bias, labels, cfg)
  want = fx._PlainStats(x, w_arg, bias, labels, cfg)
  torch.cuda.synchronize()
  _Check(all(torch.equal(a, b_) for a, b_ in zip(got, again)
             if a is not None), f"xent {dtype}: two calls differ bitwise")
  label = (f"xent {dtype} [{m}, {d}] x {'[V, D]' if vd else '[D, V]'} V "
           f"{vocab} block {block} ls {ls}")
  if dtype == "float32":
    geo = fx.StatsGeometry(m, vocab, torch.cuda.get_device_properties(
        0).multi_processor_count)
    threads, smem, per_sm = fx.KernelGeometry()
    split_cols = geo["tiles_per_split"] * geo["tile"]
    print(f"{label}: two calls bitwise equal; grid {geo['grid']} (row "
          f"tiles x vocab splits of {split_cols} columns; reference blocks "
          f"of {block}: a split edge on a block edge every "
          f"{np.lcm(split_cols, block)} columns), {threads} threads, {smem} "
          f"B shared per block, {per_sm} blocks resident per SM, "
          f"{geo['stages']} cp.async stages of {geo['depth']}; combine "
          f"kernel merges the {geo['splits']} splits in order")
  else:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, smem, per_sm = fx.KernelGeometry(torch.bfloat16)
    geo = fx.StatsGeometry(m, vocab, sms, per_sm)
    print(f"{label}: two calls bitwise equal; grid {geo['grid']} (row "
          f"tiles of 128 x vocab splits of {geo['tiles_per_split']} tiles "
          f"of 128 columns), {threads} threads (two consumer warpgroups "
          f"and a producer warp), {smem} B shared per block, {per_sm} "
          f"block(s) resident per SM, {fx.BF16_STATS_STAGES} TMA stages "
          f"of {fx.BF16_STATS_DEPTH} of D; combine kernel merges the "
          f"{geo['splits']} "
          "splits in order")
  errs = []
  print("tolerances: lse, label logit 1e-4 (capped logits of O(1), each a "
        "2048-term float32 dot in two orders); logit sum 5e-3 (adds 32000 "
        "of them)")
  for name, a, b_, tol in (("lse", got[0], want[0], 1e-4),
                           ("label_logit", got[1], want[1], 1e-4),
                           ("logit_sum", got[2], want[2], 5e-3)):
    if b_ is None:
      continue
    _Check(bool(torch.isfinite(a).all()), f"xent {name}: non-finite")
    err = float((a - b_).abs().max())
    print(f"{label}: {name} max abs err {err:.3g} (tol {tol})")
    _Check(err <= tol, f"xent {name}: {err} > {tol}")
    errs.append(err)
  differ = torch.nonzero(got[3] != want[3]).flatten()
  if len(differ):
    rows = x[differ].float()
    cap = lambda s: 30.0 * torch.tanh(s / 30.0)
    s_k = cap((rows * w[got[3][differ].long()].float()).sum(-1))
    s_p = cap((rows * w[want[3][differ].long()].float()).sum(-1))
    gap = float((s_k - s_p).abs().max())
    _Check(gap <= 1e-5, f"xent argmax differs on {len(differ)} rows whose "
           f"top logits differ by {gap} > 1e-5")
  print(f"{label}: argmax equal on {m - len(differ)} of {m} rows (the rest "
        f"are ties within 1e-5)")
  if not time_it:
    return dict(err=max(errs))
  ms = _TimeMs(torch, lambda: fx.FusedXentStats(x, w_arg, bias, labels, cfg),
               5)
  plain_ms = _TimeMs(torch, lambda: fx._PlainStats(x, w_arg, bias, labels,
                                                  cfg),
                     3, waits_as="plain xent stats")
  elem = x.element_size()
  bound = _Bound((m * d + vocab * d + vocab) * elem + m * 4 + 4 * m * 4,
                 2 * m * vocab * d,
                 BF16_FLOPS_PER_S if elem == 2 else FP32_FLOPS_PER_S)
  print(f"xent stats {dtype}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound[0]:.3f} ms ({bound[1]})")
  return dict(ms=ms, plain_ms=plain_ms, bound=bound, err=max(errs),
              library_ms=None)



def _TrainTask(cfg, warmup_steps=None, fprop_dtype=None):
  """cfg's Task with the flash kernel and the fused xent switched on (block
  1280), as the training main path runs it; fprop_dtype (torch.bfloat16)
  is the Params override of mixed-precision training."""
  from lingvo_tpu_torch.core import attention
  p = cfg.Task()
  p.fprop_dtype = fprop_dtype
  p.atten_tpl = attention.MultiHeadedAttention.Params().Set(
      use_flash_attention=True)
  p.xent_block_size = 1280
  if warmup_steps is not None:
    p.train.learner.lr_schedule.warmup_steps = warmup_steps
  return p


def _TinyTrain(torch, spi, program, p, device, init):
  """DenseLmTiny from the state dict `init` trains 3 steps on `device`:
  ([loss], [grad_norm], [[theta leaf as numpy]]) per step."""
  from lingvo_tpu_torch import convert
  cfg = spi.DenseLmTiny()
  lm = p.Instantiate(device=device)
  lm.load_state_dict(init)
  state = lm.CreateTrainState()
  prog = program.TrainProgram(
      program.TrainProgram.Params().Set(steps_per_loop=1), task=lm,
      input_generator=cfg.Train().Instantiate())
  losses, norms, thetas = [], [], []
  for _ in range(3):
    out = prog.Run(state)[1]
    losses.append(out["loss"])
    norms.append(out["grad_norm"])
    # copies: on the CPU a leaf's array shares the parameter's memory
    thetas.append([np.array(x) for x in convert.ThetaToNumpy(lm).Flatten()])
  return losses, norms, thetas


@contextlib.contextmanager
def _KernelLowering(fa):
  """On the CPU, bf16 FlashAttention runs the Pallas twins (the kernels'
  semantics, the reference's TPU rule) at any size, as a CUDA tensor runs
  the kernels: the reference's off-TPU rule would run the _XlaAttention
  twin below XLA_FALLBACK_MAX_ELEMS, which rounds p elsewhere."""
  saved, fa.XLA_FALLBACK_MAX_ELEMS = fa.XLA_FALLBACK_MAX_ELEMS, 0
  try:
    yield
  finally:
    fa.XLA_FALLBACK_MAX_ELEMS = saved


def _UpdateErr(got, want, start):
  """||got - want|| / ||want - start|| over every theta leaf."""
  return float(np.sqrt(sum(np.sum((g - w) ** 2) for g, w in zip(got, want)))
               / np.sqrt(sum(np.sum((w - s) ** 2)
                             for w, s in zip(want, start))))


def _TinyTrainReference(torch, spi, program, fa, fprop_dtype=None):
  """DenseLmTiny (both switches on, warmup 2 so that theta moves) trains 3
  steps on the card and on the CPU from the same weights, the CPU path
  being held against the JAX reference by tests/test_torch_train.py and,
  in bfloat16, tests/test_torch_bf16_*.py. float32: losses and theta
  within 1e-4. bfloat16 (every leaf trains), with the CPU's flash calls
  on the kernels' lowering (`_KernelLowering`), at the bars of
  tests/test_torch_bf16_steps.py's run that trains every leaf: steps 1
  and 2 loss and grad_norm within 5e-5, step 3 loss within 1e-3, and the
  relative error of the update ||theta_cuda - theta_cpu|| / ||theta_cpu
  - theta_0|| after step 3 within 2e-2; after step 2, where that test
  holds 1e-2, within 2e-2 too. The control, the card at fprop float32,
  must fail every bar and miss the step 1 and 2 loss bars by 10x. The
  update's bars have no 10x control: the same CPU program with oneDNN
  off, which only sums its GEMMs in another order, moves the update by
  about 1% (printed beside the card's reading), and the cuBLAS GEMMs of
  the card sum in yet another order."""
  from lingvo_tpu_torch import convert
  cfg = spi.DenseLmTiny()
  p = _TrainTask(cfg, warmup_steps=2, fprop_dtype=fprop_dtype)
  cpu_lm = p.Instantiate(device="cpu")
  cpu_lm.InstantiateVariables(torch.Generator("cpu").manual_seed(2))
  init = cpu_lm.state_dict()
  start = [np.array(x) for x in convert.ThetaToNumpy(cpu_lm).Flatten()]
  del cpu_lm
  if fprop_dtype is None:
    cpu = _TinyTrain(torch, spi, program, p, "cpu", init)
    gpu = _TinyTrain(torch, spi, program, p, "cuda", init)
    loss_err = max(abs(a - b) for a, b in zip(cpu[0], gpu[0]))
    theta_err = max(float(np.abs(a - b).max())
                    for a, b in zip(cpu[2][-1], gpu[2][-1]))
    moved = max(float(np.abs(a - c).max())
                for a, c in zip(cpu[2][-1], start))
    print(f"tiny train reference (float32): losses {cpu[0]} (cpu), "
          f"{gpu[0]} (cuda); max loss err {loss_err:.3g} (<= 1e-4), max "
          f"theta err {theta_err:.3g} (<= 1e-4); theta moved by up to "
          f"{moved:.3g}")
    _Check(moved > 1e-4, f"tiny train: theta did not move ({moved})")
    _Check(loss_err <= 1e-4, f"tiny train losses cuda vs cpu: {loss_err}")
    _Check(theta_err <= 1e-4, f"tiny train theta cuda vs cpu: {theta_err}")
    return
  with _KernelLowering(fa):
    cpu = _TinyTrain(torch, spi, program, p, "cpu", init)
  runs = {
      "cuda": lambda: _TinyTrain(torch, spi, program, p, "cuda", init),
      "control (cuda, fprop float32)": lambda: _TinyTrain(
          torch, spi, program, p.Copy().Set(fprop_dtype=None), "cuda",
          init),
      # for the record: the CPU path at its own, off-TPU lowering (the
      # xla twin), and the CPU at the kernels' lowering with oneDNN off
      # (the same program, its GEMMs summed in another order)
      "cpu, xla-twin lowering": lambda: _TinyTrain(
          torch, spi, program, p, "cpu", init)}
  errs = {}
  for name, run in runs.items():
    got = run()
    errs[name] = ([abs(got[0][i] - cpu[0][i]) for i in range(3)],
                  [abs(got[1][i] - cpu[1][i]) for i in range(2)],
                  [_UpdateErr(got[2][i], cpu[2][i], start)
                   for i in (1, 2)])
  mkldnn = torch.backends.mkldnn.enabled
  try:
    torch.backends.mkldnn.enabled = False
    with _KernelLowering(fa):
      got = _TinyTrain(torch, spi, program, p, "cpu", init)
  finally:
    torch.backends.mkldnn.enabled = mkldnn
  errs["cpu, oneDNN off"] = (
      [abs(got[0][i] - cpu[0][i]) for i in range(3)],
      [abs(got[1][i] - cpu[1][i]) for i in range(2)],
      [_UpdateErr(got[2][i], cpu[2][i], start) for i in (1, 2)])
  print(f"tiny train reference (bfloat16, every leaf trains): losses "
        f"{cpu[0]} on the cpu at the kernels' lowering; against it "
        "(loss err steps 1-3, grad_norm err steps 1-2, relative update "
        "err after steps 2-3):")
  for name, (le, ge, ue) in errs.items():
    print(f"  {name}: loss err {le}, grad_norm err {ge}, update err {ue}")
  print("bars: loss 5e-5, 5e-5, 1e-3; grad_norm 5e-5, 5e-5; update 2e-2, "
        "2e-2; the control must fail each and miss the step 1-2 loss bars "
        "by 10x")
  moved = max(float(np.abs(a - c).max()) for a, c in zip(cpu[2][-1], start))
  _Check(moved > 1e-4, f"tiny train: theta did not move ({moved})")
  bars = ((5e-5, 5e-5, 1e-3), (5e-5, 5e-5), (2e-2, 2e-2))
  names = ("loss at step", "grad_norm at step", "update after step")
  firsts = (1, 1, 2)
  ctl = errs["control (cuda, fprop float32)"]
  for got, miss, bar, name, first in zip(errs["cuda"], ctl, bars, names,
                                         firsts):
    for i, (g, m, b) in enumerate(zip(got, miss, bar)):
      _Check(g <= b, f"tiny bf16 {name} {first + i} cuda vs cpu: {g} > {b}")
      _Check(m > b, f"tiny bf16 control {name} {first + i}: {m} <= {b}")
  for i in range(2):
    _Check(ctl[0][i] >= 10 * bars[0][i], f"tiny bf16 control loss at step "
           f"{i + 1}: {ctl[0][i]} < 10 x {bars[0][i]}")


def _ModelFlops(lm, cfg, pairs_per_layer):
  """(model FLOPs of one training step, the formula). N = non-embedding
  parameters, T = tokens, P = attended pairs per layer, L = layers:
  6 N T (forward and backward of the matmuls) + 2 N T (their remat
  forward) + 6 V D T (the tied head: forward, d_hidden, d_emb) +
  L (4 + 8 + 4) H P (attention forward, backward, remat forward)."""
  n = sum(x.numel() for x in lm.parameters()) - lm.emb.emb.numel()
  tokens = cfg.BATCH_SIZE * cfg.SEQUENCE_LENGTH
  h = cfg.MODEL_DIM // cfg.NUM_HEADS
  flops = (8 * n * tokens + 6 * cfg.VOCAB_SIZE * cfg.MODEL_DIM * tokens
           + cfg.NUM_LAYERS * 16 * h * pairs_per_layer)
  return flops, ("8 N T + 6 V D T + 16 L H P with N = "
                 f"{n}, T = {tokens}, V = {cfg.VOCAB_SIZE}, D = "
                 f"{cfg.MODEL_DIM}, L = {cfg.NUM_LAYERS}, H = {h}, P = "
                 f"{pairs_per_layer}")


def _ProfileTrainStep(torch, prog, state):
  """One training step under torch.profiler: device busy ms, the shares of
  the GEMMs, the three flash kernels and the xent kernel, the top 5
  kernels, the top 10 aten ops by self device time, and the remat
  replay's casts."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    prog.Run(state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  # the remat replay's profiler range (transformer._RematContexts) is
  # recorded on the device too; it is no kernel
  kernels = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and _DevUs(e) > 0
             and e.key != "remat_replay"]
  busy_ms = sum(_DevUs(e) for e in kernels) / 1e3
  if busy_ms == 0:
    print("profiled train step: the profiler recorded no device time")
    return
  kernels.sort(key=_DevUs, reverse=True)
  share = lambda *keys: sum(_DevUs(e) for e in kernels if any(
      k in e.key for k in keys)) / 1e3 / busy_ms
  gemm = sum(_DevUs(e) for e in kernels if any(
      n in e.key.lower() for n in ("gemm", "cutlass", "nvjet")))
  gemm = gemm / 1e3 / busy_ms
  print(f"profiled one train step: device busy {busy_ms:.1f} ms of "
        f"{wall_ms:.1f} ms wall ({busy_ms / wall_ms:.1%}); GEMMs {gemm:.1%},"
        f" flash fwd {share('FlashFwdKernel', 'FlashFwdBf16Kernel'):.1%}, "
        f"dK/dV {share('FlashDkDvKernel', 'FlashDkDvBf16Kernel'):.1%}, dQ "
        f"{share('FlashDqKernel', 'FlashDqBf16Kernel'):.1%}, fused xent "
        f"{share('FusedXentStatsKernel', 'FusedXentStatsBf16Kernel'):.1%}, "
        f"the rest {1 - gemm - share('Flash', 'FusedXent'):.1%} of busy")
  for e in kernels[:5]:
    print(f"  {_DevUs(e) / 1e3:9.2f} ms  {e.count:6d} x  {e.key[:90]}")
  ops = sorted((e for e in prof.key_averages()
                if e.device_type == DeviceType.CPU
                and e.key.startswith("aten::") and _DevUs(e) > 0),
               key=_DevUs, reverse=True)
  print("the 10 aten ops with the largest self device time (the kernels "
        "each launches itself) in the profiled step:")
  for e in ops[:10]:
    print(f"  {_DevUs(e) / 1e3:9.2f} ms  {e.count:6d} x  {e.key}")
  casts_ms, casts, replay_ms = _RematCasts(prof.events())
  print(f"remat replay: {replay_ms:.2f} ms of device time inside its "
        f"`remat_replay` ranges; its {casts} dtype casts (aten::_to_copy) "
        f"{casts_ms:.2f} ms ({casts_ms / busy_ms:.1%} of busy)")


def _RematCasts(events):
  """(device ms, count) of the dtype casts (`aten::_to_copy`, with what
  they call) inside the backward's `remat_replay` ranges
  (`transformer._RematContexts`), and the device ms of the ops in those
  ranges (the range's own record on the device is no kernel)."""
  dev = lambda e: e.device_time_total
  casts_us, casts, replay_us = 0.0, 0, 0.0
  for root in (e for e in events if e.name == "remat_replay"):
    replay_us += sum(dev(e) for e in root.cpu_children)
    stack = list(root.cpu_children)
    while stack:
      e = stack.pop()
      if e.name == "aten::_to_copy":
        casts_us += dev(e)
        casts += 1
      else:
        stack.extend(e.cpu_children)
  return casts_us / 1e3, casts, replay_us / 1e3


def _TrainMain(torch, spi, program, counters, pairs_per_layer,
               fprop_dtype=None):
  """DenseLm1B (flash on, xent block 1280, remat 'full') trained through
  TrainProgram on SyntheticLmInput(seed 0) at fprop_dtype (None: float32):
  1 warm-up step, then 4 counted steps with the kernel counts set to 0
  just before; then one profiled step. Returns the counted run's
  launches."""
  cfg = spi.DenseLm1B()
  p = _TrainTask(cfg, fprop_dtype=fprop_dtype)
  bf16 = fprop_dtype is not None
  suffix = "_bf16" if bf16 else ""
  peak, peak_name = ((BF16_FLOPS_PER_S, "989 TFLOP/s bf16") if bf16 else
                     (FP32_FLOPS_PER_S, "67 TFLOP/s float32"))
  t0 = time.perf_counter()
  lm = p.Instantiate(device="cuda")
  state = lm.CreateTrainState(torch.Generator("cuda").manual_seed(0))
  gen = cfg.Train().Set(seed=0).Instantiate()
  prog = lambda n: program.TrainProgram(
      program.TrainProgram.Params().Set(steps_per_loop=n), task=lm,
      input_generator=gen)
  torch.cuda.synchronize()
  print(f"DenseLm1B train task: {sum(x.numel() for x in lm.parameters()):,}"
        f" params, fprop_dtype {lm.fprop_dtype}, weights "
        f"{next(lm.parameters()).dtype}, remat {p.remat_policy!r}, built in "
        f"{time.perf_counter() - t0:.1f} s")
  t0 = time.perf_counter()
  state, out = prog(1).Run(state)
  print(f"warm-up step: {time.perf_counter() - t0:.2f} s, loss "
        f"{out['loss']:.4f}")
  counted = prog(4)
  torch.cuda.synchronize()
  counters.Zero()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state, out = counted.Run(state)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = counters.Read()
  _Check(np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"]),
         f"non-finite loss or grad_norm: {out}")
  _Check(out["skipped_step"] == 0, f"a step was skipped: {out}")
  want = dict.fromkeys(counters, 0)
  want.update({"flash_attention_fwd" + suffix: 48 * 4,
               "flash_attention_dkdv" + suffix: 24 * 4,
               "flash_attention_dq" + suffix: 24 * 4,
               "fused_xent_fwd" + suffix: 4})
  _Check(launches == want, f"launches {launches} != {want} (4 steps)")
  flops, formula = _ModelFlops(lm, cfg, pairs_per_layer)
  ms = wall / 4 * 1e3
  print(f"trained 4 steps: {ms:.1f} ms/step, "
        f"{4 * cfg.BATCH_SIZE * cfg.SEQUENCE_LENGTH / wall:.1f} tokens/s, "
        f"loss {out['loss']:.4f}, grad_norm {out['grad_norm']:.4f}, "
        f"learning_rate {out['learning_rate']:.3g}, skipped "
        f"{out['skipped_step']}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
  print(f"launches in the 4 counted steps: {launches} (per step: flash fwd "
        "24 + 24 remat recompute, dK/dV 24, dQ 24, xent 1)")
  print(f"model FLOPs per step {flops / 1e12:.2f} TFLOP ({formula}); "
        f"achieved {flops / (ms / 1e3) / 1e12:.2f} TFLOP/s = "
        f"{flops / (ms / 1e3) / peak:.1%} of the {peak_name} peak")
  _ProfileTrainStep(torch, prog(1), state)
  return launches, ms


def _DevUs(e):
  return (getattr(e, "self_device_time_total", 0)
          or getattr(e, "self_cuda_time_total", 0))


def _KernelNodes(torch, fn):
  """(kernel nodes, all nodes) of the CUDA graph that one call of fn
  records when captured (never replayed): the kernels the call launches.
  torch.profiler is not used for this: over a short window late in this
  script it dropped some kernels' records. fn runs once first, so that
  its first-use work (build, attributes) is not captured."""
  import ctypes
  fn()
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph(keep_graph=True)
  with torch.cuda.graph(graph):
    fn()
  rt = None
  for lib in ("libcudart.so.12", "libcudart.so.13", "libcudart.so"):
    try:
      rt = ctypes.CDLL(lib)   # the runtime torch has loaded already
      break
    except OSError:
      continue
  _Check(rt is not None, "no CUDA runtime library to read a graph with")
  raw = ctypes.c_void_p(graph.raw_cuda_graph())
  count = ctypes.c_size_t(0)
  _Check(rt.cudaGraphGetNodes(raw, None, ctypes.byref(count)) == 0,
         "cudaGraphGetNodes failed")
  nodes = (ctypes.c_void_p * count.value)()
  _Check(rt.cudaGraphGetNodes(raw, nodes, ctypes.byref(count)) == 0,
         "cudaGraphGetNodes failed")
  kernels = 0
  for node in nodes:
    kind = ctypes.c_int(-1)
    _Check(rt.cudaGraphNodeGetType(ctypes.c_void_p(node),
                                   ctypes.byref(kind)) == 0,
           "cudaGraphNodeGetType failed")
    kernels += kind.value == 0    # cudaGraphNodeTypeKernel
  del graph
  return kernels, count.value


def _Profile(torch, eng, prompts, steps, window=4,
             windows=("first", "last")):
  """Serves the same requests again, stepping inline, and profiles only
  two windows of `window` steps: the first (prefill chunks beside decode
  rows) and the last (decode only) of the `steps` the schedule takes, or
  those of them named in `windows`.
  Prints, per window, device busy ms per step and its share of the wall,
  the shares of the GEMMs, the scan kernel, the attention kernel (ragged
  or block-decode) and the rest, the top kernels, the top host ops by
  their own host time and the cudaStreamSynchronize calls per step.
  Returns those calls per step, by window ('first', 'last')."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  for pr in prompts:
    eng.Submit(pr, 32, eos_id=None)
  done = 0
  syncs = {}
  for label, start in (("first", 0), ("last", steps - window)):
    if label not in windows:
      continue
    while done < start:
      eng.StepOnce()
      done += 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      for _ in range(window):
        eng.StepOnce()
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - t0) * 1e3
    done += window
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _DevUs(e) > 0]
    busy_ms = sum(_DevUs(e) for e in kernels) / 1e3
    if busy_ms == 0:
      print(f"{label} {window} steps: profiler recorded no device time")
      continue
    kernels.sort(key=_DevUs, reverse=True)
    attn = sum(_DevUs(e) for e in kernels if "RaggedAttend" in e.key
               or "BlockDecode" in e.key) / 1e3
    scan = sum(_DevUs(e) for e in kernels if "SsdScan" in e.key) / 1e3
    int8 = sum(_DevUs(e) for e in kernels if "Int8" in e.key) / 1e3
    sample = sum(_DevUs(e) for e in kernels if "SampleTokens" in e.key) / 1e3
    gemm = sum(_DevUs(e) for e in kernels if "Int8" not in e.key and any(
        n in e.key.lower() for n in ("gemm", "cutlass", "nvjet"))) / 1e3
    rest = busy_ms - attn - scan - gemm - int8 - sample
    print(f"profiled the {label} {window} of {steps} steps: device busy "
          f"{busy_ms / window:.2f} ms/step ({busy_ms / wall_ms:.1%} of the "
          f"wall under the profiler, {wall_ms / window:.2f} ms/step); of "
          f"busy: GEMMs {gemm / busy_ms:.1%}, int8 kernels "
          f"{int8 / busy_ms:.1%} ({int8 / window:.2f} ms/step), scan "
          f"{scan / busy_ms:.1%}, attention kernel {attn / busy_ms:.1%}, "
          f"sampling kernel {sample / busy_ms:.2%} "
          f"({sample / window * 1e3:.1f} us/step), rest {rest / busy_ms:.1%}")
    for e in kernels[:5]:
      print(f"  {_DevUs(e) / 1e3:9.2f} ms  {e.count:6d} x  {e.key[:90]}")
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    syncs[label] = sum(e.count for e in host
                       if e.key == "cudaStreamSynchronize") / window
    print(f"  cudaStreamSynchronize calls per step: {syncs[label]:g}")
    print(f"  host ops by self time (of {wall_ms / window:.2f} ms/step, "
          "profiler overhead included):")
    for e in host[:5]:
      print(f"  {e.self_cpu_time_total / 1e3 / window:9.2f} ms/step "
            f"{e.count // window:6d} x/step  {e.key[:70]}")
  _Check(not eng.sched.HasWork() and done == steps,
         f"profiled re-run took more than the counted run's {steps} steps")
  return syncs


def _Requests(cfg):
  """The serving phases' 8 prompts: 64..768 tokens, numpy seed 1."""
  prng = np.random.RandomState(1)
  lens = prng.permutation(np.linspace(64, 768, 8).astype(np.int32))
  return lens, [prng.randint(0, cfg.VOCAB_SIZE, size=n) for n in lens]


def _ServingLm(torch, cfg, fprop_dtype=None):
  """cfg's Task at full width and depth on the card (at `fprop_dtype`),
  random weights from torch.Generator("cuda") seed 0 (the same weights on
  every call)."""
  lm = cfg.Task().Set(fprop_dtype=fprop_dtype).Instantiate(device="cuda")
  lm.InstantiateVariables(torch.Generator("cuda").manual_seed(0))
  return lm


def _ServeMain(torch, cfg, engine, counters, per_step, per_decode_step=None,
               step_mode="ragged", kv_cache_dtype=None, lm=None,
               profile=True, syncs=None, serve_int8_weights=False,
               sample=None, seeds=None, order=None, max_new=32,
               windows=("first", "last")):
  """cfg's Task (`lm`, or `_ServingLm(cfg)`) through ServingLoop in
  `step_mode` with `kv_cache_dtype` pools: 8 requests with prompts of
  64..768 tokens (numpy seed 1) and `max_new` new tokens each, through
  Start/Submit/Result/Stop, with every kernel count set to 0 just before.
  sample: the engine's sampling arguments (greedy without); seeds: each
  request's seed (default: the request ids); order: the indices of the
  requests to submit, in that order (default: all 8 in order).
  per_step: {kernel: launches per engine step}; per_decode_step: {kernel:
  launches per decode-only step}; every other counted kernel must launch
  0 times. Then, with `profile`, the profiled re-run (its
  cudaStreamSynchronize calls per step, by window, into `syncs`; the
  `_Profile` windows named in `windows`).
  serve_int8_weights: the engine serves its int8 rewrite of the weights
  (whose bytes it prints). Returns (the counted run's launches, its steps,
  the streams in `order`, ms per step)."""
  name = type(cfg).__name__
  per_decode_step = per_decode_step or {}
  t0 = t_call = time.perf_counter()
  lm = lm or _ServingLm(torch, cfg)
  n_params = sum(p.numel() for p in lm.parameters())
  eng = engine.ServingLoop(lm, page_size=16, num_pages=512,
                           max_batch=cfg.BATCH_SIZE,
                           max_seq_len=cfg.SEQUENCE_LENGTH, prefill_chunk=256,
                           step_mode=step_mode, kv_cache_dtype=kv_cache_dtype,
                           serve_int8_weights=serve_int8_weights,
                           **(sample or {}))
  torch.cuda.synchronize()
  pool_bytes = sum(x.numel() * x.element_size()
                   for x in eng._states.Flatten())
  label = f"{name} ({step_mode}, {eng.kv_cache_dtype} KV" + (
      ", bf16 activations" if lm.fprop_dtype == torch.bfloat16 else "") + (
      ", int8 weights" if serve_int8_weights else "") + (
          f", sampled {sample}" if sample else "") + ")"
  if serve_int8_weights:
    print(f"{label}: int8 theta {_Int8ThetaBytes(eng._served.theta) / 1e9:.3f}"
          " GB (int8 values and float32 scales)")
  print(f"{label}: {n_params / 1e9:.3f} B params, engine T={eng._ragged_t}, "
        f"mixers {eng.mixers}, kv_bytes_per_token {eng.kv_bytes_per_token}, "
        f"paged_path {eng.paged_path}, pool {pool_bytes / 1e9:.3f} GB "
        f"allocated ({eng.alloc.Stats().get('pool_bytes', 0) / 1e9:.3f} GB "
        f"priced for the {eng.num_pages} allocator pages), built in "
        f"{time.perf_counter() - t0:.1f} s")
  eng.RunBatch(np.arange(1, 33, dtype=np.int32)[None], [32],
               max_new_tokens=2)   # warm-up: cuBLAS handles, allocator
  lens, prompts = _Requests(cfg)
  order = list(range(len(prompts))) if order is None else list(order)
  stats0 = eng.Stats()
  torch.cuda.synchronize()
  counters.Zero()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  eng.Start()
  handles = [eng.Submit(prompts[i], max_new, eos_id=None,
                        seed=None if seeds is None else seeds[i])
             for i in order]
  streams = [h.Result(timeout=900) for h in handles]
  eng.Stop()
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = counters.Read()
  stats = eng.Stats()
  steps = stats["steps"] - stats0["steps"]
  decode_steps = stats["decode_steps"] - stats0["decode_steps"]
  for st in streams:
    _Check(len(st) == max_new and all(0 <= x < cfg.VOCAB_SIZE for x in st),
           f"bad stream {st}")
  want = {k: per_step.get(k, 0) * steps
          + per_decode_step.get(k, 0) * decode_steps for k in counters}
  _Check(launches == want, f"{label}: launches {launches} != {want} "
         f"({per_step} per step x {steps} steps, {per_decode_step} per "
         f"decode-only step x {decode_steps})")
  _Check(stats["serve_int8_weights"] == serve_int8_weights,
         f"{label}: Stats serve_int8_weights {stats['serve_int8_weights']}")
  quantized = stats["quantized_steps"] - stats0["quantized_steps"]
  _Check(quantized == (steps if eng.kv_cache_dtype == "int8" else 0),
         f"{label}: quantized_steps {quantized} of {steps} steps")
  ttft = sorted(h.first_token_time - h.submit_time for h in handles)
  tpot = [(h.finish_time - h.first_token_time) / (max_new - 1)
          for h in handles]
  print(f"{label} served {len(order)} requests (prompts "
        f"{sorted(lens[order].tolist())}): {steps} steps ({decode_steps} "
        f"decode-only), {wall / steps * 1e3:.2f} ms/step, "
        f"{len(order) * max_new / wall:.1f} generated tok/s, "
        f"{int(lens[order].sum()) / wall:.1f} prompt tok/s, launches "
        f"{ {k: v for k, v in launches.items() if v} } = {per_step} x "
        f"{steps} + {per_decode_step} x {decode_steps}, quantized_steps "
        f"{quantized}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
  print(f"time to first token: median {np.median(ttft) * 1e3:.1f} ms, max "
        f"{ttft[-1] * 1e3:.1f} ms; time per output token: mean "
        f"{np.mean(tpot) * 1e3:.2f} ms")
  if profile:
    found = _Profile(torch, eng, prompts, steps, windows=windows)
    if syncs is not None:
      syncs.update(found)
  print(f"{label}: {time.perf_counter() - t_call:.1f} s in all")
  return launches, steps, streams, wall / steps * 1e3


def _DecodePool(torch, page, rng, dyadic=False, lens=None):
  """The block-decode check at page size `page` (see the module
  docstring): 8 rows of 16 heads of 128 with seq_lens 0..1024 (or `lens`),
  their live pages drawn from a 512 x 16-slot pool, every other page and
  table entry NaN, and the slots past each row's length in its last page
  NaN (dyadic: q and K made `_Dyadic`). Returns the CUDA tensors and the
  bytes and operations the read needs."""
  b, n, h, max_seq = 8, 16, 128, 1024
  t_pages = max_seq // page
  num_pages = 512 * 16 // page
  if lens is None:
    lens = np.array([0, 1, 130, 333, 512, 640, 901, 1024], np.int32)
  lens = np.asarray(lens, np.int32)
  need = [-(-int(x) // page) for x in lens]
  perm = rng.permutation(num_pages)
  owned = np.split(perm[:sum(need)], np.cumsum(need)[:-1])
  freed = perm[sum(need):]
  tables = rng.choice(freed, size=(b, t_pages)).astype(np.int32)
  for r in range(b):
    tables[r, :need[r]] = owned[r]
  shape = (num_pages + 1, page, n, h)
  k_pool = rng.randn(*shape).astype(np.float32)
  v_pool = rng.randn(*shape).astype(np.float32)
  if dyadic:
    k_pool = _Dyadic(k_pool, 1 / 8)
  dead = np.zeros(shape[:2], bool)
  dead[freed] = True
  for r in range(b):
    if need[r]:
      dead[owned[r][-1], lens[r] - (need[r] - 1) * page:] = True
  clean = (k_pool.copy(), v_pool.copy())
  for pool in (k_pool, v_pool):
    pool[dead] = np.nan
  q = (rng.randn(b, 1, n, h) / np.sqrt(h)).astype(np.float32)
  if dyadic:
    q = _Dyadic(q, 1 / 64)
  live = int(lens.sum())
  # live K/V at `elem` bytes per (slot, head), q read, out written
  moved = lambda elem: int(2 * live * n * elem + 2 * q.nbytes)
  flops = 4 * live * n * h
  cuda = {k: torch.as_tensor(v).cuda() for k, v in dict(
      q=q, k_pool=k_pool, v_pool=v_pool, tables=tables, lens=lens).items()}
  return cuda, moved, flops, dict(clean=clean, dead=dead)


def _BlockDecodeLayout(torch, bd, x, page, dtype="float32"):
  """The block-decode kernel's split and launch geometry at this pool."""
  t_pages = x["tables"].shape[1]
  geo = bd.KernelGeometry(128, page, t_pages, getattr(torch, dtype))
  return (f"cluster of {geo['splits']} blocks per (row, head) (NumSplits "
          f"of a {t_pages}-page table at P={page}; grid ({geo['splits']}, "
          f"{x['q'].shape[0] * x['q'].shape[2]})), {geo['threads']} threads, "
          f"{geo['smem_bytes']} B shared per block, warp tiles of "
          f"{geo['tile_slots']} slots, {geo['blocks_per_sm']} blocks "
          f"resident per SM")


def _OneNode(torch, label, fn):
  """One call of fn is one kernel node of a CUDA graph capture."""
  kernels, nodes = _KernelNodes(torch, fn)
  _Check(kernels == 1, f"{label}: one call is {kernels} kernel nodes "
         f"({nodes} nodes), not 1")


def _CheckBlockDecode(torch, bd, page, rng, lens=None, label=None):
  """The block-decode kernel against `_PlainBlockDecode` on the card: two
  calls bitwise equal, one kernel node per call."""
  label = label or f"block decode P={page}"
  x, moved, flops, _ = _DecodePool(torch, page, rng, lens=lens)
  moved = moved(128 * 4)
  args = (x["q"], x["k_pool"], x["v_pool"], x["tables"], x["lens"])
  call = lambda: bd.BlockDecode(*args, page_size=page)
  out, again = call(), call()
  plain = bd._PlainBlockDecode(x["q"][:, 0], *args[1:], page)[:, None]
  torch.cuda.synchronize()
  _Check(bool(torch.isfinite(out).all()), f"{label}: non-finite")
  _Check(torch.equal(out, again), f"{label}: two calls differ bitwise")
  inactive = (x["lens"] <= 0).nonzero().flatten()
  _Check(bool((out[inactive] == 0).all()), f"{label}: the inactive row is "
         "not exactly zero")
  err = float((out - plain).abs().max())
  _Check(err <= TOL, f"{label}: kernel vs plain max abs err {err} > {TOL}")
  _OneNode(torch, label, call)
  print(f"{label}: {_BlockDecodeLayout(torch, bd, x, page)}; two calls "
        "bitwise equal, one kernel node per call")
  ms = _TimeMs(torch, call, 20)
  plain_ms = _TimeMs(torch, lambda: bd._PlainBlockDecode(
      x["q"][:, 0], *args[1:], page), 3, waits_as="plain block decode")
  bound = _Bound(moved, flops)
  print(f"{label} tables {tuple(x['tables'].shape)} lens "
        f"{x['lens'].tolist()}: max abs err {err:.3g}, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; "
        f"{moved / 1e6:.1f} MB)")
  return dict(ms=ms, plain_ms=plain_ms, bound=bound, err=err, library_ms=None)


def _DecodeOnlyLens():
  """A legacy decode-only step's rows as phase 12 serves them: phase 5's
  8 prompts (64..768 tokens) with 1 to 32 generated tokens each."""
  prompt_lens = np.random.RandomState(1).permutation(
      np.linspace(64, 768, 8).astype(np.int32))   # `_Requests`' lengths
  return prompt_lens + np.array([1, 5, 9, 13, 17, 21, 25, 32], np.int32)


def _CheckFlashDecode(torch, fd, rng, prompt_lens, dtype="float32"):
  """The flash-decode kernel against `_PlainDecode` on the card at
  [8, 1152, 16, 128], page 128, on a `dtype` cache, with the left-pad
  cache paddings of `prompt_lens` right-aligned in a 1024 bucket (as
  GShardDecode builds them); padded slots hold NaN, and for t = 700 so do
  the slots past t. Times the kernel, the plain version, SDPA over the
  whole cache with the same boolean mask (for a bfloat16 cache, with q
  cast to bfloat16, as SDPA takes one dtype), and the bound: the live
  unpadded K/V slots, the paddings of the live pages, q and out. A
  bfloat16 cache holds dyadic K and takes a dyadic q (`_Dyadic`), and the
  float32 kernel on the widened cache is its unrounded control."""
  b, s, n, h, page, p_len = 8, 1152, 16, 128, 128, 1024
  cache_dtype = getattr(torch, dtype)
  elem = cache_dtype.itemsize
  slot = np.arange(s)
  pad = (slot[None] < (p_len - np.asarray(prompt_lens))[:, None]).astype(
      np.float32)
  q = (rng.randn(b, 1, n, h) / np.sqrt(h)).astype(np.float32)
  k = rng.randn(b, s, n, h).astype(np.float32)
  v = rng.randn(b, s, n, h).astype(np.float32)
  if dtype == "bfloat16":
    q, k = _Dyadic(q, 1 / 64), _Dyadic(k, 1 / 8)
  k[pad > 0.5] = np.nan
  v[pad > 0.5] = np.nan
  qc, padc = torch.as_tensor(q).cuda(), torch.as_tensor(pad).cuda()
  sdpa = torch.nn.functional.scaled_dot_product_attention
  res = {}
  for t in (1151, 700):
    kt, vt = k.copy(), v.copy()
    kt[:, t + 1:] = np.nan
    vt[:, t + 1:] = np.nan
    kc = torch.as_tensor(kt).cuda().to(cache_dtype)
    vc = torch.as_tensor(vt).cuda().to(cache_dtype)
    out = fd.FlashDecode(qc, kc, vc, t, page_size=page, cache_paddings=padc)
    again = fd.FlashDecode(qc, kc, vc, t, page_size=page,
                           cache_paddings=padc)
    plain = fd._PlainDecode(qc[:, 0], kc, vc, t, page, padc)[:, None]
    torch.cuda.synchronize()
    label = f"flash decode {dtype} t={t}"
    _Check(bool(torch.isfinite(out).all()), f"{label}: non-finite")
    _Check(torch.equal(out, again), f"{label}: two calls differ bitwise")
    threads, smem, per_sm, sms = fd.Geometry("cuda", cache_dtype)
    kernels, nodes = _KernelNodes(torch, lambda: fd.FlashDecode(
        qc, kc, vc, t, page_size=page, cache_paddings=padc))
    launched = f"{kernels} kernel(s), {nodes} graph node(s)"
    if dtype == "bfloat16":
      splits = fd.NumSplitsBf16(b * n, t, s, h, sms, per_sm)
      _Check(kernels == nodes == 1, f"{label}: one call launched "
             f"{launched}, not one kernel")
      print(f"{label}: two calls bitwise equal; {splits} splits of "
            f"{fd.TileSlots(h, elem)}-slot tiles as one cluster, grid "
            f"({splits}, {b * n}), cluster ({splits}, 1, 1), {threads} "
            f"threads, {smem} B shared per block at 128 score slots, "
            f"{per_sm} blocks resident per SM of {sms}; one call, captured "
            f"in a CUDA graph: {launched}")
    else:
      splits = fd.NumSplits(b * n, t, s, h, sms, per_sm, elem)
      print(f"{label}: two calls bitwise equal; {splits} splits of "
            f"{fd.TileSlots(h, elem)}-slot tiles, split grid ({b * n}, "
            f"{splits}), {threads} threads, {smem} B shared per block, "
            f"{per_sm} blocks resident per SM of {sms}; combine grid "
            f"({b * n},); one call, captured in a CUDA graph: {launched}")
    err = float((out - plain).abs().max())
    _Check(err <= TOL, f"{label}: kernel vs plain max abs err {err} > {TOL}")
    ctl_err = None
    if dtype == "bfloat16":
      ctl_err = float((fd.FlashDecode(
          qc, kc.float(), vc.float(), t, page_size=page,
          cache_paddings=padc) - plain).abs().max())
      _Unrounded(torch, label, err, ctl_err)
    keep = (slot[None] <= t) & (pad < 0.5)
    live = int(keep.sum())
    moved = (2 * live * n * h * elem + b * (t // page + 1) * page * 4
             + 2 * q.nbytes)
    ms = _TimeMs(torch, lambda: fd.FlashDecode(
        qc, kc, vc, t, page_size=page, cache_paddings=padc), 20)
    plain_ms = _TimeMs(torch, lambda: fd._PlainDecode(
        qc[:, 0], kc, vc, t, page, padc), 3, waits_as=f"plain {label}")
    mask = torch.as_tensor(keep).cuda()[:, None, None, :]
    qs, ks, vs = (a.transpose(1, 2) for a in (qc.to(cache_dtype), kc, vc))
    lib_ms = _TimeMs(torch, lambda: sdpa(qs, ks, vs, attn_mask=mask,
                                         scale=1.0), 20, waits_as="SDPA")
    enqueue_us = _EnqueueUs(torch, lambda: fd.FlashDecode(
        qc, kc, vc, t, page_size=page, cache_paddings=padc))
    print(f"{label}: host enqueue {enqueue_us:.1f} us per call (card busy; "
          "what the host-bound decode step pays per call)")
    bound = _Bound(moved, 4 * live * n * h)
    print(f"{label} [8, 1152, 16, 128] P={page}: {live} live slots, max abs "
          f"err {err:.3g} (tol {TOL}), kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, SDPA "
          f"{lib_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; "
          f"{moved / 1e6:.1f} MB)")
    res[t] = dict(ms=ms, plain_ms=plain_ms, bound=bound, err=err,
                  unrounded_err=ctl_err, library_ms=lib_ms)
    del kc, vc
  return res


def _GShardTiny(torch, spi, attention, checkpointer, gshard, tmp,
                kv_cache_dtype=None, serve_int8_weights=False, sample=None):
  """DenseLmTiny (decode_page_size 4, `kv_cache_dtype` caches, int8
  weights with `serve_int8_weights`, sampled with `sample`, the decoder's
  temperature and top_k) through GShardDecode on the card and on the CPU
  from one port checkpoint: the continuations must agree."""
  p = spi.DenseLmTiny().Task().Set(kv_cache_dtype=kv_cache_dtype)
  p.atten_tpl = attention.MultiHeadedAttention.Params().Set(
      decode_page_size=4)
  cpu_lm = p.Instantiate(device="cpu")
  cpu_lm.InstantiateVariables(torch.Generator("cpu").manual_seed(1))
  ckdir = os.path.join(tmp, f"tiny_{kv_cache_dtype}")
  checkpointer.Checkpointer(ckdir).Save(1, cpu_lm, force=True)
  gpu_lm = p.Instantiate(device="cuda")   # DecodeOnce restores its weights
  rng = np.random.RandomState(4)
  lens = np.array([5, 13, 21, 8, 2, 30], np.int32)
  prompts = rng.randint(1, 128, size=(len(lens), 30)).astype(np.int32)
  outs = {}
  for name, lm in (("cpu", cpu_lm), ("cuda", gpu_lm)):
    decoder = gshard.GShardDecode(
        lm, ckdir, os.path.join(tmp, f"tiny_{name}_{kv_cache_dtype}.jsonl"),
        max_decode_steps=12, prefill_chunk_size=8,
        serve_int8_weights=serve_int8_weights, **(sample or {}))
    outs[name] = [r["output_ids"] for r in decoder.DecodeOnce(1, prompts,
                                                             lens)]
  _Check(outs["cpu"] == outs["cuda"], "tiny GShardDecode continuations "
         f"differ:\n{outs['cpu']}\n{outs['cuda']}")
  print(f"DenseLmTiny GShardDecode reference ({kv_cache_dtype or 'float32'} "
        f"cache, {'int8' if serve_int8_weights else 'float32'} weights"
        f"{f', sampled {sample}' if sample else ''}): "
        f"{len(lens)} continuations of 12 tokens identical to the "
        "CPU path (page 4: the flash-decode read, the dense read for int8)")


def _ProfileDecodeSteps(torch, decoder, arr, lens, steps=16):
  """Prefills the 8 prompts again through the decoder's own phase
  functions, in a bucket of 1024 - steps so that the cache keeps 1024
  slots (a multiple of the page, so every step takes the flash-decode
  read), then profiles the `steps` greedy decode steps: device busy per
  step, its share of the wall under the profiler, the flash-decode
  kernels' and the GEMMs' shares of busy, the top kernels."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  from lingvo_tpu_torch.core import threefry
  p_len = 1024 - steps
  init_fn, prefill_fn, sample_fn = decoder._GetDecodeFn(p_len, steps)
  aligned = decoder._RightAlign(arr, lens, width=p_len)
  served = decoder._served[1] if decoder._served else None
  theta = served.Active() if served else contextlib.nullcontext()
  with torch.no_grad(), theta:
    lens_dev = torch.as_tensor(np.asarray(lens)).cuda()
    last, states = prefill_fn(torch.as_tensor(aligned).cuda(), lens_dev,
                              init_fn(arr.shape[0]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      sample_fn(last, lens_dev, threefry.PRNGKey(1), states)
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - t0) * 1e3
  kernels = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and _DevUs(e) > 0]
  busy_ms = sum(_DevUs(e) for e in kernels) / 1e3
  if busy_ms == 0:
    print("profiled decode steps: the profiler recorded no device time")
    return
  kernels.sort(key=_DevUs, reverse=True)
  fdec = sum(_DevUs(e) for e in kernels if "FlashDecode" in e.key) / 1e3
  int8 = sum(_DevUs(e) for e in kernels if "Int8" in e.key) / 1e3
  gemm = sum(_DevUs(e) for e in kernels if "Int8" not in e.key and any(
      n in e.key.lower() for n in ("gemm", "cutlass", "nvjet"))) / 1e3
  print(f"profiled {steps} GShardDecode steps (t {p_len}..1023): "
        f"device busy {busy_ms / steps:.2f} ms/step, {busy_ms / wall_ms:.1%}"
        f" of the wall under the profiler ({wall_ms / steps:.2f} ms/step); "
        f"flash decode {fdec / steps:.3f} ms/step ({fdec / busy_ms:.1%} of "
        f"busy), GEMMs {gemm / busy_ms:.1%}, int8 kernels "
        f"{int8 / busy_ms:.1%} ({int8 / steps:.3f} ms/step)")
  for e in kernels[:5]:
    print(f"  {_DevUs(e) / 1e3:9.2f} ms  {e.count:6d} x  {e.key[:90]}")


def _CheckTileBits(torch, attention):
  """The prefill's tile read on the card at DenseLm1B's shapes (8 rows, 16
  heads of 128, two tiles of 128 slots, float32): the last 2 (and 130)
  rows of a 256-query chunk bitwise equal to the same queries read as a
  chunk of their own, and its time per tile at C = 256."""
  rng = np.random.RandomState(13)
  b, n, h, tile, c = 8, 16, 128, 128, 256
  k = torch.as_tensor(rng.randn(b, 2 * tile, n, h).astype(np.float32)).cuda()
  v = torch.as_tensor(rng.randn(b, 2 * tile, n, h).astype(np.float32)).cuda()
  q = torch.as_tensor(rng.randn(b, c, n, h).astype(np.float32) / 11).cuda()
  pos = torch.arange(c, device="cuda") + 2 * tile - c

  def Read(qs, ps):
    cc = qs.shape[1]
    m = torch.full((b, cc, n, 1), -1.0e30, device="cuda")
    l = torch.zeros((b, cc, n, 1), device="cuda")
    acc = torch.zeros((b, cc, n, h), device="cuda")
    for start in (0, tile):
      slot = torch.arange(start, start + tile, device="cuda")
      keep = (slot[None, :] <= ps[:, None])[None, :, None, :]
      sl = slice(start, start + tile)
      m, l, acc = attention._TileAttend(qs, k[:, sl], v[:, sl], keep, m, l,
                                        acc)
    return m, l, acc

  with torch.no_grad():
    full = Read(q, pos)
    for cc in (2, 130):
      part = Read(q[:, c - cc:].contiguous(), pos[c - cc:])
      torch.cuda.synchronize()
      _Check(all(torch.equal(a[:, c - cc:], e) for a, e in zip(full, part)),
             f"prefill tile read: the last {cc} rows of a {c}-query chunk "
             "differ bitwise from the same queries read alone")
    ms = _TimeMs(torch, lambda: Read(q, pos), 5) / 2
  print(f"prefill tile read ([{b}, {c}, {n}, {h}] queries x {tile}-slot "
        f"tiles): the last 2 and 130 rows of the chunk bitwise equal to the "
        f"same queries read alone; {ms:.3f} ms per tile")


def _GShardMain(torch, spi, attention, checkpointer, gshard, counters, tmp,
                ref_streams, kv_cache_dtype=None, serve_int8_weights=False,
                sample=None, profile=True, fprop_dtype=None, steps=128):
  """DenseLm1B (decode_page_size 128) through GShardDecode: DecodeOnce
  over the serving phases' 8 prompts (bucket 1024) for 128 tokens with
  prefill chunks of 256, every kernel count set to 0 just before. With
  kv_cache_dtype None the random weights (a seeded torch.Generator) are
  first written as a port checkpoint and read back; with a cache dtype
  the model restores that checkpoint. ref_streams: streams the
  continuations are compared with, for information. serve_int8_weights:
  the decoder's int8 rewrite of the restored weights, every projection of
  the 4 prefill chunks and the 128 steps (145 each) through the int8
  kernels. sample: the decoder's temperature and top_k (one sampling
  launch a step), and a second call must give the same continuations.
  profile: profile 16 decode steps after. fprop_dtype=bfloat16: the
  model decodes bfloat16 activations (bfloat16 caches unless
  kv_cache_dtype says otherwise), through the attention kernels'
  bfloat16-q instantiations; a first call (kv_cache_dtype None) writes
  the checkpoint too. steps: tokens decoded. Returns (launches,
  telemetry, the continuations)."""
  t_call = time.perf_counter()
  cfg = spi.DenseLm1B()
  bf16 = fprop_dtype == torch.bfloat16
  p = cfg.Task().Set(kv_cache_dtype=kv_cache_dtype, fprop_dtype=fprop_dtype)
  p.atten_tpl = attention.MultiHeadedAttention.Params().Set(
      decode_page_size=128)
  lm = p.Instantiate(device="cuda")
  lm.InstantiateVariables(torch.Generator("cuda").manual_seed(0))
  ckdir = os.path.join(tmp, "dense_lm_1b")
  if kv_cache_dtype is None:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpointer.Checkpointer(ckdir).Save(1, lm, force=True)
    write_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(dp, f))
               for dp, _, fs in os.walk(ckdir) for f in fs)
    t0 = time.perf_counter()
    checkpointer.Checkpointer(ckdir).Restore(lm, step=1)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    print(f"DenseLm1B port checkpoint: {size / 1e9:.3f} GB written in "
          f"{write_s:.2f} s, read into the model in {read_s:.2f} s")
  lens, prompts = _Requests(cfg)
  arr = np.zeros((8, int(lens.max())), np.int32)
  for i, pr in enumerate(prompts):
    arr[i, :len(pr)] = pr
  with torch.no_grad():   # warm-up: the decode path's first launches
    states = lm.InitDecodeState(1, 256)
    _, states = lm.Prefill(torch.ones((1, 128), dtype=torch.int32,
                                      device="cuda"), states)
    lm.ExtendStep(torch.ones((1, 1), dtype=torch.int32, device="cuda"),
                  states)
    del states
  decoder = gshard.GShardDecode(
      lm, ckdir, os.path.join(tmp, f"decode_{kv_cache_dtype}.jsonl"),
      max_decode_steps=steps, prefill_chunk_size=256,
      serve_int8_weights=serve_int8_weights, **(sample or {}))
  if bf16:
    counted = "flash_decode_q_bf16" + {
        None: "", "bfloat16": "", "float32": "_f32cache"}[kv_cache_dtype]
  else:
    counted = "flash_decode" + {None: "", "bfloat16": "_bf16"}[kv_cache_dtype]
  torch.cuda.synchronize()
  counters.Zero()
  torch.cuda.reset_peak_memory_stats()
  recs = decoder.DecodeOnce(1, arr, lens)
  launches = counters.Read()
  want = dict.fromkeys(counters, 0)
  want[counted] = 24 * steps
  if serve_int8_weights:   # 4 prefill chunks of 256 and the steps
    int8 = "_bf16" if bf16 else ""
    want["int8_act_quant" + int8] = want["int8_matmul" + int8] = 145 * (
        4 + steps)
  if sample:
    want["sample_tokens"] = steps
  _Check(launches == want, f"GShardDecode launches {launches} != {want}")
  _Check(recs[0]["telemetry"]["serve_int8_weights"] == serve_int8_weights,
         "telemetry serve_int8_weights")
  for r in recs:
    _Check(len(r["output_ids"]) == steps and all(
        0 <= x < cfg.VOCAB_SIZE for x in r["output_ids"]),
           f"bad continuation {r['output_ids']}")
  tel = recs[0]["telemetry"]
  _Check(tel["kv_cache_dtype"] == (kv_cache_dtype or (
      "bfloat16" if bf16 else "float32")),
         f"telemetry kv_cache_dtype {tel['kv_cache_dtype']}")
  n = len(ref_streams[0])
  same = sum(list(r["output_ids"][:n]) == list(st)
             for r, st in zip(recs, ref_streams))
  print(f"DenseLm1B GShardDecode ({tel['kv_cache_dtype']} cache"
        f"{', bf16 activations' if bf16 else ''}, kv_bytes_per_token "
        f"{tel['kv_bytes_per_token']}): 8 prompts (bucket 1024) x {steps} "
        f"tokens, prefill chunks of 256: prefill_s "
        f"{tel['prefill_s']:.3f}, decode_s {tel['decode_s']:.3f} "
        f"({tel['decode_s'] / steps * 1e3:.2f} ms per step), "
        f"{tel['tokens_per_sec']:.1f} tokens/s, decode state "
        f"{tel['decode_state_bytes_per_seq'] / 2**20:.1f} MiB per sequence, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches { {k: v for k, v in launches.items() if v} } (24 x {steps}"
        f"{'; 145 x (4 + 128) of each int8 kernel' if serve_int8_weights else ''}"
        f"){', int8 weights' if serve_int8_weights else ''}")
  print(f"(information, not a check: {same} of 8 continuations begin with "
        f"the {n}-token reference streams)")
  if sample:
    again = decoder.DecodeOnce(1, arr, lens)
    _Check([r["output_ids"] for r in again] == [r["output_ids"] for r in recs],
           "two sampled DecodeOnce calls gave other continuations")
    print(f"sampled GShardDecode {sample}: a second DecodeOnce gave the same "
          f"8 continuations (decode_s {again[0]['telemetry']['decode_s']:.3f})")
  if profile:
    _ProfileDecodeSteps(torch, decoder, arr, lens)
  print(f"DenseLm1B GShardDecode: {time.perf_counter() - t_call:.1f} s in "
        "all")
  return launches, tel, [r["output_ids"] for r in recs]


# The int8 serving step's 145 products per DenseLm1B step: (K, N, calls a
# step) of q/k/v/post, the FFN's two and the tied logits
INT8_STEP_SHAPES = ((2048, 2048, 4 * 24), (2048, 8192, 24), (8192, 2048, 24),
                    (2048, 32000, 1))


def _Int8ThetaBytes(theta):
  """Device bytes of a served theta's Int8Weights: int8 values + scales."""
  from lingvo_tpu_torch.core import base_layer
  from lingvo_tpu_torch.core import quant_utils
  total = 0
  for leaf in theta.Flatten():
    members = (leaf.layers if isinstance(leaf, base_layer.StackedLeaf)
               else [leaf])
    for w in members:
      if isinstance(w, quant_utils.Int8Weight):
        total += w.w_nk.numel() + w.scale.numel() * w.scale.element_size()
  return total


def _Int8PlanText(torch, im, m, k, n, itemsize=4):
  """The launch kernels (a) and (b) take at a shape (`QuantizePlan`,
  `GemmPlan`), and whether the built GEMM's blocks per SM are the ones
  the plan assumed; '' for a tree whose module has no plans."""
  if not hasattr(im, "GemmPlan"):
    return ""
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  plan = im.GemmPlan(m, k, n, sms)
  q = im.QuantizePlan(m, k, itemsize, im.QuantizeMaxBlocks(0))
  per_sm = im.GemmOccupancy(plan["swap"], plan["nb"])
  _Check(per_sm == plan["per_sm"], f"int8 GEMM at {m, k, n}: the built "
         f"kernel holds {per_sm} blocks an SM, the plan assumed "
         f"{plan['per_sm']}")
  side = (f"swapped (weight rows as A, x8 as n = {plan['nb']})"
          if plan["swap"] else "normal (x8 rows as A, n = 128)")
  return (f"(a) a cluster of {q['blocks']} x {q['rows']} rows, "
          f"{q['held']} held; (b) {side}, {plan['m_tiles']} x "
          f"{plan['n_tiles']} tiles, cluster {plan['cluster']} (K split in "
          f"runs of {plan['kb_per_split']} x 128 bytes), {plan['stages']} "
          f"stages, {plan['blocks']} blocks, {per_sm} an SM")


def _IntMmPadMs(torch, x8, w, k):
  """torch._int_mm on x8[:, :k] padded with zero rows to 24, the fewest
  rows it takes (it refuses m <= 16): a yardstick for small m."""
  a8 = torch.zeros((24, k), dtype=torch.int8, device=x8.device)
  a8[:x8.shape[0]] = x8[:, :k]
  return _TimeMs(torch, lambda: torch._int_mm(a8, w.t()), 20)


def _CheckInt8Gemm(torch, im, rng, m):
  """Kernels (a) and (b) of ops/int8_matmul.py at the int8 serving step's
  shapes with m rows (264: the ragged step's packed tokens; 8: a decode
  step's rows): x float32 from a seeded numpy generator, random int8
  weights and scales. Each kernel bitwise equal to its plain version, two
  calls bitwise equal, one launch of each a call. Times (a), (b), both
  from one `Int8Matmul` call ((b) a programmatic dependent of (a)), the
  plain versions, torch._int_mm (the int32 product alone: where it takes
  the shape, m >= 17, K and N multiples of 8; at m < 17 on x8 padded with
  zero rows to 24, labelled so) and the float32 matmul on the dequantized
  weight (what the float path pays), beside each bound; prints each
  shape's launch plan; returns the per-shape results and their sums over
  the 145 calls of a step."""
  rows, step = [], dict(a_ms=0.0, b_ms=0.0, ab_ms=0.0, a_plain_ms=0.0,
                        b_plain_ms=0.0, a_bound=0.0, b_bound=0.0,
                        int_mm_ms=0.0, int_mm_pad_ms=0.0, f32_ms=0.0,
                        err=0.0, a_by=set(), b_by=set())
  for k, n, calls in INT8_STEP_SHAPES:
    x = torch.as_tensor(rng.randn(m, k).astype(np.float32) * 2.0).cuda()
    w = torch.as_tensor(rng.randint(-128, 128, size=(n, k)).astype(
        np.int8)).cuda()
    ws = torch.as_tensor((rng.rand(n) * 1e-3 + 1e-5).astype(
        np.float32)).cuda()
    q0, g0 = im.QuantizeActivations.launches, im.Int8Gemm.launches
    x8, xs = im.QuantizeActivations(x)
    y = im.Int8Gemm(x8, xs, w, ws)
    torch.cuda.synchronize()
    _Check((im.QuantizeActivations.launches - q0,
            im.Int8Gemm.launches - g0) == (1, 1),
           "int8 matmul: not one launch of each kernel a call")
    px8, pxs = im._PlainQuantize(x)
    want = im._PlainGemm(x8, xs, w, ws)
    _Check(torch.equal(x8, px8) and torch.equal(xs, pxs),
           f"int8 quantize kernel != plain at [{m}, {k}]")
    err = float((y - want).abs().max())
    _Check(torch.equal(y, want),
           f"int8 GEMM kernel != plain at [{m}, {k}] x [{n}, {k}]: {err}")
    y2 = im.Int8Matmul(x, w, ws)
    _Check(torch.equal(y, y2), f"two int8 matmul calls differ at {m, k, n}")
    kp = x8.shape[1]
    a_ms = _TimeMs(torch, lambda: im.QuantizeActivations(x), 20)
    b_ms = _TimeMs(torch, lambda: im.Int8Gemm(x8, xs, w, ws), 20)
    ab_ms = _TimeMs(torch, lambda: im.Int8Matmul(x, w, ws), 20)
    a_plain_ms = _TimeMs(torch, lambda: im._PlainQuantize(x), 5)
    b_plain_ms = _TimeMs(torch, lambda: im._PlainGemm(x8, xs, w, ws), 5)
    a_bound = _Bound(m * k * 4 + m * kp + 4, 0)
    b_bound = _Bound(n * k + m * kp + n * 4 + 4 + m * n * 4, 2 * m * k * n,
                     INT8_OPS_PER_S)
    int_mm_ms = int_mm_pad_ms = None
    if k % 8 == 0 and n % 8 == 0:
      try:   # a yardstick only: the port never calls it
        if m >= 17:
          a8 = x8[:, :k]
          int_mm_ms = _TimeMs(torch, lambda: torch._int_mm(a8, w.t()), 20)
        else:
          int_mm_pad_ms = _IntMmPadMs(torch, x8, w, k)
      except RuntimeError as e:
        print(f"torch._int_mm refused [{m}, {k}] x [{k}, {n}]: {e}")
    w_f32 = (w.float() * ws[:, None]).contiguous()
    f32_ms = _TimeMs(torch, lambda: torch.matmul(x, w_f32.t()), 20)
    if (k, n) == INT8_STEP_SHAPES[0][:2]:
      # what a host-bound step pays per projection on the host
      int8_us = _EnqueueUs(torch, lambda: im.Int8Matmul(x, w, ws))
      f32_us = _EnqueueUs(torch, lambda: torch.matmul(x, w_f32.t()))
      print(f"host enqueue per call at [{m}, {k}] x [{n}, {k}]: Int8Matmul "
            f"(both kernels) {int8_us:.1f} us, float32 matmul {f32_us:.1f} "
            "us")
      step["enqueue_us"] = int8_us
    del w_f32
    int_mm = ("n/a" if int_mm_ms is None else f"{int_mm_ms:.4f} ms") + (
        "" if int_mm_pad_ms is None
        else f" (on x8 padded to 24 rows: {int_mm_pad_ms:.4f} ms)")
    print(f"int8 [{m}, {k}] x [{n}, {k}] ({calls} a step): kernel (a) "
          f"{a_ms:.4f} ms (bound {a_bound[0]:.4f}, {a_bound[1]}), kernel (b) "
          f"{b_ms:.4f} ms (bound {b_bound[0]:.4f}, {b_bound[1]}; "
          f"{_BoundShare(b_ms, b_bound[0])}), both from one Int8Matmul "
          f"{ab_ms:.4f} ms, plain (a) {a_plain_ms:.4f} ms, "
          f"plain (b) {b_plain_ms:.4f} ms, "
          f"_int_mm {int_mm}, float32 matmul {f32_ms:.4f} ms; bitwise "
          "equal, one launch of each")
    plan = _Int8PlanText(torch, im, m, k, n)
    if plan:
      print(f"  plan at [{m}, {k}] x [{n}, {k}]: {plan}")
    rows.append(dict(m=m, k=k, n=n, calls=calls, a_ms=a_ms, b_ms=b_ms,
                     ab_ms=ab_ms, a_plain_ms=a_plain_ms,
                     b_plain_ms=b_plain_ms, a_bound=a_bound, b_bound=b_bound,
                     int_mm_ms=int_mm_ms, int_mm_pad_ms=int_mm_pad_ms,
                     f32_ms=f32_ms))
    for key, val in (("a_ms", a_ms), ("b_ms", b_ms), ("ab_ms", ab_ms),
                     ("a_plain_ms", a_plain_ms), ("b_plain_ms", b_plain_ms),
                     ("a_bound", a_bound[0]), ("b_bound", b_bound[0]),
                     ("f32_ms", f32_ms)):
      step[key] += calls * val
    step["a_by"].add(a_bound[1])
    step["b_by"].add(b_bound[1])
    for key, val in (("int_mm_ms", int_mm_ms),
                     ("int_mm_pad_ms", int_mm_pad_ms)):
      step[key] = (None if val is None or step[key] is None
                   else step[key] + calls * val)
    step["err"] = max(step["err"], err)
    del x, w, ws, x8, y, y2, want
  step["rows"] = rows
  for key in ("a_by", "b_by"):   # what bounds the step's sum
    step[key] = "/".join(sorted(step[key]))
  int_mm = ("n/a" if step["int_mm_ms"] is None
            else f"{step['int_mm_ms']:.3f} ms") + (
                "" if step["int_mm_pad_ms"] is None
                else f" (on x8 padded to 24 rows: "
                f"{step['int_mm_pad_ms']:.3f} ms)")
  print(f"int8 step sums at m={m} over the 145 calls: kernel (a) "
        f"{step['a_ms']:.3f} ms (bound {step['a_bound']:.3f}), kernel (b) "
        f"{step['b_ms']:.3f} ms (bound {step['b_bound']:.3f}), both from "
        f"one Int8Matmul {step['ab_ms']:.3f} ms, plain (a) "
        f"{step['a_plain_ms']:.3f} ms, plain (b) {step['b_plain_ms']:.3f} "
        f"ms, _int_mm {int_mm}, float32 matmul "
        f"{step['f32_ms']:.3f} ms")
  return step


def _Ulps(torch, got, want):
  """|got - want| in units of want's float32 ulp (elementwise)."""
  mag = torch.abs(want)
  ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
  return torch.abs(got - want) / ulp


_INT_OPS = ("IMAD", "IADD3", "VIADD", "LOP3", "SHF", "LEA", "ISETP", "IADD",
            "IMUL", "SEL", "PRMT", "IMNMX", "IABS", "SHL", "SHR")
_FLOAT_OPS = ("FFMA", "FMUL", "FADD", "FSETP", "FSEL", "FMNMX", "MUFU",
              "FCHK")


def _SassLoopMix(cuda_build, name, kernel):
  """The instruction mix of `kernel`'s element loop in the built library
  `name` (cuobjdump -sass): the largest backward branch's body that holds
  one global load, i.e. the body a thread runs per element. Returns
  {"int": n, "float": n, "other": n, "total": n, "ops": {opcode: n}}, or
  None where cuobjdump is missing or no such loop is found."""
  import re
  tool = "/usr/local/cuda/bin/cuobjdump"
  if not os.path.exists(tool):
    return None
  sass = subprocess.run([tool, "-sass", str(cuda_build.LibraryPath(name))],
                        capture_output=True, text=True, timeout=120).stdout
  start = sass.find(kernel)
  if start < 0:
    return None
  body = sass[start:].split("Function :")[0]
  code = [(int(m.group(1), 16), m.group(2).split(".")[0], m.group(3))
          for m in re.finditer(
              r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
              r"([^;]*);", body)]
  best = None
  for addr, op, args in code:
    if op != "BRA":
      continue
    target = re.search(r"0x([0-9a-f]+)", args)
    if not target or int(target.group(1), 16) >= addr:
      continue
    loop = [c for c in code if int(target.group(1), 16) <= c[0] <= addr]
    if (sum(c[1] == "LDG" for c in loop) == 1
        and (best is None or len(loop) > len(best))):
      best = loop
  if best is None:
    return None
  ops = {}
  for _, op, _ in best:
    ops[op] = ops.get(op, 0) + 1
  n_int = sum(v for k, v in ops.items() if k in _INT_OPS)
  n_float = sum(v for k, v in ops.items() if k in _FLOAT_OPS)
  return dict(int=n_int, float=n_float, other=len(best) - n_int - n_float,
              total=len(best), ops=ops)


def _SampleBound(st, r, v, moved, mix):
  """The sampling kernel's bound at [r, v]: (ms, "bytes" or "operations",
  {limit: ms}), the largest of three limits: the bytes at the memory rate;
  the operations only the ALU pipe runs (the algorithm's rotates, xors and
  shifts, `ALU_OPS_PER_ELEMENT`) at 64 lanes an SM a clock; and every
  instruction at the issue rate, 128 lanes an SM a clock, counting the
  algorithm's integer operations and the compiled element loop's float
  instructions (the accurate logf's among them; none where the SASS
  could not be read)."""
  n = r * v
  parts = dict(
      bytes=moved / HBM_BYTES_PER_S * 1e3,
      alu=n * st.ALU_OPS_PER_ELEMENT / INT32_OPS_PER_S * 1e3,
      issue=n * (st.INT_OPS_PER_ELEMENT + (mix["float"] if mix else 0))
      / INSTRUCTIONS_PER_S * 1e3)
  by = max(parts, key=parts.get)
  return parts[by], "bytes" if by == "bytes" else "operations", parts


def _CheckSample(torch, st, threefry, r, f, top_k, seed, mix=None,
                 time_it=False, temperature=0.7):
  """The sampling kernel against its plain version on [r, 32000] logits
  (the serving step's vocabulary): f = 2 folds each row with an engine
  (seed, position) pair, f = 1 with its row index against a GShardDecode
  step key (`Split(PRNGKey(1), 128)[5]`). Tokens equal, the winning value
  within 1 ulp, two calls bitwise equal, one launch a call; with
  `time_it`, the kernel, the plain version and the threshold timed beside
  the bound (`_SampleBound`, with the element loop's SASS mix `mix`)."""
  from lingvo_tpu_torch.core import jit_arith, sampling
  v = 32000
  gen = torch.Generator("cuda").manual_seed(seed)
  x = torch.randn(r, v, generator=gen, device="cuda") * 4
  if f == 2:   # tokens of 8 requests: each request's seed, positions
    rows = np.random.RandomState(seed).randint(0, 8, size=r)
    seeds = np.random.RandomState(seed + 1).randint(0, 2**31 - 1, size=8)
    fold = np.stack([seeds[rows], np.arange(r) % 33], 1)
    key = threefry.PRNGKey(3)
  else:
    fold = np.arange(r)[:, None]
    key = threefry.Split(threefry.PRNGKey(1), 128)[5]
  fold = torch.as_tensor(fold.astype(np.int32)).cuda()
  inv_t = jit_arith.Reciprocal(temperature)
  thr = sampling.TopKThreshold(x, temperature, top_k)
  before = st.SampleTokens.launches
  tokens, z = st.SampleTokens(x, key, fold, inv_t, thr, return_z=True)
  tokens2, z2 = st.SampleTokens(x, key, fold, inv_t, thr, return_z=True)
  torch.cuda.synchronize()
  _Check(st.SampleTokens.launches == before + 2,
         "sample_tokens: one launch a call")
  want, want_z = st._PlainSample(x, key, fold, inv_t, thr)
  label = f"sample_tokens [{r}, {v}] F={f} top_k={top_k}"
  _Check(torch.equal(tokens, tokens2) and torch.equal(z, z2),
         f"{label}: two calls differ")
  differ = int((tokens != want).sum())
  _Check(differ == 0, f"{label}: {differ} tokens differ from the plain "
         "version")
  ulps = float(_Ulps(torch, z, want_z).max())
  err = float((z - want_z).abs().max())
  _Check(ulps <= 1.0, f"{label}: winning value {ulps} ulp off")
  live = r * v if thr is None else int((x * inv_t >= thr[:, None]).sum())
  res = dict(err=err, ulps=ulps)
  msg = (f"{label}: tokens equal, winning value within {ulps:g} ulp "
         f"({err:.3g} abs), {live} live logits")
  if time_it:
    moved = 4 * r * v + 4 * r * f + (4 * r if thr is not None else 0) + 8 * r
    *res["bound"], parts = _SampleBound(st, r, v, moved, mix)
    res["ms"] = _TimeMs(torch, lambda: st.SampleTokens(x, key, fold, inv_t,
                                                       thr), 20)
    res["plain_ms"] = _TimeMs(
        torch, lambda: st._PlainSample(x, key, fold, inv_t, thr), 3,
        waits_as="plain sampling (the key's copy to the card)")
    res["threshold_ms"] = (None if thr is None else _TimeMs(
        torch, lambda: sampling.TopKThreshold(x, temperature, top_k), 20))
    msg += (f"; kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.3f} ms, "
            f"top-k threshold (torch.topk) {res['threshold_ms']} ms, bound "
            f"{res['bound'][0]:.4f} ms ({res['bound'][1]}; the limits: "
            f"{moved / 1e6:.1f} MB at 3.35 TB/s {parts['bytes']:.4f} ms, "
            f"{st.ALU_OPS_PER_ELEMENT} ALU-pipe operations an element at "
            f"{INT32_OPS_PER_S / 1e12:.2f} T/s {parts['alu']:.4f} ms, "
            f"{st.INT_OPS_PER_ELEMENT} integer + "
            f"{mix['float'] if mix else 0} float instructions an element "
            f"issued at {INSTRUCTIONS_PER_S / 1e12:.2f} T/s "
            f"{parts['issue']:.4f} ms)")
  print(msg)
  return res


def _CheckActScale(torch, im):
  """Kernel (a) on a row whose amax makes the float32 product by the
  reciprocal of 127 differ from the true division: its scale must be the
  product (the reference's jitted step), bitwise as the plain version."""
  from lingvo_tpu_torch.core import jit_arith
  rng = np.random.RandomState(23)
  cand = (rng.rand(4096) * 8).astype(np.float32)
  prod = cand * np.float32(jit_arith.INV_127)
  quot = cand / np.float32(127)
  amax = float(cand[np.nonzero(prod != quot)[0][0]])
  x = torch.as_tensor(rng.randn(8, 2048).astype(np.float32))
  x = x / x.abs().max() * amax * 0.5
  x[3, 77] = -amax
  x8, scale = im.QuantizeActivations(x.cuda())
  px8, pscale = im._PlainQuantize(x.cuda())
  torch.cuda.synchronize()
  got = scale.cpu().numpy()[0]
  _Check(got == np.float32(amax) * np.float32(jit_arith.INV_127)
         and got != np.float32(amax) / np.float32(127),
         f"kernel (a) scale {got!r} is not amax * float32(1 / 127)")
  _Check(torch.equal(scale, pscale) and torch.equal(x8, px8),
         "kernel (a) differs from its plain version")
  print(f"kernel (a) at amax {amax!r}: scale {got!r} = amax * float32(1 / "
        f"127), not the true division {np.float32(amax) / np.float32(127)!r}"
        "; bitwise its plain version")


def _CancelCheck(torch, cfg, engine, lm, sample, seeds):
  """Serves phase 5's 8 requests sampled and cancels 2 of them (requests
  2 and 5) once each has given its first token: both finish
  "cancelled", the others finish, and after Stop the allocator holds
  every page again."""
  eng = engine.ServingLoop(lm, page_size=16, num_pages=512,
                           max_batch=cfg.BATCH_SIZE,
                           max_seq_len=cfg.SEQUENCE_LENGTH,
                           prefill_chunk=256, **sample)
  _, prompts = _Requests(cfg)
  eng.Start()
  try:
    handles = [eng.Submit(pr, 32, eos_id=None, seed=seeds[i])
               for i, pr in enumerate(prompts)]
    next(handles[2].Tokens(timeout=300))
    next(handles[5].Tokens(timeout=300))
    _Check(handles[2].Cancel() and handles[5].Cancel(),
           "cancel of a mid-flight request refused")
    streams = [h.Result(timeout=300) for h in handles]
  finally:
    eng.Stop()
  torch.cuda.synchronize()
  reasons = [h.finish_reason for h in handles]
  stats = eng.Stats()
  _Check(reasons.count("cancelled") == 2 and reasons[2] == reasons[5]
         == "cancelled", f"finish reasons {reasons}")
  _Check(stats["kv_pages"]["in_use"] == 0
         and eng.alloc.num_free == eng.alloc.num_pages,
         f"pages still held after Stop: {stats['kv_pages']}")
  _Check(stats["scheduler"]["cancelled"] == 2
         and stats["scheduler"]["slots_live"] == 0,
         f"scheduler after the cancels: {stats['scheduler']}")
  print(f"cancel of 2 of 8 sampled requests: they stopped at "
        f"{len(streams[2])} and {len(streams[5])} tokens, the other 6 gave "
        f"32; after Stop {eng.alloc.num_free} of {eng.alloc.num_pages} "
        "pages free, no slot live")
  return streams


# -- phase 24: serving and batch decode at fprop_dtype=bfloat16 --------------


def _OneBf16Ulp(torch, got, want):
  """(within one bfloat16 ulp of want everywhere, elements that differ):
  2^-7 of each magnitude plus 1e-6 of the largest. Kernel and plain
  version sum in float32 in other orders, then round once to bfloat16: a
  sum that lands on the other side of a rounding boundary moves one
  ulp."""
  g, w = got.float(), want.float()
  bar = 2.0 ** -7 * w.abs() + 1e-6 * float(w.abs().max())
  return bool(((g - w).abs() <= bar).all()), int((g != w).sum())


def _CheckBf16Q(torch, label, call, wide, plain, zero_rows, bound,
                library=None):
  """One bfloat16-q instantiation on dyadic q and K: a finite bfloat16
  output, padding / inactive rows exactly 0, two calls bitwise equal,
  bitwise equal to the float32-q kernel on the widened q rounded to
  bfloat16 (`wide`: the widening is exact and the rest is the float32
  code), within one bfloat16 ulp of the plain version (`plain`; the
  elements that differ are printed). Times the kernel, the plain version
  and `library` (a PyTorch call computing the same function) beside the
  bound."""
  out, again, ctl, want = call(), call(), wide(), plain()
  torch.cuda.synchronize()
  _Check(out.dtype == want.dtype == torch.bfloat16,
         f"{label}: output {out.dtype}, plain {want.dtype}")
  _Check(bool(torch.isfinite(out).all()), f"{label}: non-finite")
  _Check(torch.equal(out, again), f"{label}: two calls differ bitwise")
  if zero_rows is not None:
    _Check(bool((out[zero_rows] == 0).all()), f"{label}: padding or "
           "inactive rows not exactly zero")
  _Check(torch.equal(out, ctl.bfloat16()), f"{label}: differs from the "
         "float32-q kernel on the widened q rounded to bfloat16")
  ok, differ = _OneBf16Ulp(torch, out, want)
  err = float((out.float() - want.float()).abs().max())
  _Check(ok, f"{label}: more than one bfloat16 ulp from the plain version "
         f"(max abs err {err})")
  ms = _TimeMs(torch, call, 20)
  plain_ms = _TimeMs(torch, plain, 3, waits_as=f"plain {label}")
  lib_ms = None if library is None else _TimeMs(torch, library, 20,
                                                 waits_as="library")
  print(f"{label}: bitwise the float32-q kernel on the widened q, rounded; "
        f"vs plain: {differ} of {out.numel()} elements differ, each within "
        f"one bfloat16 ulp (max abs err {err:.3g}); two calls bitwise "
        f"equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        + ("" if lib_ms is None else f", SDPA {lib_ms:.4f} ms")
        + f", bound {bound[0]:.4f} ms ({bound[1]})")
  return dict(ms=ms, plain_ms=plain_ms, bound=bound, err=err,
              differ=differ, elements=out.numel(), library_ms=lib_ms)


def _CheckBf16QKernels(torch, rba, bd, fd, ragged, prompt_lens):
  """The bfloat16-q instantiations of rows 1-3 at the main path's shapes:
  the ragged kernel over float32, bfloat16 and int8 pools (phase 3's main
  pack, page 16, H 128; dead slots poisoned as phase 14's), block decode
  over the three (phase 10's pool, page 16), flash decode over bfloat16
  and float32 caches (phase 11's [8, 1152, 16, 128], page 128, t 1151
  and 700). q and K dyadic: the widened q is the float32 q. Bounds: the
  float32-q check's bytes with q read and out written at 2 bytes each."""
  res = {}
  x, pad, moved, flops, extra = _AttendPack(
      torch, ragged, 16, 128, np.random.RandomState(24), dyadic=True)
  ints = (x["tables"], x["row_of"], x["q_end"])
  tree = dict(q_start=x["q_start"], anc_lo=x["anc_lo"], anc_hi=x["anc_hi"])
  qb = x["q"].bfloat16()
  q_saved = x["q"].numel() * 4   # q and out at 2 bytes instead of 4
  for dtype, elem in (("bfloat16", 2 * 128), ("float32", 4 * 128),
                      ("int8", 128 + 4)):
    if dtype == "float32":
      k, v, sc = x["k_pool"], x["v_pool"], {}
    else:
      k, v, sc, _ = _KvStorage(torch, extra["clean"], extra["dead"], dtype)
    call = lambda q, k=k, v=v, sc=sc: rba.RaggedAttend(
        q, k, v, *ints, page_size=16, **sc, **tree)
    res["ragged", dtype] = _CheckBf16Q(
        torch, f"ragged bf16 q, {dtype} pools, P=16 H=128 pack main",
        lambda: call(qb), lambda: call(qb.float()),
        lambda k=k, v=v, sc=sc: rba._PlainRaggedAttend(
            qb, k, v, *ints, 16, **tree, **sc),
        torch.as_tensor(pad).cuda(),
        _Bound(moved(elem) - q_saved, flops))
    del k, v, sc
  x, moved, flops, extra = _DecodePool(torch, 16, np.random.RandomState(25),
                                       dyadic=True)
  rest = (x["tables"], x["lens"])
  qb = x["q"].bfloat16()
  q_saved = x["q"].numel() * 4
  for dtype, elem in (("bfloat16", 2 * 128), ("float32", 4 * 128),
                      ("int8", 128 + 4)):
    if dtype == "float32":
      k, v, sc = x["k_pool"], x["v_pool"], {}
    else:
      k, v, sc, _ = _KvStorage(torch, extra["clean"], extra["dead"], dtype)
    call = lambda q, k=k, v=v, sc=sc: bd.BlockDecode(q, k, v, *rest,
                                                     page_size=16, **sc)
    res["block", dtype] = _CheckBf16Q(
        torch, f"block decode bf16 q, {dtype} pools, P=16",
        lambda: call(qb), lambda: call(qb.float()),
        lambda k=k, v=v, sc=sc: bd._PlainBlockDecode(
            qb[:, 0], k, v, *rest, 16, **sc)[:, None], 0,
        _Bound(moved(elem) - q_saved, flops))
    del k, v, sc
  b, s, n, h, page, p_len = 8, 1152, 16, 128, 128, 1024
  rng = np.random.RandomState(26)
  slot = np.arange(s)
  pad = (slot[None] < (p_len - np.asarray(prompt_lens))[:, None]).astype(
      np.float32)
  q = _Dyadic(rng.randn(b, 1, n, h) / np.sqrt(h), 1 / 64)
  k = _Dyadic(rng.randn(b, s, n, h), 1 / 8)
  v = rng.randn(b, s, n, h).astype(np.float32)
  k[pad > 0.5] = np.nan
  v[pad > 0.5] = np.nan
  qb = torch.as_tensor(q).cuda().bfloat16()
  padc = torch.as_tensor(pad).cuda()
  sdpa = torch.nn.functional.scaled_dot_product_attention
  for dtype in ("bfloat16", "float32"):
    cache_dtype = getattr(torch, dtype)
    for t in (1151, 700):
      kt, vt = k.copy(), v.copy()
      kt[:, t + 1:] = np.nan
      vt[:, t + 1:] = np.nan
      kc = torch.as_tensor(kt).cuda().to(cache_dtype)
      vc = torch.as_tensor(vt).cuda().to(cache_dtype)
      call = lambda q, kc=kc, vc=vc, t=t: fd.FlashDecode(
          q, kc, vc, t, page_size=page, cache_paddings=padc)
      keep = (slot[None] <= t) & (pad < 0.5)
      live = int(keep.sum())
      moved = (2 * live * n * h * cache_dtype.itemsize
               + b * (t // page + 1) * page * 4 + 2 * qb.numel() * 2)
      mask = torch.as_tensor(keep).cuda()[:, None, None, :]
      qs, ks, vs = (a.transpose(1, 2) for a in (qb.to(cache_dtype), kc, vc))
      res["flash", dtype, t] = _CheckBf16Q(
          torch, f"flash decode bf16 q, {dtype} cache, t={t}",
          lambda: call(qb), lambda: call(qb.float()),
          lambda kc=kc, vc=vc, t=t: fd._PlainDecode(
              qb[:, 0], kc, vc, t, page, padc)[:, None], None,
          _Bound(moved, 4 * live * n * h),
          library=lambda qs=qs, ks=ks, vs=vs, mask=mask: sdpa(
              qs, ks, vs, attn_mask=mask, scale=1.0))
      del kc, vc, qs, ks, vs
  return res


def _CheckInt8Bf16(torch, im, rng):
  """Kernels (a) and (b) with bfloat16 x and y at the 145 products of a
  DenseLm1B step, m = 264 and 8: kernel (a) bitwise its float32 run on
  the widened x, kernel (b) bitwise its float32 run rounded to bfloat16,
  and both bitwise the plain versions; times each beside its bound (x and
  y at 2 bytes) and torch._int_mm (the int32 product alone, m >= 17);
  returns the sums over the step's 145 calls at each m."""
  sums = {}
  for m in (264, 8):
    step = dict(a_ms=0.0, b_ms=0.0, a_plain_ms=0.0, b_plain_ms=0.0,
                a_bound=0.0, b_bound=0.0, int_mm_ms=0.0 if m >= 17 else None,
                a_by=set(), b_by=set())
    for k, n, calls in INT8_STEP_SHAPES:
      x = torch.as_tensor(rng.randn(m, k).astype(np.float32) * 2.0).cuda()
      x = x.bfloat16()
      w = torch.as_tensor(rng.randint(-128, 128, size=(n, k)).astype(
          np.int8)).cuda()
      ws = torch.as_tensor((rng.rand(n) * 1e-3 + 1e-5).astype(
          np.float32)).cuda().bfloat16().float()   # a bf16 scale, widened
      x8, xs = im.QuantizeActivations(x)
      y = im.Int8Gemm(x8, xs, w, ws, out_dtype=torch.bfloat16)
      f8, fs = im.QuantizeActivations(x.float())
      yf = im.Int8Gemm(f8, fs, w, ws)
      px8, pxs = im._PlainQuantize(x)
      py = im._PlainGemm(px8, pxs, w, ws).bfloat16()
      both = im.Int8Matmul(x, w, ws)
      torch.cuda.synchronize()
      label = f"int8 bf16 [{m}, {k}] x [{n}, {k}]"
      _Check(torch.equal(x8, f8) and torch.equal(xs, fs), f"{label}: kernel "
             "(a) differs from its float32 run on the widened x")
      _Check(torch.equal(x8, px8) and torch.equal(xs, pxs),
             f"{label}: kernel (a) != plain")
      _Check(y.dtype == torch.bfloat16 and torch.equal(y, yf.bfloat16()),
             f"{label}: kernel (b) differs from its float32 run rounded")
      _Check(torch.equal(y, py) and torch.equal(both, y),
             f"{label}: kernel (b) != plain, or Int8Matmul != the two")
      kp = x8.shape[1]
      a_ms = _TimeMs(torch, lambda: im.QuantizeActivations(x), 20)
      b_ms = _TimeMs(torch, lambda: im.Int8Gemm(
          x8, xs, w, ws, out_dtype=torch.bfloat16), 20)
      a_plain = _TimeMs(torch, lambda: im._PlainQuantize(x), 3)
      b_plain = _TimeMs(torch, lambda: im._PlainGemm(
          x8, xs, w, ws).bfloat16(), 3)
      a_bound = _Bound(m * k * 2 + m * kp + 4, 0)
      b_bound = _Bound(n * k + m * kp + n * 4 + 4 + m * n * 2,
                       2 * m * k * n, INT8_OPS_PER_S)
      if step["int_mm_ms"] is not None:
        a8 = x8[:, :k]
        step["int_mm_ms"] += calls * _TimeMs(
            torch, lambda: torch._int_mm(a8, w.t()), 20)
      print(f"{label} ({calls} a step): bitwise the float32 kernels on the "
            f"widened x (rounded) and the plain versions; kernel (a) "
            f"{a_ms:.4f} ms (bound {a_bound[0]:.4f}), kernel (b) {b_ms:.4f} "
            f"ms (bound {b_bound[0]:.4f}, {b_bound[1]})")
      for key, val in (("a_ms", a_ms), ("b_ms", b_ms), ("a_plain_ms", a_plain),
                       ("b_plain_ms", b_plain), ("a_bound", a_bound[0]),
                       ("b_bound", b_bound[0])):
        step[key] += calls * val
      step["a_by"].add(a_bound[1])
      step["b_by"].add(b_bound[1])
      del x, w, ws, x8, y, yf, f8, both
    for key in ("a_by", "b_by"):
      step[key] = "/".join(sorted(step[key]))
    print(f"int8 bf16 step sums at m={m} over the 145 calls: kernel (a) "
          f"{step['a_ms']:.3f} ms (bound {step['a_bound']:.3f}), kernel (b) "
          f"{step['b_ms']:.3f} ms (bound {step['b_bound']:.3f}), plain (a) "
          f"{step['a_plain_ms']:.3f} ms, plain (b) {step['b_plain_ms']:.3f} "
          "ms, _int_mm "
          + ("n/a" if step["int_mm_ms"] is None
             else f"{step['int_mm_ms']:.3f} ms"))
    sums[m] = step
  return sums


# the tiny twin's teacher-forced logits, card against CPU, relative error
# norm: bfloat16 GEMMs sum in another order on the card, and one rounding
# that moves an activation by an ulp moves the logits by about 2^-8 of
# their norm, where the CPU tests hold the port to the reference bit for
# bit (tests/test_torch_bf16_serving_engine.py); the float32 control
# (the card at fprop float32 against the CPU at bfloat16) must miss it
TWIN_REL = 1e-3


def _ServedFor(lm):
  """The theta a serving entry point binds to `lm` (its bfloat16 cast at
  fprop_dtype=bfloat16), or None: what the engine serves."""
  from lingvo_tpu_torch.quant import weights as quant_weights
  return quant_weights.ServingTheta(lm)


def _TinyBf16(torch, spi, engine, ragged):
  """DenseLmTiny at fprop_dtype=bfloat16 on the card against the same
  weights on the CPU: two packed RaggedSteps' logits (teacher-forced: the
  second reads what the first wrote) within TWIN_REL, the card at float32
  activations missing it; then greedy streams of the ragged and legacy
  engines (bfloat16 pools), how many equal the CPU's printed."""
  p16 = spi.DenseLmTiny().Task().Set(fprop_dtype=torch.bfloat16)
  cpu_lm = p16.Instantiate(device="cpu")
  cpu_lm.InstantiateVariables(torch.Generator("cpu").manual_seed(1))
  lms = {"cpu": cpu_lm}
  for name, p in (("cuda", p16), ("cuda f32", spi.DenseLmTiny().Task())):
    lms[name] = p.Instantiate(device="cuda")
    lms[name].load_state_dict(cpu_lm.state_dict())
  tables = np.arange(16, dtype=np.int32).reshape(4, 4)
  rng = np.random.RandomState(3)
  packs = [(ragged.BuildRaggedRows([1, 9, 0, 4], [0, 0, 1, 0], 16, 9),
            rng.randint(0, 128, size=(1, 16)).astype(np.int32)),
           (ragged.BuildRaggedRows([1, 3, 1, 4], [1, 9, 0, 4], 16, 9),
            rng.randint(0, 128, size=(1, 16)).astype(np.int32))]
  logits = {}
  for name, lm in lms.items():
    served = _ServedFor(lm)
    states = lm.InitPagedDecodeState(17, 8, num_slots=4)
    outs = []
    with torch.no_grad(), (served.Active() if served
                           else contextlib.nullcontext()):
      for rows, ids in packs:
        out, states = lm.RaggedStep(torch.as_tensor(ids).to(lm.device),
                                    states,
                                    torch.as_tensor(tables).to(lm.device),
                                    ragged.ToTorch(rows, lm.device))
        outs.append(out[0, torch.as_tensor(rows.valid)].float().cpu())
    logits[name] = torch.cat(outs)
  rel = lambda a: float((a - logits["cpu"]).norm() / logits["cpu"].norm())
  gap, ctl = rel(logits["cuda"]), rel(logits["cuda f32"])
  print(f"DenseLmTiny bf16 twin: two packed steps' logits, card against "
        f"CPU: relative error norm {gap:.4g} (bar {TWIN_REL}); the card at "
        f"float32 activations against the CPU at bfloat16: {ctl:.4g}")
  _Check(gap <= TWIN_REL, f"tiny bf16 logits cuda vs cpu: relative "
         f"{gap} > {TWIN_REL}")
  _Check(ctl > TWIN_REL, f"tiny bf16 control: the card at float32 is "
         f"within {TWIN_REL} of the CPU at bfloat16 ({ctl})")
  lens = np.array([5, 13, 21, 8, 2, 30], np.int32)
  prompts = np.random.RandomState(4).randint(1, 128, size=(6, 30)).astype(
      np.int32)
  kw = dict(page_size=8, num_pages=32, max_batch=4, max_seq_len=64,
            prefill_chunk=8)
  same = {}
  for mode in ("ragged", "legacy"):
    streams = [engine.ServingLoop(lms[name], device=lms[name].device,
                                  step_mode=mode, **kw).RunBatch(
                                      prompts, lens, max_new_tokens=8)
               for name in ("cpu", "cuda")]
    same[mode] = int(sum(np.array_equal(a, b)
                         for a, b in zip(*streams)))
  print(f"DenseLmTiny bf16 twin: greedy streams equal to the CPU's "
        f"(information, not a check): ragged {same['ragged']} of 6, legacy "
        f"{same['legacy']} of 6")
  return gap


def _FirstStepGap(torch, cfg, ragged, lm32, lm16):
  """The relative L2 gap between DenseLm1B's logits at bfloat16 and at
  float32 on the same weights, over the first packed step of the serving
  phases' requests (8 rows of the first 32 prompt tokens): a path that
  rounds the wrong tensor gives a gap of O(1)."""
  lens, prompts = _Requests(cfg)
  rows = ragged.BuildRaggedRows([32] * 8, [0] * 8, 264, 256)
  ids = np.zeros((1, 264), np.int32)
  ids[0, :256] = np.concatenate([p[:32] for p in prompts])
  tables = np.arange(8 * 64, dtype=np.int32).reshape(8, 64)
  logits = {}
  for name, lm in (("f32", lm32), ("bf16", lm16)):
    served = _ServedFor(lm)
    states = lm.InitPagedDecodeState(513, 16, num_slots=8)
    with torch.no_grad(), (served.Active() if served
                           else contextlib.nullcontext()):
      out, _ = lm.RaggedStep(torch.as_tensor(ids).cuda(), states,
                             torch.as_tensor(tables).cuda(),
                             ragged.ToTorch(rows, "cuda"))
    logits[name] = out[0, torch.as_tensor(rows.valid).cuda()].float()
    del states, served
  _Check(bool(torch.isfinite(logits["bf16"]).all()), "bf16 logits not "
         "finite")
  gap = float((logits["bf16"] - logits["f32"]).norm()
              / logits["f32"].norm())
  _Check(gap <= 0.1, f"DenseLm1B first-step bf16 logits: relative L2 gap "
         f"{gap} to float32 > 0.1")
  print(f"DenseLm1B first packed step (8 rows x 32 prompt tokens): bf16 "
        f"logits relative L2 gap to float32 on the same weights {gap:.4g} "
        "(bar 0.1)")
  return gap


def _Bf16Phase(torch, rba, bd, fd, im, ragged, spi, engine, attention,
               checkpointer, gshard, counters, prompt_lens, ref_streams):
  """Phase 24 (see the module docstring). Returns (the bfloat16-q kernel
  checks, the int8 bfloat16 kernels' step sums, the serving runs, the
  two GShardDecode runs' launches)."""
  t_phase = time.perf_counter()
  print("bf16-q ragged / block decode library_ms: null (as phases 3 and "
        "10); flash decode: SDPA on the same bf16 tensors; int8 (b): "
        "torch._int_mm (the int32 product alone)")
  bf16q = _CheckBf16QKernels(torch, rba, bd, fd, ragged, prompt_lens)
  int8_bf16 = _CheckInt8Bf16(torch, im, np.random.RandomState(27))
  gc.collect()
  torch.cuda.empty_cache()
  _TinyBf16(torch, spi, engine, ragged)
  cfg = spi.DenseLm1B()
  lm = _ServingLm(torch, cfg)
  lm16 = _ServingLm(torch, cfg, fprop_dtype=torch.bfloat16)
  _FirstStepGap(torch, cfg, ragged, lm, lm16)
  # the same requests at float32 activations first, unprofiled: the
  # baseline of this process at this point (walls drift over a process)
  f32_ms = _ServeMain(torch, cfg, engine, counters,
                      dict(ragged_block_attend=24), lm=lm, profile=False)[3]
  del lm
  gc.collect()
  torch.cuda.empty_cache()
  print(f"phase 24: kernels, twin and the float32 baseline took "
        f"{time.perf_counter() - t_phase:.1f} s")
  # every step's logits checked finite on the card (a device flag a step),
  # read once at the end
  finite, head = [], lm16._Head

  def _FiniteHead(x):
    logits = head(x)
    finite.append(torch.isfinite(logits).all())
    return logits

  lm16._Head = _FiniteHead
  lens, _ = _Requests(cfg)
  # the instantiations off the default (bfloat16) pools: the shortest
  # request, 8 new tokens
  short = dict(order=[int(np.argmin(lens))], max_new=8, profile=False)
  bf16_serve = {}
  for key, mode, dtype, per_step, per_decode, kw in (
      ("ragged", "ragged", None, dict(ragged_block_attend_q_bf16=24), None,
       {}),
      ("legacy", "legacy", None, {}, dict(block_decode_q_bf16=24),
       dict(windows=LEGACY_WINDOWS)),
      ("sampled, float32 pools", "ragged", "float32",
       dict(ragged_block_attend_q_bf16_f32pool=24, sample_tokens=1), None,
       dict(short, sample=dict(temperature=0.8, top_k=40, sample_seed=3),
            seeds=list(range(100, 108)))),
      ("int8 weights, int8 pools", "ragged", "int8",
       dict(ragged_block_attend_q_bf16_int8pool=24, int8_act_quant_bf16=145,
            int8_matmul_bf16=145), None,
       dict(short, serve_int8_weights=True)),
      ("legacy, float32 pools", "legacy", "float32", {},
       dict(block_decode_q_bf16_f32pool=24), short),
      ("legacy, int8 pools", "legacy", "int8", {},
       dict(block_decode_q_bf16_int8pool=24), short)):
    syncs = {}
    launches, steps, _, ms = _ServeMain(
        torch, cfg, engine, counters, per_step, per_decode, step_mode=mode,
        kv_cache_dtype=dtype, lm=lm16, syncs=syncs, **kw)
    bf16_serve[key] = dict(launches=launches, steps=steps, ms=ms, syncs=syncs)
    gc.collect()
    torch.cuda.empty_cache()
  _Check(bool(torch.stack(finite).all()), "a bf16 serving step gave "
         "non-finite logits")
  print(f"bf16 serving: every request completed, the logits of all "
        f"{len(finite)} steps finite; ragged {bf16_serve['ragged']['ms']:.2f} "
        f"ms/step against {f32_ms:.2f} at float32 activations in this "
        "process")
  del lm16, finite, head
  gc.collect()
  torch.cuda.empty_cache()
  print(f"phase 24: serving took {time.perf_counter() - t_phase:.1f} s")
  with tempfile.TemporaryDirectory() as tmp:
    bf16_gshard, _, _ = _GShardMain(
        torch, spi, attention, checkpointer, gshard, counters, tmp,
        ref_streams, fprop_dtype=torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    # a cache of 1024 + 128 slots: a whole number of 128-slot pages, so
    # every step takes the flash-decode read
    bf16_gshard_f32, _, _ = _GShardMain(
        torch, spi, attention, checkpointer, gshard, counters, tmp,
        ref_streams, kv_cache_dtype="float32", fprop_dtype=torch.bfloat16,
        profile=False)
  gc.collect()
  torch.cuda.empty_cache()
  print(f"phase 24 took {time.perf_counter() - t_phase:.1f} s")
  return bf16q, int8_bf16, bf16_serve, bf16_gshard, bf16_gshard_f32


def main():
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
    return 1
  if not os.path.isdir(os.path.join(REPO, "lingvo_tpu_torch")):
    print("chip_smoke: the lingvo_tpu_torch package is not beside this "
          "script", file=sys.stderr)
    return 1
  sys.path.insert(0, REPO)
  from lingvo_tpu_torch.core import attention
  from lingvo_tpu_torch.core import checkpointer
  from lingvo_tpu_torch.core import ragged
  from lingvo_tpu_torch.core import threefry
  from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
  from lingvo_tpu_torch.ops import block_decode as bd
  from lingvo_tpu_torch.ops import cuda_build
  from lingvo_tpu_torch.ops import flash_attention as fa
  from lingvo_tpu_torch.ops import flash_decode as fd
  from lingvo_tpu_torch.ops import fused_xent as fx
  from lingvo_tpu_torch.ops import int8_matmul as im
  from lingvo_tpu_torch.ops import ragged_block_attend as rba
  from lingvo_tpu_torch.ops import sample_tokens as st
  from lingvo_tpu_torch.ops import ssd_scan as ssd
  from lingvo_tpu_torch.runners import gshard_decode as gshard
  from lingvo_tpu_torch.runners import program
  from lingvo_tpu_torch.serving import engine

  _Phase("1. versions and card")
  print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      check=True, timeout=60).stdout.strip().splitlines()[0]
  print(card)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

  _Phase("2. build kernels (one nvcc per source, in parallel)")
  sources = ("ragged_block_attend", "ssd_scan", "flash_attention",
             "fused_xent", "block_decode", "flash_decode", "int8_matmul",
             "sample_tokens")

  def _Build(name):
    t0 = time.perf_counter()
    cuda_build.Load(name)
    return time.perf_counter() - t0

  with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
    seconds = dict(zip(sources, pool.map(_Build, sources)))
  for name in sources:
    print(f"built {name} in {seconds[name]:.2f} s")
    for line in cuda_build.BuildLog(name).splitlines():
      if "registers" in line or "spill" in line or "smem" in line:
        print(f"  {line.strip()}")

  _Phase("3. ragged attention kernel vs plain version (f32, tol 1e-5)")
  print("ragged library_ms: null (no single PyTorch call computes paged "
        "ragged attention over block tables)")
  rng = np.random.RandomState(0)
  checks = [_CheckKernel(torch, rba, ragged, page, rng) for page in (16, 128)]
  checks.append(_CheckKernel(torch, rba, ragged, 16, rng, h=64))
  for pack in ("decode_only", "edges"):
    checks.append(_CheckKernel(torch, rba, ragged, 16, rng, pack=pack))

  _Phase("4. SSD-scan kernel vs plain version at the hybrid's shapes")
  print("scan library_ms: null (no single PyTorch call computes a gated "
        "chunked linear recurrence)")
  srng = np.random.RandomState(8)
  # serving: 4 decode rows (1 live step of 256), prefill chunks of 256,
  # 200 and 37, an idle row; a reset in row 5; a nonzero incoming state
  x, moved = _ScanInputs(torch, ssd, srng, 256,
                         [1, 256, 1, 200, 1, 37, 1, 0], [(5, 20)], True)
  scan_serve = _CheckScan(torch, ssd, "serving", x, moved)
  del x
  # training: two segments of 512 in every row, zero incoming state
  x, moved = _ScanInputs(torch, ssd, srng, 1024, [1024] * 8,
                         [(r, 512) for r in range(8)], False)
  scan_train = _CheckScan(torch, ssd, "training", x, moved)
  del x
  # decode-only: every row 1 live step of 256 (a decode step's row view),
  # the last row idle
  x, moved = _ScanInputs(torch, ssd, srng, 256, [1] * 7 + [0], [], True)
  scan_decode = _CheckScan(torch, ssd, "decode-only", x, moved)
  del x
  # a long T: 18 chunks, runs of 2 and 3 chunks per cluster block
  x, moved = _ScanInputs(torch, ssd, srng, 1100, [1100] * 8,
                         [(r, 550) for r in range(8)], True)
  scan_long = _CheckScan(torch, ssd, "long T", x, moved)
  del x
  scan_cases = (scan_serve, scan_train, scan_decode, scan_long)
  gc.collect()
  torch.cuda.empty_cache()

  counters = _MakeCounts(rba, ssd, fa, fx, bd, fd, im, st)

  _Phase("5. serving main path: DenseLm1B through ServingLoop")
  _TinyReference(torch, spi.DenseLmTiny(), engine, ragged)
  serve_launches, _, ragged_streams, serve_ms = _ServeMain(
      torch, spi.DenseLm1B(), engine, counters, dict(ragged_block_attend=24))
  gc.collect()
  torch.cuda.empty_cache()

  _Phase("6. hybrid serving main path: DenseLmSsmHybrid through ServingLoop")
  _TinyReference(torch, spi.DenseLmSsmHybridTiny(), engine, ragged)
  hybrid_launches, _, _, _ = _ServeMain(
      torch, spi.DenseLmSsmHybrid(), engine, counters,
      dict(ssd_scan=10, ragged_block_attend=2))
  gc.collect()
  torch.cuda.empty_cache()

  _Phase("7. flash-attention kernels vs plain version at [8, 1024, 16, 128]")
  flash = _CheckFlash(torch, fa, np.random.RandomState(5))
  gc.collect()
  torch.cuda.empty_cache()

  _Phase("8. fused-xent kernel vs plain version at [8192, 2048] x "
         "[32000, 2048]")
  print("fused xent library_ms: null (no single PyTorch call computes "
        "capped logits with an online lse, the label logit and the argmax)")
  xent = _CheckXent(torch, fx, np.random.RandomState(6), 1280, 0.0, True)
  xent_edges = [
      _CheckXent(torch, fx, np.random.RandomState(7), 1536, 0.1, False),
      # a partial row tile
      _CheckXent(torch, fx, np.random.RandomState(17), 1280, 0.1, False,
                 m=8192 + 37),
      # the [D, V] layout, a vocab of 249 whole tiles and 51 columns (not
      # whole float4s: 4-byte copies)
      _CheckXent(torch, fx, np.random.RandomState(27), 1280, 0.1, False,
                 vocab=31923, vd=False)]
  xent["err"] = max([xent["err"]] + [r["err"] for r in xent_edges])
  gc.collect()
  torch.cuda.empty_cache()

  _Phase("9. training main path: DenseLm1B through TrainProgram")
  _TinyTrainReference(torch, spi, program, fa)
  tcfg = spi.DenseLm1B()
  half = tcfg.SEQUENCE_LENGTH // 2
  pairs_per_layer = (tcfg.BATCH_SIZE * tcfg.NUM_HEADS * 2 * half
                     * (half + 1) // 2)
  train_launches, _ = _TrainMain(torch, spi, program, counters,
                                 pairs_per_layer)
  gc.collect()
  torch.cuda.empty_cache()

  _Phase("10. block-decode kernel vs plain version at the legacy step's "
         "shapes")
  print("block decode library_ms: null (no single PyTorch call computes "
        "attention over block tables)")
  brng = np.random.RandomState(10)
  block = {page: _CheckBlockDecode(torch, bd, page, brng)
           for page in (16, 128)}
  block_decode_only = _CheckBlockDecode(
      torch, bd, 16, brng, lens=_DecodeOnlyLens(),
      label="block decode P=16 decode-only pack (phase 12's rows)")
  gc.collect()
  torch.cuda.empty_cache()

  _Phase("11. flash-decode kernel vs plain version at [8, 1152, 16, 128]")
  prompt_lens, _ = _Requests(spi.DenseLm1B())
  fdec = _CheckFlashDecode(torch, fd, np.random.RandomState(11), prompt_lens)
  gc.collect()
  torch.cuda.empty_cache()

  _Phase("12. legacy serving main path: DenseLm1B through "
         "ServingLoop(step_mode='legacy')")
  _TinyReference(torch, spi.DenseLmTiny(), engine, ragged, step_mode="legacy")
  legacy_launches, _, legacy_streams, _ = _ServeMain(
      torch, spi.DenseLm1B(), engine, counters, {},
      per_decode_step=dict(block_decode=24), step_mode="legacy",
      windows=LEGACY_WINDOWS)
  differ = [i for i, (a, b) in enumerate(zip(legacy_streams, ragged_streams))
            if list(a) != list(b)]
  _Check(not differ, f"legacy streams differ from the ragged engine's in "
         f"requests {differ}")
  print("legacy streams: all 8 identical to the ragged engine's (phase 5)")
  gc.collect()
  torch.cuda.empty_cache()

  with tempfile.TemporaryDirectory() as tmp:
    _Phase("13. GShardDecode main path: DenseLm1B, decode_page_size 128")
    _CheckTileBits(torch, attention)
    _GShardTiny(torch, spi, attention, checkpointer, gshard, tmp)
    gshard_launches, _, gshard_out = _GShardMain(
        torch, spi, attention, checkpointer, gshard, counters, tmp,
        [list(st) for st in ragged_streams])
    gc.collect()
    torch.cuda.empty_cache()

    _Phase("14. quantized ragged and block-decode kernels (int8 with scale "
           "sidecars, bfloat16) vs plain versions")
    print("int8 / bfloat16 library_ms: null (no single PyTorch call computes "
          "attention over block tables, nor dequantizes int8 pages in it)")
    qrng = np.random.RandomState(14)
    qragged = [_CheckQuantRagged(torch, rba, ragged, page, h, qrng,
                                 time_plain=(page, h) == (16, 128))
               for page, h in ((16, 128), (128, 128), (16, 64))]
    qragged += [_CheckQuantRagged(torch, rba, ragged, 16, 128, qrng, False,
                                  pack=pack)
                for pack in ("decode_only", "edges")]
    qblock = [_CheckQuantBlockDecode(torch, bd, page, qrng,
                                     time_plain=page == 16)
              for page in (16, 128)]
    gc.collect()
    torch.cuda.empty_cache()

    _Phase("15. bfloat16 flash-decode kernel vs plain version at "
           "[8, 1152, 16, 128]")
    fdec16 = _CheckFlashDecode(torch, fd, np.random.RandomState(11),
                               prompt_lens, dtype="bfloat16")
    for t in (1151, 700):
      print(f"flash decode t={t}: bfloat16 {fdec16[t]['ms']:.4f} ms vs "
            f"float32 {fdec[t]['ms']:.4f} ms (phase 11)")
    gc.collect()
    torch.cuda.empty_cache()

    _Phase("16. quantized serving main path: DenseLm1B through ServingLoop "
           "with int8 and bfloat16 KV pools")
    for mode, dtype in (("ragged", "int8"), ("legacy", "int8"),
                        ("ragged", "bfloat16")):
      _TinyReference(torch, spi.DenseLmTiny(), engine, ragged,
                     step_mode=mode, kv_cache_dtype=dtype)
    lm = _ServingLm(torch, spi.DenseLm1B())
    quant_serve, phase_ms = {}, {}
    # each step mode serves float32 pools first, unprofiled: the baseline
    # of the same process at the same point (walls drift over a process)
    for mode, kernel in (("ragged", "ragged_block_attend"),
                         ("legacy", "block_decode")):
      for dtype, suffix in ((None, ""), ("int8", "_int8"),
                            ("bfloat16", "_bf16")):
        key = kernel + suffix
        per_step = {key: 24} if mode == "ragged" else {}
        per_decode = {key: 24} if mode == "legacy" else None
        launches, _, streams, ms = _ServeMain(
            torch, spi.DenseLm1B(), engine, counters, per_step, per_decode,
            step_mode=mode, kv_cache_dtype=dtype, lm=lm,
            profile=dtype == "int8",
            windows=LEGACY_WINDOWS if mode == "legacy" else ("first",
                                                             "last"))
        quant_serve[key] = launches[key]
        phase_ms[mode, dtype] = ms
        same = sum(list(a) == list(b)
                   for a, b in zip(streams, ragged_streams))
        print(f"(information, not a check: {same} of 8 {dtype or 'float32'} "
              f"{mode} streams equal phase 5's float32 streams; {ms:.2f} "
              f"ms/step vs {phase_ms[mode, None]:.2f} for float32 pools in "
              f"this phase, {serve_ms:.2f} in phase 5)")
        gc.collect()
        torch.cuda.empty_cache()
    del lm
    gc.collect()
    torch.cuda.empty_cache()

    _Phase("17. GShardDecode quantized: bfloat16 and int8 caches")
    for dtype in ("bfloat16", "int8"):
      _GShardTiny(torch, spi, attention, checkpointer, gshard, tmp,
                  kv_cache_dtype=dtype)
    print("DenseLm1B int8 dense cache: ExtendStep reads it through the "
          "dequantize-then-attend einsum path, as the reference does (its "
          "int8 cache runs XLA einsums, no kernel)")
    bf16_launches, _, _ = _GShardMain(
        torch, spi, attention, checkpointer, gshard, counters, tmp,
        gshard_out, kv_cache_dtype="bfloat16")
    gc.collect()
    torch.cuda.empty_cache()

  _Phase("18. bfloat16 flash-attention kernels vs the Pallas twins at "
         "[8, 1024, 16, 128]")
  flash16 = _CheckFlashBf16(torch, fa, np.random.RandomState(5))
  for name in ("fwd", "dkdv", "dq"):
    print(f"flash {name}: bf16 {flash16[name]['ms']:.4f} ms vs float32 "
          f"{flash[name]['ms']:.4f} ms (phase 7)")
  gc.collect()
  torch.cuda.empty_cache()

  _Phase("19. bfloat16 fused-xent kernel vs plain version at [8192, 2048] x "
         "[32000, 2048]")
  print("fused xent bf16 library_ms: null (as phase 8); the plain version "
        "and the backward's products are cuBLAS bf16 GEMMs with float32 "
        "output (fused_xent.MatmulF32)")
  xent16 = _CheckXent(torch, fx, np.random.RandomState(6), 1280, 0.0, True,
                      dtype="bfloat16")
  print(f"fused xent: bf16 {xent16['ms']:.3f} ms vs float32 "
        f"{xent['ms']:.3f} ms (phase 8)")
  gc.collect()
  torch.cuda.empty_cache()

  _Phase("20. bfloat16 training main path: DenseLm1B at fprop_dtype="
         "bfloat16 through TrainProgram")
  _TinyTrainReference(torch, spi, program, fa,
                      fprop_dtype=torch.bfloat16)
  train16_launches, _ = _TrainMain(torch, spi, program, counters,
                                   pairs_per_layer,
                                   fprop_dtype=torch.bfloat16)
  gc.collect()
  torch.cuda.empty_cache()

  _Phase("21. int8 serving kernels vs plain versions at the 145 products "
         "of a DenseLm1B step")
  print("kernel (a) library_ms: null (no single PyTorch call computes a "
        "per-tensor amax scale and quantizes by it); kernel (b) library_ms: "
        "torch._int_mm, the int32 product alone (no scales), where it takes "
        "the shape (m >= 17); at m = 8 on x8 padded to 24 rows, labelled")
  irng = np.random.RandomState(21)
  int8_steps = {m: _CheckInt8Gemm(torch, im, irng, m) for m in (264, 8)}
  gc.collect()
  torch.cuda.empty_cache()

  _Phase("22. int8-weight serving main path: DenseLm1B through ServingLoop "
         "and GShardDecode with serve_int8_weights")
  for mode, dtype in (("ragged", None), ("legacy", None), ("ragged", "int8")):
    _TinyReference(torch, spi.DenseLmTiny(), engine, ragged, step_mode=mode,
                   kv_cache_dtype=dtype, serve_int8_weights=True)
  lm = _ServingLm(torch, spi.DenseLm1B())
  int8_serve = {}
  # float32 weights first in each step mode, unprofiled: the baseline of the
  # same process at the same point (walls drift over a process, phase 16)
  float_ms = {}
  for mode, per_step, per_decode in (
      ("ragged", dict(ragged_block_attend=24), None),
      ("legacy", {}, dict(block_decode=24))):
    float_ms[mode] = _ServeMain(torch, spi.DenseLm1B(), engine, counters,
                                per_step, per_decode, step_mode=mode, lm=lm,
                                profile=False)[3]
    gc.collect()
    torch.cuda.empty_cache()
  # 145 products a step through kernels (a) and (b), whatever the step
  per_int8 = dict(int8_act_quant=145, int8_matmul=145)
  for mode, dtype, per_step, per_decode in (
      ("ragged", None, dict(per_int8, ragged_block_attend=24), None),
      ("legacy", None, per_int8, dict(block_decode=24)),
      ("ragged", "int8", dict(per_int8, ragged_block_attend_int8=24), None)):
    # profiled: the ragged run (the decode-only steps' int8 busy at m = 8
    # is in GShardDecode's profile below)
    launches, steps, streams, ms = _ServeMain(
        torch, spi.DenseLm1B(), engine, counters, per_step, per_decode,
        step_mode=mode, kv_cache_dtype=dtype, lm=lm,
        profile=(mode, dtype) == ("ragged", None), serve_int8_weights=True)
    int8_serve[mode, dtype] = dict(launches=launches, steps=steps, ms=ms)
    same = sum(list(a) == list(b) for a, b in zip(streams, ragged_streams))
    print(f"(information, not a check: {same} of 8 int8-weight {mode} "
          f"streams ({dtype or 'float32'} KV) equal phase 5's float32 "
          f"streams; {ms:.2f} ms/step vs {float_ms[mode]:.2f} for float32 "
          f"weights in this phase, {serve_ms:.2f} in phase 5)")
    gc.collect()
    torch.cuda.empty_cache()
  del lm
  gc.collect()
  torch.cuda.empty_cache()
  with tempfile.TemporaryDirectory() as tmp:
    _GShardTiny(torch, spi, attention, checkpointer, gshard, tmp,
                serve_int8_weights=True)
    int8_gshard, _, _ = _GShardMain(
        torch, spi, attention, checkpointer, gshard, counters, tmp,
        gshard_out, serve_int8_weights=True)
  gc.collect()
  torch.cuda.empty_cache()

  _Phase("23. seeded sampling: the sampling kernel, then DenseLm1B through "
         "ServingLoop and GShardDecode at temperature > 0")
  print("sample_tokens library_ms: null (no PyTorch call draws JAX's "
        "threefry Gumbel noise); its top-k threshold is torch.topk, timed "
        "beside it")
  mix = _SassLoopMix(cuda_build, "sample_tokens", "SampleTokensKernel")
  if mix is not None:
    n = 264 * 32000
    ops = mix["ops"]
    alu = sum(ops.get(k, 0) for k in ("SHF", "LOP3", "ISETP"))
    imad = ops.get("IMAD", 0)
    print(f"sample_tokens element loop (SASS): {mix['total']} instructions, "
          f"{mix['int']} integer, {mix['float']} float, {mix['other']} "
          f"other; by pipe: {alu} shift / logic / compare (ALU pipe only), "
          f"{imad} IMAD (FMA pipe), {mix['int'] - alu - imad} other integer"
          f"; the algorithm counts {st.INT_OPS_PER_ELEMENT} int32 operations"
          f", {st.ALU_OPS_PER_ELEMENT} of them ALU-only; at [264, 32000] the "
          f"compiled loop's ALU-only instructions take "
          f"{n * alu / INT32_OPS_PER_S * 1e3:.4f} ms at 64 lanes an SM a "
          f"clock, its {mix['total']} instructions "
          f"{n * mix['total'] / INSTRUCTIONS_PER_S * 1e3:.4f} ms at 128; by "
          f"opcode {ops}")
  samp = {(r, f, k): _CheckSample(torch, st, threefry, r, f, k,
                                  seed=23 + k + r, mix=mix,
                                  time_it=(r, k) in ((264, 40), (8, 40)))
          for r, f in ((264, 2), (8, 1)) for k in (0, 40)}
  tiny_sample = dict(temperature=0.8, top_k=5, sample_seed=3)
  for mode in ("ragged", "legacy"):
    _TinyReference(torch, spi.DenseLmTiny(), engine, ragged, step_mode=mode,
                   sample=tiny_sample)
  sample = dict(temperature=0.8, top_k=40, sample_seed=3)
  seeds = list(range(100, 108))
  cfg = spi.DenseLm1B()
  lm = _ServingLm(torch, cfg)
  sample_launches, sample_steps, sampled, sample_ms = _ServeMain(
      torch, cfg, engine, counters,
      dict(ragged_block_attend=24, sample_tokens=1), lm=lm, sample=sample,
      seeds=seeds)
  _, _, again, again_ms = _ServeMain(
      torch, cfg, engine, counters,
      dict(ragged_block_attend=24, sample_tokens=1), lm=lm, sample=sample,
      seeds=seeds, profile=False)
  _Check(again == sampled, "two sampled runs with the same seeds gave other "
         "streams")
  print(f"sampled DenseLm1B: a second run gave the same 8 streams "
        f"({again_ms:.2f} ms/step against {sample_ms:.2f}, and "
        f"{serve_ms:.2f} greedy in phase 5); "
        f"{sum(list(a) == list(b) for a, b in zip(sampled, ragged_streams))}"
        " of 8 equal phase 5's greedy streams")
  # the random weights' logits are so peaked (the tied table echoes the
  # input token) that T = 0.8 draws the argmax: at T = 30 (the tanh cap
  # bounds a gap at 60, 2 after the scale) the draws show
  hot = dict(temperature=30.0, top_k=0, sample_seed=3)
  hot_streams = [_ServeMain(
      torch, cfg, engine, counters,
      dict(ragged_block_attend=24, sample_tokens=1), lm=lm, sample=hot,
      seeds=seeds, profile=False)[2] for _ in range(2)]
  _Check(hot_streams[0] == hot_streams[1], "two runs at T = 30 with the "
         "same seeds gave other streams")
  differ = sum(list(a) != list(b)
               for a, b in zip(hot_streams[0], ragged_streams))
  _Check(differ > 0, "at T = 30 every stream equals the greedy one")
  print(f"at T = 30, top_k 0: two runs gave the same 8 streams, {differ} of "
        "8 differ from phase 5's greedy streams")
  order = list(range(7, -1, -1))
  _, _, rev, _ = _ServeMain(
      torch, cfg, engine, counters,
      dict(ragged_block_attend=24, sample_tokens=1), lm=lm, sample=hot,
      seeds=seeds, order=order, profile=False)
  same = sum(list(rev[j]) == list(hot_streams[0][i])
             for j, i in enumerate(order))
  _, _, alone, _ = _ServeMain(
      torch, cfg, engine, counters,
      dict(ragged_block_attend=24, sample_tokens=1), lm=lm, sample=hot,
      seeds=seeds, order=[3], profile=False)
  alone_same = list(alone[0]) == list(hot_streams[0][3])
  print(f"(information, not a check: at T = 30, in reverse order {same} of "
        f"8 streams equal the forward run's; request 3 served alone "
        f"{'equals' if alone_same else 'differs from'} its stream in the "
        "batch)")
  _CancelCheck(torch, cfg, engine, lm, hot, seeds)
  del lm
  gc.collect()
  torch.cuda.empty_cache()
  with tempfile.TemporaryDirectory() as tmp:
    _GShardTiny(torch, spi, attention, checkpointer, gshard, tmp,
                sample=dict(temperature=0.8, top_k=5))
    sample_gshard, _, _ = _GShardMain(
        torch, spi, attention, checkpointer, gshard, counters, tmp,
        gshard_out, sample=dict(temperature=0.8, top_k=40), profile=False)
  gc.collect()
  torch.cuda.empty_cache()
  _CheckActScale(torch, im)
  print("kernel (a) against its plain version at the 145 products: bitwise "
        "(phase 21); the int8 pools' quantize-on-write: phases 14-17")

  _Phase("24. bfloat16 serving and batch decode: the bfloat16-q kernels, "
         "then DenseLm1B at fprop_dtype=bfloat16 through ServingLoop and "
         "GShardDecode")
  bf16q, int8_bf16, bf16_serve, bf16_gshard, bf16_gshard_f32 = _Bf16Phase(
      torch, rba, bd, fd, im, ragged, spi, engine, attention, checkpointer,
      gshard, counters, prompt_lens, gshard_out)

  _Phase("25. result")
  main_check = checks[0]
  kernels = [{
      "name": "ragged_block_attend", "route": "cuda",
      "source": "lingvo_tpu_torch/ops/csrc/ragged_block_attend.cu",
      "replaces": "lingvo_tpu/ops/ragged_block_attend.py:252",
      "launches": serve_launches["ragged_block_attend"],
      "max_abs_err": max(c["max_abs_err"] for c in checks),
      "ms": main_check["kernel_ms"], "plain_ms": main_check["plain_ms"],
      "bound_ms": main_check["bound_ms"], "bound_by": main_check["bound_by"],
      "library_ms": None}, {
      "name": "ssd_scan", "route": "cuda",
      "source": "lingvo_tpu_torch/ops/csrc/ssd_scan.cu",
      "replaces": "lingvo_tpu/ops/ssd_scan.py:221",
      "launches": hybrid_launches["ssd_scan"],
      "max_abs_err": max(r["err"] for r in scan_cases),
      "ms": scan_serve["ms"], "plain_ms": scan_serve["plain_ms"],
      # the bound of the work this call's data needs; the full-work bound
      # (every chunk's whole body) beside it
      "bound_ms": scan_serve["live_bound"][0],
      "bound_by": scan_serve["live_bound"][1],
      "library_ms": None,
      "full_bound_ms": scan_serve["bound"][0],
      "full_bound_by": scan_serve["bound"][1],
      "decode_only_ms": scan_decode["ms"],
      "decode_only_bound_ms": scan_decode["live_bound"][0],
      "decode_only_full_bound_ms": scan_decode["bound"][0],
      "train_ms": scan_train["ms"],
      "train_bound_ms": scan_train["live_bound"][0],
      "train_full_bound_ms": scan_train["bound"][0],
      "registers": scan_serve["geometry"]["regs"],
      "local_bytes": scan_serve["geometry"]["local"]}]
  for name, res, line in (("flash_attention_fwd", flash["fwd"], 230),
                          ("flash_attention_dkdv", flash["dkdv"], 368),
                          ("flash_attention_dq", flash["dq"], 408)):
    kernels.append({
        "name": name, "route": "cuda",
        "source": "lingvo_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": f"lingvo_tpu/ops/flash_attention.py:{line}",
        "launches": train_launches[name], "max_abs_err": res["err"],
        "ms": res["ms"], "plain_ms": res["plain_ms"],
        "bound_ms": res["bound"][0], "bound_by": res["bound"][1],
        "library_ms": res["library_ms"]})
  kernels.append({
      "name": "fused_xent_fwd", "route": "cuda",
      "source": "lingvo_tpu_torch/ops/csrc/fused_xent.cu",
      "replaces": "lingvo_tpu/ops/fused_xent.py:277",
      "launches": train_launches["fused_xent_fwd"],
      "max_abs_err": xent["err"], "ms": xent["ms"],
      "plain_ms": xent["plain_ms"], "bound_ms": xent["bound"][0],
      "bound_by": xent["bound"][1], "library_ms": None})
  main_block = block[16]
  kernels.append({
      "name": "block_decode", "route": "cuda",
      "source": "lingvo_tpu_torch/ops/csrc/block_decode.cu",
      "replaces": "lingvo_tpu/ops/block_decode.py:247",
      "launches": legacy_launches["block_decode"],
      "max_abs_err": max(r["err"] for r in list(block.values())
                         + [block_decode_only]),
      "ms": main_block["ms"], "plain_ms": main_block["plain_ms"],
      "bound_ms": main_block["bound"][0], "bound_by": main_block["bound"][1],
      "library_ms": None, "decode_only_ms": block_decode_only["ms"],
      "decode_only_bound_ms": block_decode_only["bound"][0]})
  main_fdec = fdec[1151]
  kernels.append({
      "name": "flash_decode", "route": "cuda",
      "source": "lingvo_tpu_torch/ops/csrc/flash_decode.cu",
      "replaces": "lingvo_tpu/ops/flash_decode.py:208",
      "launches": gshard_launches["flash_decode"],
      "max_abs_err": max(r["err"] for r in fdec.values()),
      "ms": main_fdec["ms"], "plain_ms": main_fdec["plain_ms"],
      "bound_ms": main_fdec["bound"][0], "bound_by": main_fdec["bound"][1],
      "library_ms": main_fdec["library_ms"]})
  # the int8 and bfloat16 instantiations: times at the main shapes (the
  # first of each list), errors over every shape
  for name, results, source, line, launches in (
      ("ragged_block_attend", qragged, "ragged_block_attend", 252,
       quant_serve),
      ("block_decode", qblock, "block_decode", 247, quant_serve)):
    for dtype, suffix in (("int8", "_int8"), ("bfloat16", "_bf16")):
      main_res = results[0][dtype]
      kernels.append({
          "name": name + suffix, "route": "cuda",
          "source": f"lingvo_tpu_torch/ops/csrc/{source}.cu",
          "replaces": f"lingvo_tpu/ops/{source}.py:{line}",
          "launches": launches[name + suffix],
          "max_abs_err": max(r[dtype]["err"] for r in results),
          "ms": main_res["ms"], "plain_ms": main_res["plain_ms"],
          "bound_ms": main_res["bound"][0], "bound_by": main_res["bound"][1],
          "library_ms": None})
      if dtype == "bfloat16":   # the float32 kernel on the widened pools
        kernels[-1]["unrounded_control_err"] = min(
            r[dtype]["unrounded_err"] for r in results)
  main_fdec16 = fdec16[1151]
  kernels.append({
      "name": "flash_decode_bf16", "route": "cuda",
      "source": "lingvo_tpu_torch/ops/csrc/flash_decode.cu",
      "replaces": "lingvo_tpu/ops/flash_decode.py:208",
      "launches": bf16_launches["flash_decode_bf16"],
      "max_abs_err": max(r["err"] for r in fdec16.values()),
      "ms": main_fdec16["ms"], "plain_ms": main_fdec16["plain_ms"],
      "bound_ms": main_fdec16["bound"][0],
      "bound_by": main_fdec16["bound"][1],
      "library_ms": main_fdec16["library_ms"],
      "unrounded_control_err": min(r["unrounded_err"]
                                   for r in fdec16.values())})
  for name, res, line in (("flash_fwd_bf16", flash16["fwd"], 230),
                          ("flash_dkdv_bf16", flash16["dkdv"], 368),
                          ("flash_dq_bf16", flash16["dq"], 408)):
    counted = "flash_attention_" + name[len("flash_"):]
    kernels.append({
        "name": name, "route": "cuda",
        "source": "lingvo_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": f"lingvo_tpu/ops/flash_attention.py:{line}",
        "launches": train16_launches[counted], "max_abs_err": res["err"],
        "ms": res["ms"], "plain_ms": res["plain_ms"],
        "bound_ms": res["bound"][0], "bound_by": res["bound"][1],
        "library_ms": res["library_ms"], "differing_share": res["share"]})
    if "control_share" in res:   # p rounded at 64-key tile maxima
      kernels[-1]["tile_max_control_share"] = res["control_share"]
    if "geometry" in res:
      kernels[-1]["design"] = _BF16_BWD_DESIGN[name]
      kernels[-1]["registers"] = res["geometry"]["regs"]
      kernels[-1]["local_bytes"] = res["geometry"]["local"]
  kernels.append({
      "name": "fused_xent_bf16", "route": "cuda",
      "source": "lingvo_tpu_torch/ops/csrc/fused_xent.cu",
      "replaces": "lingvo_tpu/ops/fused_xent.py:277",
      "launches": train16_launches["fused_xent_fwd_bf16"],
      "max_abs_err": xent16["err"], "ms": xent16["ms"],
      "plain_ms": xent16["plain_ms"], "bound_ms": xent16["bound"][0],
      "bound_by": xent16["bound"][1], "library_ms": None})
  # the int8 serving kernels replace no pallas_call: the reference's int8
  # product is an XLA dot_general; times are the sums over the 145 products
  # of a ragged step (m = 264), the decode step's (m = 8) beside them
  note = ("replaces no pallas_call: the XLA dot_general of "
          "lingvo_tpu/core/quant_utils.py:265 Int8Einsum")
  serve_step, decode_step = int8_steps[264], int8_steps[8]
  for name, key in (("int8_act_quant", "a"), ("int8_matmul", "b")):
    kernels.append({
        "name": name, "route": "cuda",
        "source": "lingvo_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": None, "note": note,
        "launches": int8_serve["ragged", None]["launches"][name],
        "max_abs_err": max(serve_step["err"], decode_step["err"]),
        "ms": serve_step[f"{key}_ms"],
        "plain_ms": serve_step[f"{key}_plain_ms"],
        "bound_ms": serve_step[f"{key}_bound"],
        "bound_by": serve_step[f"{key}_by"],
        "library_ms": serve_step["int_mm_ms"] if key == "b" else None,
        "float32_matmul_ms": serve_step["f32_ms"] if key == "b" else None,
        "host_enqueue_us": serve_step["enqueue_us"] if key == "b" else None,
        "decode_step_ms": decode_step[f"{key}_ms"],
        "decode_step_bound_ms": decode_step[f"{key}_bound"],
        "decode_step_library_ms": (decode_step["int_mm_pad_ms"]
                                   if key == "b" else None),
        "both_from_one_call_ms": serve_step["ab_ms"],
        "decode_step_both_ms": decode_step["ab_ms"],
        "legacy_launches": int8_serve["legacy", None]["launches"][name],
        "gshard_launches": int8_gshard[name],
        "shape": "sum over the 145 products of a step, m = 264"})
  main_samp, gshard_samp = samp[264, 2, 40], samp[8, 1, 40]
  kernels.append({
      "name": "sample_tokens", "route": "cuda",
      "source": "lingvo_tpu_torch/ops/csrc/sample_tokens.cu",
      "replaces": None,
      "note": ("replaces no pallas_call: the jax.random.categorical of "
               "lingvo_tpu/core/sampling.py:34 SampleFromLogits"),
      "launches": sample_launches["sample_tokens"],
      "max_abs_err": max(r["err"] for r in samp.values()),
      "max_ulps": max(r["ulps"] for r in samp.values()),
      "ms": main_samp["ms"], "plain_ms": main_samp["plain_ms"],
      "bound_ms": main_samp["bound"][0], "bound_by": main_samp["bound"][1],
      "library_ms": None,
      "threshold_ms": main_samp["threshold_ms"],
      "gshard_ms": gshard_samp["ms"],
      "gshard_bound_ms": gshard_samp["bound"][0],
      "gshard_launches": sample_gshard["sample_tokens"],
      "steps": sample_steps,
      "sass_int_per_element": None if mix is None else mix["int"],
      "sass_float_per_element": None if mix is None else mix["float"],
      "shape": "[264, 32000] float32, top_k 40, (seed, position) folds"})
  # the bfloat16-q instantiations (fprop_dtype=bfloat16): launches from
  # phase 24's counted runs, times from its checks
  for name, res, source, line, launches in (
      ("ragged_block_attend_q_bf16", bf16q["ragged", "bfloat16"],
       "ragged_block_attend", 252, bf16_serve["ragged"]),
      ("ragged_block_attend_q_bf16_f32pool", bf16q["ragged", "float32"],
       "ragged_block_attend", 252, bf16_serve["sampled, float32 pools"]),
      ("ragged_block_attend_q_bf16_int8pool", bf16q["ragged", "int8"],
       "ragged_block_attend", 252, bf16_serve["int8 weights, int8 pools"]),
      ("block_decode_q_bf16", bf16q["block", "bfloat16"], "block_decode",
       247, bf16_serve["legacy"]),
      ("block_decode_q_bf16_f32pool", bf16q["block", "float32"],
       "block_decode", 247, bf16_serve["legacy, float32 pools"]),
      ("block_decode_q_bf16_int8pool", bf16q["block", "int8"],
       "block_decode", 247, bf16_serve["legacy, int8 pools"]),
      ("flash_decode_q_bf16", bf16q["flash", "bfloat16", 1151],
       "flash_decode", 208, dict(launches=bf16_gshard)),
      ("flash_decode_q_bf16_f32cache", bf16q["flash", "float32", 1151],
       "flash_decode", 208, dict(launches=bf16_gshard_f32))):
    kernels.append({
        "name": name, "route": "cuda",
        "source": f"lingvo_tpu_torch/ops/csrc/{source}.cu",
        "replaces": f"lingvo_tpu/ops/{source}.py:{line}",
        "launches": launches["launches"][name], "max_abs_err": res["err"],
        "ms": res["ms"], "plain_ms": res["plain_ms"],
        "bound_ms": res["bound"][0], "bound_by": res["bound"][1],
        "library_ms": res["library_ms"],
        "bf16_elements_differing_from_plain": res["differ"],
        "elements": res["elements"]})
  serve16 = bf16_serve["int8 weights, int8 pools"]["launches"]
  for name, key in (("int8_act_quant_bf16", "a"), ("int8_matmul_bf16", "b")):
    step16 = int8_bf16[264]
    kernels.append({
        "name": name, "route": "cuda",
        "source": "lingvo_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": None, "note": note, "launches": serve16[name],
        "max_abs_err": 0.0, "ms": step16[f"{key}_ms"],
        "plain_ms": step16[f"{key}_plain_ms"],
        "bound_ms": step16[f"{key}_bound"], "bound_by": step16[f"{key}_by"],
        "library_ms": step16["int_mm_ms"] if key == "b" else None,
        "decode_step_ms": int8_bf16[8][f"{key}_ms"],
        "decode_step_bound_ms": int8_bf16[8][f"{key}_bound"],
        "shape": "bfloat16 x and y, sum over the 145 products of a step, "
                 "m = 264"})
  print(json.dumps({"kernels": kernels}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
