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
   (ragged); then DenseLm1B at its full width and 12 of its 24 layers
   (`SERVE_DEPTH`, for the script's time limit; seeded random weights)
   with phase 5's geometry and requests through
   `ServingLoop(kv_cache_dtype=...)`: int8 ragged (exactly 12 int8 ragged
   launches per step, no float32 one), int8 legacy (exactly 12 int8
   block-decode launches per decode-only step), bfloat16 ragged and
   bfloat16 legacy, every other count 0 and quantized_steps equal to the
   steps for int8; each step mode first serves float32 pools again, the
   same process's baseline at that point. Prints ms/step, tok/s, peak
   memory, kv_bytes_per_token and pool bytes, the int8 runs' profiles (of
   decode-only steps in legacy mode), and
   (information only) how many of the 8 streams equal the phase's float32
   ones.
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
   ops/sample_tokens.py (the top-k threshold selected inside it, threefry
   only for live columns, a row split over a cluster) against its plain
   version at [264, 32000] (each token folded with its request's (seed,
   position)) and GShardDecode's step ([8, 32000], rows folded into the
   step key), T = 0.7, top_k 0 and 40, and at R' = 8 rows of [264,
   32000] drawn in place through `rows` (the ragged step's draw; equal to
   the full draw's at those rows): equal tokens, the winning perturbed
   value within 1 ulp (the logarithms are libdevice's and PyTorch's), two
   calls bitwise equal, one launch a call; times the kernel and the plain
   version at each beside the live-work bound (the largest of the bytes,
   threefry's ALU-only operations and every instruction at the issue
   rate, for the live columns only) and the parent's top-k threshold
   (torch.topk of the drawn rows). Then DenseLmTiny's
   sampled streams on the card equal the CPU's (ragged and legacy), and
   its sampled GShardDecode continuations. DenseLm1B with phase 5's
   weights and requests (seeds 100..107) at T = 0.8, top_k 40,
   sample_seed 3 through `ServingLoop`: exactly 24 ragged and 1 sampling
   launch a step, each of at most 8 rows (`SampleTokens.widest`), no
   torch.topk call or kernel in the profiled windows; a second run equal
   stream for stream. The
   random weights' logits are peaked enough that T = 0.8 draws the argmax,
   so the same requests at T = 30 (top_k 0) twice: equal streams, and
   some that differ from the greedy ones; for information, those requests
   in reverse order and one request alone; a cancel of 2 of the 8 after
   their first tokens, after which `Stop` leaves every page free.
   GShardDecode at T = 0.8, top_k 40 from phase 13's weights: 3072
   flash-decode and 128 sampling launches, two calls equal. Kernel (a)'s
   scale on a value where the float32 reciprocal product and the true
   division differ: the product, as the reference's jitted step. Prints
   the full-row sampling kernel's element loop in SASS (instructions by
   class and by pipe, per element).
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
   greedy streams equal the CPU's (information). Then DenseLm1B at its
   full width and 12 of its 24 layers (`SERVE_DEPTH`, as phase 16) at
   fprop_dtype=bfloat16: the first packed step's logits within a relative
   L2 gap of 0.1 of the float32 model's; phase 5's requests at float32
   activations (the baseline of this process), then at bfloat16 through
   ServingLoop ragged (exactly 12 bfloat16-q ragged launches a step,
   bfloat16 pools) and legacy (12 bfloat16-q block-decode launches a
   decode-only step), both profiled (busy, syncs); the shortest request
   for 8 tokens sampled (T 0.8, top_k 40) over float32 pools, with int8
   weights over int8 pools (73 launches of each bfloat16 int8 kernel a
   step), and legacy over float32 and int8 pools: every request completes
   and every step's logits are finite. GShardDecode from a port
   checkpoint of the same weights with a bfloat16 cache (12 x 128 = 1536
   bfloat16-q flash-decode launches, 16 steps profiled) and with a
   float32 cache (1536 of the split and combine kernels' bfloat16-q
   instantiation). Prints the phase's seconds.
25. Hybrid and pure-SSM batch decode, and the gather-dense fallback.
   DenseLmSsmHybridTiny's GShardDecode continuations on the card equal
   the CPU's. Then DenseLmSsmHybrid at full width and depth (12 layers,
   d 1024, 16 heads of 64, S 64, chunk 64; seeded random weights written
   as a port checkpoint), decode_page_size 128, through
   `GShardDecode.DecodeOnce`: 8 prompts of 40..480 tokens right-aligned
   in a 480 bucket (480 + 32 = 512 cache slots: whole 128-slot pages, so
   every step takes the flash-decode read), prefill chunks of 160, 32
   greedy steps, after one warm-up call; exactly 10 x 3 scan and 2 x 32
   flash-decode launches, nothing else; the telemetry's decode state
   (10 SSM states + 2 layers of KV) printed beside DenseLm1B's KV at the
   same length. The scan kernel against `_ChunkedPlain` (phase 4's
   checks and tolerance) on the first SSM layer's real inputs of prefill
   chunks 1 and 2 ([8, 160, 16], left-pad identity steps, the zero and
   then the carried s0), and flash decode against its plain version at
   [8, 512, 16, 64] with the prompts' paddings (t 511 and 490). The same
   weights with the plain versions (scan_lowering 'chunked',
   decode_page_size 0; no kernel launched): the logits of the first
   token and of one step after within DECODE_LOGITS_REL x max(1,
   max|logit|), first tokens equal unless a near-tie, the greedy
   streams compared (the first divergence printed). A pure-SSM stack
   (mixer_atten_every_n 0, 4 layers, the hybrid's widths) decodes 16 and
   64 steps: 4 x 3 scan launches each, KV census None / 0, the same
   decode state per sequence at both lengths. Then DenseLm1B with
   atten_logit_cap 50 (Gemma 2's soft-cap) through ServingLoop, ragged
   and legacy, 4 prompts of 64 tokens, 16 new tokens: paged_path
   'dense', dense_fallback_steps equal to the steps, no kernel launched,
   the two modes' streams equal, each beside the same weights uncapped
   (24 ragged launches a step, 24 block-decode launches a decode-only
   step; ms/step of both in this process); the capped ragged step's
   first logits and streams against GShardDecode of the capped task
   (its dense read) as above. Last, a DenseLmTiny of head dim 96 (not a
   block-decode head dim) in the legacy step: 'dense' on the card, no
   launch, streams equal to the CPU engine's block-decode read. Prints
   the phase's seconds.
26. The trainer CLI. First the fused-xent statistics kernel against
   `_PlainStats` at DenseLmWord793k's shape (x [2048, 1024], the table
   [793,600, 1024], float32, cap 30, block 1024; phase 8's bar, two calls
   bitwise equal), with its geometry (row tiles x splits), time, bound
   and the plain version's time. Then `trainer.main` on DenseLmWord793k
   as registered (8 layers, d 1024, seq 256, batch 8, tied vocabulary of
   793,600, random weights from a CPU generator seeded 1234), with
   --max_steps=20, in a temporary logdir: one schedule cycle of 20 train
   steps and the eval_test program's 125 batches, the step-0 background
   save and the final save. Checks FINISHED holds 20, metrics.jsonl's
   train and eval_test losses are finite, and the xent kernel launched
   exactly 20 + 125 times and no other kernel; prints ms/step, the eval's
   seconds, peak memory and each checkpoint's bytes, snapshot and write
   seconds; profiles one more train step of the same task (device
   activity only: its busy share), then times 3 more steps through the
   default (async) `TrainProgram` with no save in flight; deletes the
   logdir. Last, DenseLmTiny's shapes and recipe
   at 4 steps a loop and 32 eval samples through the CLI on the card and
   then the CPU: train to 8, resume to 16, `--mode=eval`; every loop's
   and eval's loss within 1e-4 of the CPU's, no kernel launched. Prints
   the phase's seconds.
27. The hybrid's training. First the scan's backward kernel
   (`ops/csrc/ssd_scan_bwd.cu`) against `_PlainScanBwd` at the training
   shape ([8, 1024, 16], S = H = 64, chunk 64) with a packed batch's
   resets and a padded tail built by `_MaskScanInputs`, then with a
   nonzero s0 and a cotangent of s_final: every gradient finite, its max
   |error| over its max |plain| within 1e-4 (printed), two calls bitwise
   equal; its launch geometry, time, bound and the plain version's time.
   Then `trainer.main` on DenseLmSsmHybrid as registered (d 1024, 12
   layers, remat 'full', 8 x 1024 tokens, vocabulary 32,000 tied, random
   weights from a CPU generator seeded 1234), --max_steps=20: FINISHED
   holds 20, finite train and eval_test losses, and exactly 10 x (2 x 20
   + 125) forward scans (remat's recompute runs each mixer again) and 10
   x 20 backward ones, nothing else; ms/step, tokens/s and peak memory;
   one more train step profiled (busy against the wall, the scan
   forward's and backward's shares of busy). DenseLmSsmHybridTiny through
   the CLI on the card and the CPU as phase 26's DenseLmTiny (within
   1e-4), the card's run launching both scan kernels. Last the bfloat16
   half: one DenseLmSsmHybrid train step at fprop_dtype=bfloat16 (finite,
   not skipped, 20 + 10 scan launches), the tiny twin's bf16 logits card
   against CPU (phase 24's bar), and the full-width bf16 hybrid through
   ServingLoop (ragged, 8 requests of 8 tokens: 10 scans and 2 bf16-q
   ragged launches a step) and GShardDecode (phase 25's requests: 10 x 3
   scans and 2 x 32 bf16-q flash decodes). Prints the phase's seconds.
28. The 1B-words configs. First the fused-xent statistics kernel against
   `_PlainStats` at WordLevelOneBwdsSampledSoftmax's eval shape (x
   [16384, 1024], the untied table [793,470, 1024] and a normal bias,
   float32, no cap, block 1024: a last vocab tile of 126 columns) and at
   V 1003 with a bias (phase 8's bar, two calls bitwise equal), with its
   geometry, time, bound and the plain version's time. Then
   `trainer.main` on WordLevelOneBwdsSampledSoftmax at its registered
   widths (20 layers, d 1024, 32 x 512 tokens, 4096 negatives, Adam,
   residual dropout 0.1; random weights from a CPU generator seeded 1234),
   cut in step and batch counts only (3 steps a loop and --max_steps=3,
   64 eval samples: 2 batches, 1 checkpoint kept, the step-0 save of the
   random weights skipped): FINISHED holds 3, finite train and eval
   losses, the xent kernel launched exactly once an eval batch and never
   in training; prints the free disk and host memory before the save,
   ms/step, peak memory and the final save's bytes and seconds, profiles
   one more train step (busy share; its TrainStep makes no host sync, as
   `torch.cuda.set_sync_debug_mode` counts them) and times the dropout
   masks' plain threefry (masks a step x one mask's time) and Adam's
   update of every parameter; deletes the logdir. Then
   OneBWdsTransformerLm as registered: two train steps through
   TrainProgram, finite, no kernel launched. Last a tiny
   twin of the sampled config (2 layers, V 1003, 64 negatives, residual
   dropout 0.1) from one npz on the card and the CPU: two TrainSteps'
   dropout masks bitwise equal by key, losses and an eval (the kernel on
   the card) within 1e-5; and the negative ids at V 793,470 over 50 step
   keys, card against CPU: the mismatches counted, each one id away, at
   most 0.3% of them. Prints the phase's seconds.
29. The trainer's remaining training surface (no registered config sets
   these options, so the phase sets them by hand). First the Shampoo
   inverse root's library call (`torch.linalg.eigh`, cuSOLVER) timed at
   4096 and 1024. (a) `trainer.main` on a distillation experiment:
   `DenseLm1B`'s task as registered with flash on as the frozen teacher,
   `OneBWdsTransformerLm`'s task at its registered widths (d 1024, 16
   heads, FFN 4096, V 32,000, residual dropout 0.1) cut to 8 unrolled
   layers with flash on as the student, `DenseLm1B`'s input (8 x 1024),
   two learners split by `bprop_variable_filter` (Adam over the
   student's embedding and norms, `DistributedShampoo(block_size=4096)`
   over the rest: the 16 FFN matrices preconditioned, the 3-D attention
   weights on the diagonal fallback), `ema_decay` 0.999 and pruning of the
   FFN weights to 0.5 (frequency 1, the ramp over the 6 steps); 2 steps a
   loop to --max_steps=4 (step 0 a refresh; one eval batch a loop, on the
   EMA weights; the step-0 save skipped, the final save kept), then a
   resume to 6 (its final save skipped). Gates: FINISHED, finite losses,
   the teacher's theta bitwise unchanged by each run, the realized
   sparsity the schedule's at the run's last step (int(sparsity x size)
   zeros a matrix, plus at most 64 ties at a threshold, which the
   reference's rule prunes too), the resume's
   restored `ema_theta` and both learners' states bitwise equal to the
   first run's final ones, and the flash kernels' launches exact (per
   learner and step 24 teacher forwards and 8 student forwards,
   backwards 8 each; 32 forwards an eval batch). Prints each step's
   time (a refresh step against a plain one) and the peak memory. (b)
   `ExecutorTpu(None, logdir, schedule=MultiTaskProgramSchedule(...))` on
   two tasks at the student's widths with the fused xent (block 1280),
   the embedding shared by `variable_renaming_rules`, task a on EGDD and
   task b on AdaGraft(Adam, Momentum), `ConstantScheduler` seed 3, 4
   cycles of 2 steps: both tasks sampled, the shared leaves bitwise equal
   after every cycle, the launches exact (8 flash forwards, dK/dV and dQ
   and 1 xent a step), the combined checkpoint round-trips. (c) The tiny
   twins on the card and the CPU: the distillation experiment at
   `DenseLmTiny`'s widths through the CLI (train to 8, resume to 16,
   eval) and the multi-task run on `DenseLmTiny`-sized tasks: every loss
   within 1e-4, but the distillation's after Shampoo's step-10 refresh
   within 1e-3 (its roots' near-null directions follow the solver's
   rounding, ROADMAP §3). (b) and (c) skip the step-0 save. Prints the
   phase's seconds.
30. Prints the per-kernel JSON line (every kernel and every int8 /
   bfloat16 instantiation, and the bfloat16-q ones; the int8 serving
   kernels, the sampling kernel and the scan's backward with "replaces":
   null; the scan's and flash decode's times at the hybrid decode's
   shapes beside their main ones; the xent kernel at DenseLmWord793k's
   shape and at the sampled eval's, each with its CLI run's launches;
   the flash and xent rows with phase 29's launches), then the result
   line.

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
import shutil
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


_T0 = time.perf_counter()


def _Phase(name):
  print(f"\n== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


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
      if hasattr(fn, "rows_drawn"):   # a wrapper that counts drawn rows
        fn.rows_drawn = fn.widest = 0
      if dtype is not None:
        table, key = self._Table(fn, dtype)
        table[key] = 0

  def Rows(self) -> dict:
    """{name: (rows drawn, the widest call)} of the wrappers that count
    the rows they draw (the sampling kernel's R')."""
    return {name: (fn.rows_drawn, fn.widest)
            for name, (fn, _) in self.entries.items()
            if hasattr(fn, "rows_drawn")}

  def Read(self) -> dict:
    out = {}
    for name, (fn, dtype) in self.entries.items():
      if dtype is None:
        out[name] = fn.launches
      else:
        table, key = self._Table(fn, dtype)
        out[name] = table[key]
    return out


class _SecondCount:
  """A wrapper's second launch count (`attr`) seen as its `launches`, as
  `_Counts` reads and zeroes them."""

  def __init__(self, fn, attr):
    self.__dict__.update(fn=fn, attr=attr)

  def __getattr__(self, name):
    return getattr(self.fn, self.attr if name == "launches" else name)

  def __setattr__(self, name, value):
    setattr(self.fn, self.attr if name == "launches" else name, value)


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
      ssd_scan_bwd=(_SecondCount(ssd.SsdScan, "bwd_launches"), None),
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


def _EventMs(torch, fn):
  """Device ms of one fn() between two CUDA events, with no flush and no
  spin: for a plain version that runs a second or more, whose host work
  is a small part of it and for which `_TimeMs`'s growing spins would
  cost more than the call itself."""
  torch.cuda.synchronize()
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end)


def _EnqueueUs(torch, fn, calls=20, reps=20):
  """Host microseconds per call of fn, with the card kept busy by a spin
  of ~10 ms so that every call only enqueues: what a host-bound step pays
  for each call. The spin covering every batch is checked: a batch whose
  enqueue outlasted its spin (a host that stalled) is run again with the
  spin doubled, up to three times, and then the run fails."""
  fn()
  torch.cuda.synchronize()
  total, done, cycles, misses = 0.0, 0, 20_000_000, 0   # ~10 ms at ~2 GHz
  while done < reps:
    spin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    spin.record()
    torch.cuda._sleep(cycles)
    end.record()
    t0 = time.perf_counter()
    for _ in range(calls):
      fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if host_s * 1e3 >= spin.elapsed_time(end):
      misses += 1
      _Check(misses <= 3, "_EnqueueUs: the spin ended before the calls "
             f"were enqueued, {misses} times, the last at {cycles} cycles")
      cycles *= 2
      continue
    total += host_s
    done += 1
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
               vocab=32000, vd=True, d=2048, table_seed=None, cap=30.0,
               bias_seed=None, iters=(5, 3)):
  """The fused-xent statistics kernel against `_PlainStats` on the card:
  x [m, d], the table [vocab, d] (vd; else [d, vocab]), cap `cap`, in
  `dtype`; two calls bitwise equal. table_seed: the table is drawn on the
  card from a generator with that seed (a large table from numpy takes
  tens of seconds on the host). bias_seed: a normal bias drawn on the
  card from that seed (else the tied head's zero bias). iters: the timed
  calls of the kernel and of the plain version (0: one call between two
  events, `_EventMs`)."""
  dt = getattr(torch, dtype)
  x = torch.as_tensor(rng.randn(m, d).astype(np.float32)).cuda().to(dt)
  if table_seed is None:
    w = torch.as_tensor((rng.randn(vocab, d) / np.sqrt(d)).astype(
        np.float32)).cuda().to(dt)
  else:
    w = (torch.randn((vocab, d), device="cuda", generator=torch.Generator(
        "cuda").manual_seed(table_seed)) / np.sqrt(d)).to(dt)
  w_arg = w if vd else w.t().contiguous()
  if bias_seed is None:
    bias = torch.zeros(vocab, device="cuda", dtype=dt)
  else:
    bias = torch.randn((vocab,), device="cuda", generator=torch.Generator(
        "cuda").manual_seed(bias_seed)).to(dt)
  labels = torch.as_tensor(rng.randint(0, vocab, m).astype(np.int32)).cuda()
  cfg = fx._Cfg(block_size=block, vocab=vocab, vd=vd, soft_cap=cap,
                label_smoothing=ls)
  got = fx.FusedXentStats(x, w_arg, bias, labels, cfg)
  again = fx.FusedXentStats(x, w_arg, bias, labels, cfg)
  want = fx._PlainStats(x, w_arg, bias, labels, cfg)
  torch.cuda.synchronize()
  _Check(all(torch.equal(a, b_) for a, b_ in zip(got, again)
             if a is not None), f"xent {dtype}: two calls differ bitwise")
  label = (f"xent {dtype} [{m}, {d}] x {'[V, D]' if vd else '[D, V]'} V "
           f"{vocab} block {block} ls {ls} cap {cap}"
           + ("" if bias_seed is None else " with a normal bias"))
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
  print(f"tolerances: lse, label logit 1e-4 (logits of O(1), each a "
        f"{d}-term float32 dot in two orders); logit sum 5e-3 (adds {vocab} "
        f"of them)")
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

    def _Logit(idx):
      s_ = (rows * w[idx].float()).sum(-1) + bias[idx].float()
      return cap * torch.tanh(s_ / cap) if cap > 0 else s_

    s_k = _Logit(got[3][differ].long())
    s_p = _Logit(want[3][differ].long())
    gap = float((s_k - s_p).abs().max())
    _Check(gap <= 1e-5, f"xent argmax differs on {len(differ)} rows whose "
           f"top logits differ by {gap} > 1e-5")
  print(f"{label}: argmax equal on {m - len(differ)} of {m} rows (the rest "
        f"are ties within 1e-5)")
  if not time_it:
    return dict(err=max(errs))
  ms = _TimeMs(torch, lambda: fx.FusedXentStats(x, w_arg, bias, labels, cfg),
               iters[0])
  plain = lambda: fx._PlainStats(x, w_arg, bias, labels, cfg)
  plain_ms = (_EventMs(torch, plain) if iters[1] == 0 else
              _TimeMs(torch, plain, iters[1], waits_as="plain xent stats"))
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
      program.TrainProgram.Params().Set(steps_per_loop=1,
                                        async_infeed=False),
      task=lm, input_generator=cfg.Train().Instantiate())
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
      program.TrainProgram.Params().Set(steps_per_loop=n,
                                        async_infeed=False),
      task=lm, input_generator=gen)
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
  Returns those calls per step, by window ('first', 'last'), and the
  window's torch.topk calls and kernels ('topk_first', 'topk_last')."""
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
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    # torch.topk's calls (host ops) and kernels (by name) in the window
    syncs[f"topk_{label}"] = sum(
        e.count for e in host if e.key == "aten::topk") + sum(
            e.count for e in kernels if "topk" in e.key.lower()
            and "SampleTopKKernel" not in e.key)
    busy_ms = sum(_DevUs(e) for e in kernels) / 1e3
    if busy_ms == 0:
      print(f"{label} {window} steps: profiler recorded no device time; "
            f"torch.topk calls {syncs[f'topk_{label}']}")
      continue
    kernels.sort(key=_DevUs, reverse=True)
    attn = sum(_DevUs(e) for e in kernels if "RaggedAttend" in e.key
               or "BlockDecode" in e.key) / 1e3
    scan = sum(_DevUs(e) for e in kernels if "SsdScan" in e.key) / 1e3
    int8 = sum(_DevUs(e) for e in kernels if "Int8" in e.key) / 1e3
    sample = sum(_DevUs(e) for e in kernels
                 if "SampleAllKernel" in e.key
                 or "SampleTopKKernel" in e.key) / 1e3
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
    syncs[label] = sum(e.count for e in host
                       if e.key == "cudaStreamSynchronize") / window
    print(f"  cudaStreamSynchronize calls per step: {syncs[label]:g}; "
          f"torch.topk calls and kernels in the window: "
          f"{syncs[f'topk_{label}']}")
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
  counters.served_rows = counters.Rows()
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


def _CheckFlashDecode(torch, fd, rng, prompt_lens, dtype="float32", s=1152,
                      h=128, p_len=1024, ts=(1151, 700)):
  """The flash-decode kernel against `_PlainDecode` on the card at
  [8, s, 16, h] (default [8, 1152, 16, 128]), page 128, on a `dtype`
  cache, with the left-pad cache paddings of `prompt_lens` right-aligned
  in a p_len bucket (as GShardDecode builds them), at each t of `ts`;
  padded slots hold NaN, and for t < s - 1 so do the slots past t. Times the kernel, the plain version, SDPA over the
  whole cache with the same boolean mask (for a bfloat16 cache, with q
  cast to bfloat16, as SDPA takes one dtype), and the bound: the live
  unpadded K/V slots, the paddings of the live pages, q and out. A
  bfloat16 cache holds dyadic K and takes a dyadic q (`_Dyadic`), and the
  float32 kernel on the widened cache is its unrounded control."""
  b, n, page = 8, 16, 128
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
  for t in ts:
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
    print(f"{label} [8, {s}, 16, {h}] P={page}: {live} live slots, max abs "
          f"err {err:.3g} (tol {TOL}), kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, SDPA "
          f"{lib_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; "
          f"{moved / 1e6:.1f} MB)")
    res[t] = dict(ms=ms, plain_ms=plain_ms, bound=bound, err=err,
                  unrounded_err=ctl_err, library_ms=lib_ms)
    del kc, vc
  return res


def _GShardTiny(torch, spi, attention, checkpointer, gshard, tmp,
                kv_cache_dtype=None, serve_int8_weights=False, sample=None,
                cfg=None):
  """`cfg` (default DenseLmTiny; decode_page_size 4, `kv_cache_dtype`
  caches, int8 weights with `serve_int8_weights`, sampled with `sample`,
  the decoder's temperature and top_k) through GShardDecode on the card
  and on the CPU from one port checkpoint: the continuations must
  agree."""
  cfg = cfg or spi.DenseLmTiny()
  name = type(cfg).__name__
  p = cfg.Task().Set(kv_cache_dtype=kv_cache_dtype)
  p.atten_tpl = attention.MultiHeadedAttention.Params().Set(
      decode_page_size=4)
  cpu_lm = p.Instantiate(device="cpu")
  cpu_lm.InstantiateVariables(torch.Generator("cpu").manual_seed(1))
  ckdir = os.path.join(tmp, f"{name}_{kv_cache_dtype}")
  checkpointer.Checkpointer(ckdir).Save(1, cpu_lm, force=True)
  gpu_lm = p.Instantiate(device="cuda")   # DecodeOnce restores its weights
  rng = np.random.RandomState(4)
  lens = np.array([5, 13, 21, 8, 2, 30], np.int32)
  prompts = rng.randint(1, 128, size=(len(lens), 30)).astype(np.int32)
  outs = {}
  for device, lm in (("cpu", cpu_lm), ("cuda", gpu_lm)):
    decoder = gshard.GShardDecode(
        lm, ckdir, f"{ckdir}_{device}.jsonl",
        max_decode_steps=12, prefill_chunk_size=8,
        serve_int8_weights=serve_int8_weights, **(sample or {}))
    outs[device] = [r["output_ids"] for r in decoder.DecodeOnce(1, prompts,
                                                               lens)]
  _Check(outs["cpu"] == outs["cuda"], f"{name} GShardDecode continuations "
         f"differ:\n{outs['cpu']}\n{outs['cuda']}")
  print(f"{name} GShardDecode reference ({kv_cache_dtype or 'float32'} "
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
                sample=None, profile=True, fprop_dtype=None, steps=128,
                cfg=None):
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
  the checkpoint too. steps: tokens decoded. cfg: DenseLm1B (default) or
  a cut of its depth (`_DenseLm1BCut`); the counts follow its layers.
  Returns (launches, telemetry, the continuations)."""
  t_call = time.perf_counter()
  cfg = cfg or spi.DenseLm1B()
  layers = cfg.NUM_LAYERS
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
  want[counted] = layers * steps
  if serve_int8_weights:   # 4 prefill chunks of 256 and the steps
    int8 = "_bf16" if bf16 else ""
    want["int8_act_quant" + int8] = want["int8_matmul" + int8] = (
        _Int8Products(layers) * (4 + steps))
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
  print(f"{type(cfg).__name__} GShardDecode ({tel['kv_cache_dtype']} cache"
        f"{', bf16 activations' if bf16 else ''}, kv_bytes_per_token "
        f"{tel['kv_bytes_per_token']}): 8 prompts (bucket 1024) x {steps} "
        f"tokens, prefill chunks of 256: prefill_s "
        f"{tel['prefill_s']:.3f}, decode_s {tel['decode_s']:.3f} "
        f"({tel['decode_s'] / steps * 1e3:.2f} ms per step), "
        f"{tel['tokens_per_sec']:.1f} tokens/s, decode state "
        f"{tel['decode_state_bytes_per_seq'] / 2**20:.1f} MiB per sequence, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches { {k: v for k, v in launches.items() if v} } ({layers} x "
        f"{steps}"
        + (f"; {_Int8Products(layers)} x (4 + {steps}) of each int8 kernel"
           if serve_int8_weights else "")
        + f"){', int8 weights' if serve_int8_weights else ''}")
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
  print(f"{type(cfg).__name__} GShardDecode: "
        f"{time.perf_counter() - t_call:.1f} s in all")
  return launches, tel, [r["output_ids"] for r in recs]


def _Int8Products(layers):
  """The int8 products of a DenseLm serving step: q, k, v, post and the
  FFN's two in each layer, and the tied logits (145 at 24 layers)."""
  return 6 * layers + 1


# phases 16 and 24 serve DenseLm1B at its full width and SERVE_DEPTH of its
# 24 layers, for the script's time limit; every other phase keeps 24
SERVE_DEPTH = 12


def _DenseLm1BCut(spi):
  """DenseLm1B's config at SERVE_DEPTH layers (its widths unchanged)."""
  return type(f"DenseLm1BDepth{SERVE_DEPTH}", (spi.DenseLm1B,),
              {"NUM_LAYERS": SERVE_DEPTH})()


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
  a global load, i.e. the body a thread runs per element loaded. Returns
  its counts per global load, {"int": n, "float": n, "other": n, "total":
  n, "loads": n, "ops": {opcode: n}}, or None where cuobjdump is missing
  or no such loop is found."""
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
    if (any(c[1] == "LDG" for c in loop)
        and (best is None or len(loop) > len(best))):
      best = loop
  if best is None:
    return None
  per = sum(c[1] == "LDG" for c in best)
  ops = {}
  for _, op, _ in best:
    ops[op] = ops.get(op, 0) + 1 / per
  n_int = sum(v for k, v in ops.items() if k in _INT_OPS)
  n_float = sum(v for k, v in ops.items() if k in _FLOAT_OPS)
  return dict(int=n_int, float=n_float,
              other=len(best) / per - n_int - n_float,
              total=len(best) / per, loads=per, ops=ops)


def _SampleBound(st, live, moved, mix):
  """The sampling kernel's live-work bound: (ms, "bytes" or "operations",
  {limit: ms}), the largest of three limits: the bytes the call must move
  (`moved`: the drawn rows' logits read once, the folds and rows, the
  outputs) at the memory rate; the operations only the ALU pipe runs (the
  algorithm's rotates, xors and shifts, `ALU_OPS_PER_ELEMENT`) for the
  `live` columns at 64 lanes an SM a clock; and every instruction of those
  columns at the issue rate, 128 lanes an SM a clock, counting the
  algorithm's integer operations and the compiled element loop's float
  instructions (the accurate logf's among them; none where the SASS could
  not be read). Masked columns need no threefry and no logarithm; the
  top-k select's passes over the held slices are on-chip work that no
  limit here counts (its pace shows as the gap to the bytes)."""
  parts = dict(
      bytes=moved / HBM_BYTES_PER_S * 1e3,
      alu=live * st.ALU_OPS_PER_ELEMENT / INT32_OPS_PER_S * 1e3,
      issue=live * (st.INT_OPS_PER_ELEMENT + (mix["float"] if mix else 0))
      / INSTRUCTIONS_PER_S * 1e3)
  by = max(parts, key=parts.get)
  return parts[by], "bytes" if by == "bytes" else "operations", parts


def _CheckSample(torch, st, threefry, r, f, top_k, seed, mix=None,
                 time_it=False, temperature=0.7, rows=None):
  """The sampling kernel against its plain version on [r, 32000] logits
  (the serving step's vocabulary): f = 2 folds each row with an engine
  (seed, position) pair, f = 1 with its row index against a GShardDecode
  step key (`Split(PRNGKey(1), 128)[5]`); rows: the drawn rows (None:
  all), read in place. Tokens equal, the winning value within 1 ulp, two
  calls bitwise equal, one launch a call; with `time_it`, the kernel and
  the plain version timed beside the live-work bound (`_SampleBound`,
  with the element loop's SASS mix `mix`) and the parent's library call,
  torch.topk of the drawn rows (its threshold, before the draw)."""
  from lingvo_tpu_torch.core import jit_arith
  v = 32000
  gen = torch.Generator("cuda").manual_seed(seed)
  x = torch.randn(r, v, generator=gen, device="cuda") * 4
  n = r if rows is None else len(rows)
  if f == 2:   # tokens of 8 requests: each request's seed, positions
    req = np.random.RandomState(seed).randint(0, 8, size=n)
    seeds = np.random.RandomState(seed + 1).randint(0, 2**31 - 1, size=8)
    fold = np.stack([seeds[req], np.arange(n) % 33], 1)
    key = threefry.PRNGKey(3)
  else:
    fold = np.arange(n)[:, None]
    key = threefry.Split(threefry.PRNGKey(1), 128)[5]
  fold = torch.as_tensor(fold.astype(np.int32)).cuda()
  drawn = None if rows is None else torch.as_tensor(
      np.asarray(rows, np.int32)).cuda()
  inv_t = jit_arith.Reciprocal(temperature)
  call = lambda: st.SampleTokens(x, key, fold, inv_t, top_k, rows=drawn,
                                 return_z=True)
  before = st.SampleTokens.launches
  tokens, z = call()
  tokens2, z2 = call()
  torch.cuda.synchronize()
  _Check(st.SampleTokens.launches == before + 2,
         "sample_tokens: one launch a call")
  want, want_z = st._PlainSample(x, key, fold, inv_t, top_k, drawn)
  s, chunk = st.LaunchPlan(n, v, top_k, x.device)
  label = (f"sample_tokens [{r}, {v}]" + ("" if rows is None else
                                          f" rows R'={n}")
           + f" F={f} top_k={top_k} (cluster of {s}, {chunk} columns a "
           "block)")
  _Check(torch.equal(tokens, tokens2) and torch.equal(z, z2),
         f"{label}: two calls differ")
  differ = int((tokens != want).sum())
  _Check(differ == 0, f"{label}: {differ} tokens differ from the plain "
         "version")
  ulps = float(_Ulps(torch, z, want_z).max())
  err = float((z - want_z).abs().max())
  _Check(ulps <= 1.0, f"{label}: winning value {ulps} ulp off")
  if rows is not None:   # the full draw's tokens at those rows
    full_fold = torch.zeros(r, f, dtype=torch.int32, device="cuda")
    full_fold[drawn.long()] = fold
    full, full_z = st.SampleTokens(x, key, full_fold, inv_t, top_k,
                                   return_z=True)
    _Check(torch.equal(full[drawn.long()], tokens)
           and torch.equal(full_z[drawn.long()], z),
           f"{label}: the rows' draws differ from the full draw's")
  scaled = x if rows is None else x[drawn.long()]
  scaled = scaled * inv_t
  masked = st.Masked(top_k, v)
  live = (int((scaled >= torch.topk(scaled, top_k, dim=-1).values[:, -1:])
              .sum()) if masked else n * v)
  res = dict(err=err, ulps=ulps, live=live, cluster=s)
  msg = (f"{label}: tokens equal, winning value within {ulps:g} ulp "
         f"({err:.3g} abs), {live} live logits")
  if time_it:
    moved = (4 * n * v + 4 * n * f + 8 * n
             + (0 if rows is None else 4 * n))
    *res["bound"], parts = _SampleBound(st, live, moved, mix)
    res["ms"] = _TimeMs(torch, call, 20)
    res["plain_ms"] = _TimeMs(
        torch, lambda: st._PlainSample(x, key, fold, inv_t, top_k, drawn),
        3, waits_as="plain sampling (the key's copy to the card)")
    held = x if rows is None else x[drawn.long()].contiguous()
    res["topk_ms"] = (_TimeMs(torch, lambda: torch.topk(held, top_k, dim=-1),
                              20) if masked else None)
    msg += (f"; kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.3f} ms, "
            f"the parent's top-k threshold (torch.topk) {res['topk_ms']} ms"
            f", live-work bound {res['bound'][0]:.4f} ms ({res['bound'][1]}"
            f"; the limits: {moved / 1e6:.2f} MB at 3.35 TB/s "
            f"{parts['bytes']:.4f} ms, {st.ALU_OPS_PER_ELEMENT} ALU-pipe "
            f"operations a live column at {INT32_OPS_PER_S / 1e12:.2f} T/s "
            f"{parts['alu']:.4f} ms, {st.INT_OPS_PER_ELEMENT} integer + "
            f"{mix['float'] if mix else 0:g} float instructions a live "
            f"column issued at {INSTRUCTIONS_PER_S / 1e12:.2f} T/s "
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


def _TinyBf16(torch, spi, engine, ragged, cfg=None):
  """`cfg` (default DenseLmTiny) at fprop_dtype=bfloat16 on the card
  against the same weights on the CPU: two packed RaggedSteps' logits
  (teacher-forced: the second reads what the first wrote) within
  TWIN_REL, the card at float32 activations missing it; then greedy
  streams of the ragged and legacy engines (bfloat16 pools), how many
  equal the CPU's printed."""
  cfg = cfg or spi.DenseLmTiny()
  name = type(cfg).__name__
  p16 = cfg.Task().Set(fprop_dtype=torch.bfloat16)
  cpu_lm = p16.Instantiate(device="cpu")
  cpu_lm.InstantiateVariables(torch.Generator("cpu").manual_seed(1))
  lms = {"cpu": cpu_lm}
  for name_, p in (("cuda", p16), ("cuda f32", cfg.Task())):
    lms[name_] = p.Instantiate(device="cuda")
    lms[name_].load_state_dict(cpu_lm.state_dict())
  tables = np.arange(16, dtype=np.int32).reshape(4, 4)
  rng = np.random.RandomState(3)
  packs = [(ragged.BuildRaggedRows([1, 9, 0, 4], [0, 0, 1, 0], 16, 9),
            rng.randint(0, 128, size=(1, 16)).astype(np.int32)),
           (ragged.BuildRaggedRows([1, 3, 1, 4], [1, 9, 0, 4], 16, 9),
            rng.randint(0, 128, size=(1, 16)).astype(np.int32))]
  logits = {}
  for name_, lm in lms.items():
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
    logits[name_] = torch.cat(outs)
  rel = lambda a: float((a - logits["cpu"]).norm() / logits["cpu"].norm())
  gap, ctl = rel(logits["cuda"]), rel(logits["cuda f32"])
  print(f"{name} bf16 twin: two packed steps' logits, card against "
        f"CPU: relative error norm {gap:.4g} (bar {TWIN_REL}); the card at "
        f"float32 activations against the CPU at bfloat16: {ctl:.4g}")
  _Check(gap <= TWIN_REL, f"{name} bf16 logits cuda vs cpu: relative "
         f"{gap} > {TWIN_REL}")
  _Check(ctl > TWIN_REL, f"{name} bf16 control: the card at float32 is "
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
  print(f"{name} bf16 twin: greedy streams equal to the CPU's "
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
               checkpointer, gshard, counters, prompt_lens):
  """Phase 24 (see the module docstring). Returns (the bfloat16-q kernel
  checks, the int8 bfloat16 kernels' step sums, the serving runs, the
  two GShardDecode runs' launches). DenseLm1B at SERVE_DEPTH layers."""
  t_phase = time.perf_counter()
  print("bf16-q ragged / block decode library_ms: null (as phases 3 and "
        "10); flash decode: SDPA on the same bf16 tensors; int8 (b): "
        "torch._int_mm (the int32 product alone)")
  bf16q = _CheckBf16QKernels(torch, rba, bd, fd, ragged, prompt_lens)
  int8_bf16 = _CheckInt8Bf16(torch, im, np.random.RandomState(27))
  gc.collect()
  torch.cuda.empty_cache()
  _TinyBf16(torch, spi, engine, ragged)
  cfg = _DenseLm1BCut(spi)
  layers, products = cfg.NUM_LAYERS, _Int8Products(cfg.NUM_LAYERS)
  lm = _ServingLm(torch, cfg)
  lm16 = _ServingLm(torch, cfg, fprop_dtype=torch.bfloat16)
  _FirstStepGap(torch, cfg, ragged, lm, lm16)
  # the same requests at float32 activations first, unprofiled: the
  # baseline of this process at this point (walls drift over a process)
  f32_ms = _ServeMain(torch, cfg, engine, counters,
                      dict(ragged_block_attend=layers), lm=lm,
                      profile=False)[3]
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
      ("ragged", "ragged", None, dict(ragged_block_attend_q_bf16=layers),
       None, {}),
      ("legacy", "legacy", None, {}, dict(block_decode_q_bf16=layers),
       dict(windows=LEGACY_WINDOWS)),
      ("sampled, float32 pools", "ragged", "float32",
       dict(ragged_block_attend_q_bf16_f32pool=layers, sample_tokens=1),
       None,
       dict(short, sample=dict(temperature=0.8, top_k=40, sample_seed=3),
            seeds=list(range(100, 108)))),
      ("int8 weights, int8 pools", "ragged", "int8",
       dict(ragged_block_attend_q_bf16_int8pool=layers,
            int8_act_quant_bf16=products, int8_matmul_bf16=products), None,
       dict(short, serve_int8_weights=True)),
      ("legacy, float32 pools", "legacy", "float32", {},
       dict(block_decode_q_bf16_f32pool=layers), short),
      ("legacy, int8 pools", "legacy", "int8", {},
       dict(block_decode_q_bf16_int8pool=layers), short)):
    syncs = {}
    launches, steps, streams, ms = _ServeMain(
        torch, cfg, engine, counters, per_step, per_decode, step_mode=mode,
        kv_cache_dtype=dtype, lm=lm16, syncs=syncs, **kw)
    bf16_serve[key] = dict(launches=launches, steps=steps, ms=ms, syncs=syncs,
                           streams=streams)
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
  # the continuations' first tokens against the ragged bf16 run's streams
  ref_streams = bf16_serve["ragged"]["streams"]
  with tempfile.TemporaryDirectory() as tmp:
    bf16_gshard, _, _ = _GShardMain(
        torch, spi, attention, checkpointer, gshard, counters, tmp,
        ref_streams, fprop_dtype=torch.bfloat16, cfg=cfg)
    gc.collect()
    torch.cuda.empty_cache()
    # a cache of 1024 + 128 slots: a whole number of 128-slot pages, so
    # every step takes the flash-decode read
    bf16_gshard_f32, _, _ = _GShardMain(
        torch, spi, attention, checkpointer, gshard, counters, tmp,
        ref_streams, kv_cache_dtype="float32", fprop_dtype=torch.bfloat16,
        profile=False, cfg=cfg)
  gc.collect()
  torch.cuda.empty_cache()
  print(f"phase 24 took {time.perf_counter() - t_phase:.1f} s")
  return bf16q, int8_bf16, bf16_serve, bf16_gshard, bf16_gshard_f32


# the hybrid's batch decode (phase 25): prompts of up to HYBRID_BUCKET
# tokens in one bucket, so that the cache of HYBRID_BUCKET +
# HYBRID_STEPS slots is a whole number of 128-slot pages and every step
# takes the flash-decode read
HYBRID_BUCKET, HYBRID_STEPS, HYBRID_CHUNK = 480, 32, 160
DECODE_LOGITS_REL = 1e-3   # x max(1, max|want|): float32 kernels against
                           # the plain versions through 12 or 24 layers
LOGIT_CAP = 50.0           # Gemma 2's attention soft-cap



def _HybridRequests(vocab):
  """8 prompts of 40..480 tokens (numpy seed 1), [8, 480] left-aligned,
  and their lengths."""
  prng = np.random.RandomState(1)
  lens = prng.permutation(np.linspace(40, HYBRID_BUCKET, 8).astype(np.int32))
  arr = np.zeros((8, HYBRID_BUCKET), np.int32)
  for i, n in enumerate(lens):
    arr[i, :n] = prng.randint(0, vocab, size=n)
  return arr, lens


def _PrefillScanInputs(torch, lm, arr, lens, j, s0):
  """The scan's inputs in the first SSM mixer of `lm` for prefill chunk j
  of the right-aligned prompts, as `GatedSSMLayer.Prefill` builds them
  (left-pad slots identity steps), with incoming state s0; and the bytes
  the scan must move."""
  block = lm.stack.body[0]
  sa = (block.x_layers[0] if hasattr(block, "x_layers") else block).self_atten
  cols = slice(j * HYBRID_CHUNK, (j + 1) * HYBRID_CHUNK)
  pad = np.arange(HYBRID_BUCKET)[None] < (HYBRID_BUCKET - lens)[:, None]
  aligned = np.zeros_like(arr)
  for i, n in enumerate(lens):
    aligned[i, HYBRID_BUCKET - n:] = arr[i, :n]
  with torch.no_grad():
    x = sa.ln.FProp(lm.emb.EmbLookup(torch.as_tensor(aligned[:, cols]).cuda()))
    dl, b_in, c_in, v, _ = sa.atten._Project(x)
    dl, v = sa.atten._MaskScanInputs(
        dl, v, torch.as_tensor(pad[:, cols].astype(np.float32)).cuda())
  x = [dl, b_in, c_in, v, s0]
  b, t, n, h = v.shape
  moved = sum(a.numel() for a in x) * 4 + (b * t * n * h + s0.numel()) * 4
  return x, moved


def _FirstLogits(torch, decoder, arr, lens, steps, tok=None):
  """The decoder's own prefill over the right-aligned prompts, then one
  ExtendStep on `tok` (default the argmax): ([B, V] logits the first
  token is drawn from, [B, V] logits of the step after, the token fed)."""
  p_len = arr.shape[1]
  init_fn, prefill_fn, _ = decoder._GetDecodeFn(p_len, steps)
  aligned = decoder._RightAlign(arr, lens, width=p_len)
  lens_dev = torch.as_tensor(np.asarray(lens)).cuda()
  slot = torch.arange(p_len + steps, device="cuda")[None]
  pads = (slot < (p_len - lens_dev)[:, None]).float()
  with torch.no_grad():
    last, states = prefill_fn(torch.as_tensor(aligned).cuda(), lens_dev,
                              init_fn(arr.shape[0]))
    tok = torch.argmax(last, dim=-1) if tok is None else tok
    nxt, _ = decoder._task.ExtendStep(tok[:, None], states,
                                      cache_paddings=pads)
  return last, nxt, tok


def _CompareDecode(torch, label, got, want, got_streams, want_streams):
  """One decode path against another: each step's logits (got / want,
  lists of [B, V]) within DECODE_LOGITS_REL x max(1, max|want|), the
  first tokens equal where want's first logits' top two are further
  apart than twice the error; the greedy streams compared, the first
  divergence printed. Returns the largest error."""
  errs = []
  for step, (g, w) in enumerate(zip(got, want)):
    err = float((g - w).abs().max())
    tol = DECODE_LOGITS_REL * max(1.0, float(w.abs().max()))
    print(f"{label} step {step} logits: max abs err {err:.3g} (tol "
          f"{tol:.3g}, max |logit| {float(w.abs().max()):.3g})")
    _Check(bool(torch.isfinite(g).all()), f"{label}: non-finite logits")
    _Check(err <= tol, f"{label} step {step} logits: {err} > {tol}")
    errs.append(err)
  top2 = torch.topk(want[0], 2, dim=-1).values
  clear = (top2[:, 0] - top2[:, 1] > 2 * errs[0]).cpu().numpy()
  firsts = [list(a)[:1] == list(b)[:1] for a, b in zip(got_streams,
                                                       want_streams)]
  _Check(all(f or not c for f, c in zip(firsts, clear)),
         f"{label}: first tokens differ where the logits are no near-tie")
  same = sum(list(a) == list(b) for a, b in zip(got_streams, want_streams))
  first = next(((i, next(j for j, (x, y) in enumerate(zip(a, b)) if x != y))
                for i, (a, b) in enumerate(zip(got_streams, want_streams))
                if list(a) != list(b)), None)
  print(f"{label}: {same} of {len(want_streams)} greedy streams equal"
        + ("" if first is None else
           f"; first divergence: row {first[0]} at token {first[1]}"))
  return max(errs)


def _HybridDecode(torch, ssd, fd, spi, attention, checkpointer, gshard,
                  counters, tmp):
  """Phase 25, part 1: DenseLmSsmHybrid through GShardDecode. Returns the
  results the kernels line reads."""
  t0 = time.perf_counter()
  _GShardTiny(torch, spi, attention, checkpointer, gshard, tmp,
              cfg=spi.DenseLmSsmHybridTiny())
  cfg = spi.DenseLmSsmHybrid()
  p = cfg.Task()
  p.atten_tpl = attention.MultiHeadedAttention.Params().Set(
      decode_page_size=128)
  lm = p.Instantiate(device="cuda")
  lm.InstantiateVariables(torch.Generator("cuda").manual_seed(0))
  ckdir = os.path.join(tmp, "hybrid")
  checkpointer.Checkpointer(ckdir).Save(1, lm, force=True)
  arr, lens = _HybridRequests(cfg.VOCAB_SIZE)
  kw = dict(max_decode_steps=HYBRID_STEPS, prefill_chunk_size=HYBRID_CHUNK,
            len_buckets=(HYBRID_BUCKET,))
  decoder = gshard.GShardDecode(lm, ckdir, os.path.join(tmp, "hybrid.jsonl"),
                                **kw)
  decoder.DecodeOnce(1, arr, lens)   # warm-up: the path's first launches
  torch.cuda.synchronize()
  counters.Zero()
  recs = decoder.DecodeOnce(1, arr, lens)
  launches = counters.Read()
  chunks = HYBRID_BUCKET // HYBRID_CHUNK
  want = dict.fromkeys(counters, 0)
  want["ssd_scan"] = 10 * chunks
  want["flash_decode"] = 2 * HYBRID_STEPS
  _Check(launches == want, f"hybrid GShardDecode launches {launches} != "
         f"{want}")
  tel = recs[0]["telemetry"]
  total = HYBRID_BUCKET + HYBRID_STEPS
  ssm_bytes = 10 * cfg.MODEL_DIM * cfg.SSM_STATE_DIM * 4
  kv_bytes = 2 * 2 * cfg.MODEL_DIM * 4 * total
  _Check(tel["decode_state_bytes_per_seq"] == ssm_bytes + kv_bytes,
         f"hybrid decode_state_bytes_per_seq {tel['decode_state_bytes_per_seq']}"
         f" != {ssm_bytes} + {kv_bytes}")
  _Check((tel["kv_cache_dtype"], tel["kv_bytes_per_token"]) == (
      "float32", 2 * 2 * cfg.MODEL_DIM * 4), f"hybrid KV census {tel}")
  dense = spi.DenseLm1B()
  dense_bytes = 2 * dense.NUM_LAYERS * dense.MODEL_DIM * 4 * total
  print(f"DenseLmSsmHybrid GShardDecode (decode_page_size 128): 8 prompts "
        f"of {sorted(lens.tolist())} tokens (bucket {HYBRID_BUCKET}) x "
        f"{HYBRID_STEPS} tokens, prefill chunks of {HYBRID_CHUNK}: prefill_s "
        f"{tel['prefill_s']:.3f}, decode_s {tel['decode_s']:.3f} "
        f"({tel['decode_s'] / HYBRID_STEPS * 1e3:.2f} ms per step), "
        f"{tel['tokens_per_sec']:.1f} tokens/s; launches "
        f"{ {k: v for k, v in launches.items() if v} } = 10 x {chunks} "
        f"chunks + 2 x {HYBRID_STEPS} steps; decode_state_bytes_per_seq "
        f"{tel['decode_state_bytes_per_seq']} ({ssm_bytes} of SSM states, "
        f"{kv_bytes} of KV at {total} slots) against DenseLm1B's "
        f"{dense_bytes} at the same length "
        f"({dense_bytes / tel['decode_state_bytes_per_seq']:.1f}x)")
  # the scan at the path's shapes: layer 0's first and second chunk, the
  # second from the first's carried state
  s0 = torch.zeros((8, cfg.NUM_HEADS, cfg.MODEL_DIM // cfg.NUM_HEADS,
                    cfg.SSM_STATE_DIM), device="cuda")
  scans = []
  for j in (0, 1):
    x, moved = _PrefillScanInputs(torch, lm, arr, lens, j, s0)
    scans.append(_CheckScan(torch, ssd, f"decode prefill chunk {j + 1}", x,
                            moved, chunk=cfg.SSM_CHUNK_SIZE))
    with torch.no_grad():
      s0 = ssd.SsdScan(*x, chunk_size=cfg.SSM_CHUNK_SIZE)[1]
    del x
  fdec = _CheckFlashDecode(torch, fd, np.random.RandomState(25), lens,
                           s=total, h=cfg.MODEL_DIM // cfg.NUM_HEADS,
                           p_len=HYBRID_BUCKET, ts=(total - 1, total - 22))
  # the plain versions: the chunked plain scan and the dense cache read
  pp = cfg.Task()
  pp.mixer_tpl.scan_lowering = "chunked"
  plain = pp.Instantiate(device="cuda")
  plain.load_state_dict(lm.state_dict())
  plain_decoder = gshard.GShardDecode(
      plain, ckdir, os.path.join(tmp, "hybrid_plain.jsonl"), **kw)
  counters.Zero()
  plain_recs = plain_decoder.DecodeOnce(1, arr, lens)
  _Check(not any(counters.Read().values()), f"plain hybrid decode launched "
         f"{counters.Read()}")
  got = _FirstLogits(torch, decoder, arr, lens, HYBRID_STEPS)
  ref = _FirstLogits(torch, plain_decoder, arr, lens, HYBRID_STEPS,
                     tok=got[2])
  err = _CompareDecode(torch, "hybrid decode, kernels against plain",
                       got[:2], ref[:2],
                       [r["output_ids"] for r in recs],
                       [r["output_ids"] for r in plain_recs])
  del lm, plain, decoder, plain_decoder
  gc.collect()
  torch.cuda.empty_cache()
  print(f"phase 25 hybrid decode: {time.perf_counter() - t0:.1f} s")
  return dict(launches=launches, scans=scans, fdec=fdec, logits_err=err,
              tel=tel)


def _PureSsmDecode(torch, spi, checkpointer, gshard, counters, tmp):
  """Phase 25, part 2: a pure-SSM stack at the hybrid's widths, 4 layers,
  through GShardDecode at two decode lengths: one scan launch per layer
  and prefill chunk, nothing else, and the same decode state per
  sequence at both lengths. Returns {steps: (launches, telemetry)}."""
  cfg = spi.DenseLmSsmHybrid()
  lm = cfg.Task().Set(mixer_atten_every_n=0, num_layers=4).Instantiate(
      device="cuda")
  lm.InstantiateVariables(torch.Generator("cuda").manual_seed(0))
  ckdir = os.path.join(tmp, "pure_ssm")
  checkpointer.Checkpointer(ckdir).Save(1, lm, force=True)
  arr, lens = _HybridRequests(cfg.VOCAB_SIZE)
  chunks = HYBRID_BUCKET // HYBRID_CHUNK
  want = dict.fromkeys(counters, 0)
  want["ssd_scan"] = 4 * chunks
  out = {}
  for steps in (16, 64):
    decoder = gshard.GShardDecode(
        lm, ckdir, os.path.join(tmp, "pure_ssm.jsonl"),
        max_decode_steps=steps, prefill_chunk_size=HYBRID_CHUNK,
        len_buckets=(HYBRID_BUCKET,))
    torch.cuda.synchronize()
    counters.Zero()
    recs = decoder.DecodeOnce(1, arr, lens)
    launches = counters.Read()
    _Check(launches == want, f"pure-SSM GShardDecode launches {launches} "
           f"!= {want}")
    tel = recs[0]["telemetry"]
    _Check((tel["kv_cache_dtype"], tel["kv_bytes_per_token"]) == (None, 0),
           f"pure-SSM KV census {tel['kv_cache_dtype']}, "
           f"{tel['kv_bytes_per_token']}")
    for r in recs:
      _Check(len(r["output_ids"]) == steps and all(
          0 <= x < cfg.VOCAB_SIZE for x in r["output_ids"]),
             f"bad continuation {r['output_ids']}")
    out[steps] = (launches, tel)
    print(f"pure-SSM stack (4 layers, d {cfg.MODEL_DIM}) GShardDecode, "
          f"{steps} steps: prefill_s {tel['prefill_s']:.3f}, decode_s "
          f"{tel['decode_s']:.3f} ({tel['decode_s'] / steps * 1e3:.2f} ms "
          f"per step), launches { {k: v for k, v in launches.items() if v} }"
          f", decode_state_bytes_per_seq {tel['decode_state_bytes_per_seq']}")
  per_seq = {s: t["decode_state_bytes_per_seq"] for s, (_, t) in out.items()}
  state = 4 * cfg.MODEL_DIM * cfg.SSM_STATE_DIM * 4
  _Check(set(per_seq.values()) == {state}, f"pure-SSM decode state per "
         f"sequence {per_seq}: not {state} at every length")
  del lm
  gc.collect()
  torch.cuda.empty_cache()
  return out


def _ServeSmall(torch, eng, counters, prompts, max_new):
  """Greedy RunBatch of `prompts` (equal lengths) after a warm-up, every
  kernel count set to 0 just before. Returns (streams, launches, steps,
  decode-only steps, fallback steps, ms per step)."""
  eng.RunBatch(prompts[:1, :8], [8], max_new_tokens=2)   # warm-up
  stats0 = eng.Stats()
  torch.cuda.synchronize()
  counters.Zero()
  t0 = time.perf_counter()
  out = eng.RunBatch(prompts, [prompts.shape[1]] * len(prompts),
                     max_new_tokens=max_new)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  stats = eng.Stats()
  steps, decode, dense = (stats[k] - stats0[k] for k in (
      "steps", "decode_steps", "dense_fallback_steps"))
  return out, counters.Read(), steps, decode, dense, wall / steps * 1e3


def _DenseFallback(torch, spi, engine, attention, gshard, counters, tmp):
  """Phase 25, part 3: DenseLm1B with a logit cap through ServingLoop in
  both step modes (the gather-dense fallback), beside the same weights
  uncapped (the kernels) in one process, and against GShardDecode of the
  capped task; then head dim 96 in the legacy step on the card. Returns
  {(mode, capped): (launches, steps, ms per step)}."""
  from lingvo_tpu_torch.core import ragged
  from lingvo_tpu_torch.core import threefry
  cfg = spi.DenseLm1B()
  lm = _ServingLm(torch, cfg)
  pc = cfg.Task()
  pc.atten_tpl = attention.MultiHeadedAttention.Params().Set(
      atten_logit_cap=LOGIT_CAP)
  capped = pc.Instantiate(device="cuda")
  capped.load_state_dict(lm.state_dict())
  prompts = np.random.RandomState(2).randint(
      0, cfg.VOCAB_SIZE, size=(4, 64)).astype(np.int32)
  max_new = 16
  kw = dict(page_size=16, num_pages=64, max_batch=4, max_seq_len=128,
            prefill_chunk=64)
  res, streams = {}, {}
  for mode in ("ragged", "legacy"):
    for is_capped, model in ((False, lm), (True, capped)):
      eng = engine.ServingLoop(model, step_mode=mode, **kw)
      out, launches, steps, decode, dense, ms = _ServeSmall(
          torch, eng, counters, prompts, max_new)
      want = dict.fromkeys(counters, 0)
      if is_capped:
        _Check(eng.paged_path == "dense" and dense == steps, f"capped "
               f"{mode} engine: paged_path {eng.paged_path}, "
               f"dense_fallback_steps {dense} of {steps} steps")
      elif mode == "ragged":
        want["ragged_block_attend"] = 24 * steps
      else:
        want["block_decode"] = 24 * decode
      _Check(launches == want, f"{mode} engine (capped {is_capped}): "
             f"launches {launches} != {want}")
      res[mode, is_capped] = (launches, steps, ms)
      if is_capped:
        streams[mode] = out
      print(f"DenseLm1B {'capped ' if is_capped else ''}{mode} engine "
            f"(paged_path {eng.paged_path}): 4 x 64-token prompts, "
            f"{max_new} new tokens: {steps} steps ({decode} decode-only), "
            f"{ms:.2f} ms/step, dense_fallback_steps {dense}, launches "
            f"{ {k: v for k, v in launches.items() if v} }")
      del eng
  _Check(np.array_equal(streams["ragged"], streams["legacy"]),
         "capped DenseLm1B: the ragged and legacy engines' streams differ")
  for mode in ("ragged", "legacy"):
    print(f"DenseLm1B {mode} step in this process: the gather-dense "
          f"fallback {res[mode, True][2]:.2f} ms/step against the kernels' "
          f"{res[mode, False][2]:.2f} ms/step")
  # GShardDecode of the capped task (its ExtendStep takes the dense read)
  # through its own phase functions, and the ragged step's first logits
  decoder = gshard.GShardDecode(capped, tmp, os.path.join(tmp, "cap.jsonl"),
                                max_decode_steps=max_new)
  init_fn, prefill_fn, sample_fn = decoder._GetDecodeFn(64, max_new)
  lens_dev = torch.full((4,), 64, dtype=torch.int32, device="cuda")
  with torch.no_grad():
    last, states = prefill_fn(torch.as_tensor(prompts).cuda(), lens_dev,
                              init_fn(4))
    ref = sample_fn(last, lens_dev, threefry.PRNGKey(0), states).cpu().numpy()
    del states
    rows = ragged.BuildRaggedRows([64] * 4, [0] * 4, 256, 64)
    pstates = capped.InitPagedDecodeState(33, 16, 4)
    tables = torch.arange(32, dtype=torch.int32, device="cuda").reshape(4, 8)
    ids = torch.as_tensor(prompts.reshape(1, -1)).cuda()
    logits, _ = capped.RaggedStep(ids, pstates, tables,
                                  ragged.ToTorch(rows, "cuda"))
    got = logits[0, 63::64]
    del pstates
  _CompareDecode(torch, "capped DenseLm1B, ragged fallback against "
                 "GShardDecode", [got], [last], streams["ragged"], ref)
  del lm, capped, decoder, last, logits
  gc.collect()
  torch.cuda.empty_cache()
  # head dim 96 (outside block_decode.HEAD_DIMS): the legacy step takes
  # the fallback on the card, the block-decode read on the CPU
  p96 = spi.DenseLmTiny().Task().Set(model_dim=192, num_heads=2,
                                     hidden_dim=384)
  cpu_lm = p96.Instantiate(device="cpu")
  cpu_lm.InstantiateVariables(torch.Generator("cpu").manual_seed(1))
  gpu_lm = p96.Instantiate(device="cuda")
  gpu_lm.load_state_dict(cpu_lm.state_dict())
  rng = np.random.RandomState(4)
  tiny = rng.randint(1, 128, size=(6, 12)).astype(np.int32)
  kw96 = dict(page_size=8, num_pages=32, max_batch=4, max_seq_len=64,
              prefill_chunk=8, step_mode="legacy")
  cpu_eng = engine.ServingLoop(cpu_lm, device="cpu", **kw96)
  want96 = cpu_eng.RunBatch(tiny, [12] * 6, max_new_tokens=8)
  eng = engine.ServingLoop(gpu_lm, **kw96)
  got96, launches, steps, _, dense, _ = _ServeSmall(torch, eng, counters,
                                                    tiny, 8)
  _Check(eng.paged_path == "dense" and cpu_eng.paged_path == "plain",
         f"head dim 96: paged_path {eng.paged_path} on the card, "
         f"{cpu_eng.paged_path} on the CPU")
  _Check(dense == steps and not any(launches.values()),
         f"head dim 96: dense_fallback_steps {dense} of {steps}, launches "
         f"{launches}")
  _Check(np.array_equal(got96, want96), f"head dim 96: the card's "
         f"fallback streams differ from the CPU's:\n{got96}\n{want96}")
  ragged96 = engine.ServingLoop(gpu_lm, **dict(kw96, step_mode="ragged"))
  print(f"head dim 96, legacy step: paged_path {eng.paged_path} on the card "
        f"({steps} steps, all counted in dense_fallback_steps, no kernel "
        f"launched), 6 greedy streams of 8 tokens identical to the CPU "
        f"engine's block-decode read; the ragged engine at head dim 96 "
        f"takes {ragged96.paged_path}")
  return res


def _SsmDecodePhase(torch, ssd, fd, spi, engine, attention, checkpointer,
                    gshard, counters):
  """Phase 25 (see the module docstring). Returns (the hybrid decode's
  results, the pure-SSM runs, the fallback's serving runs)."""
  t_phase = time.perf_counter()
  with tempfile.TemporaryDirectory() as tmp:
    hybrid = _HybridDecode(torch, ssd, fd, spi, attention, checkpointer,
                           gshard, counters, tmp)
    pure = _PureSsmDecode(torch, spi, checkpointer, gshard, counters, tmp)
    print(f"phase 25: SSM decode took {time.perf_counter() - t_phase:.1f} s")
    fallback = _DenseFallback(torch, spi, engine, attention, gshard,
                              counters, tmp)
  gc.collect()
  torch.cuda.empty_cache()
  print(f"phase 25 took {time.perf_counter() - t_phase:.1f} s")
  return hybrid, pure, fallback



# -- phase 26: the trainer CLI -----------------------------------------------------


W793K = "lm.synthetic_packed_input.DenseLmWord793k"


def _StepBusy(torch, step, shares=(("fused xent", ("fusedxent",)),)):
  """One call of step() under torch.profiler, device activity only (a
  step of thousands of small ops makes the host-side records costly):
  device busy ms against the wall, the GEMMs' share of busy and each of
  `shares` ((label, kernel name keys)), the top 5 kernels. Returns (busy
  ms, wall ms, {label: share}), or None when the profiler recorded no
  device time."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  kernels = sorted((e for e in prof.key_averages() if _DevUs(e) > 0),
                   key=_DevUs, reverse=True)
  busy_ms = sum(_DevUs(e) for e in kernels) / 1e3
  if busy_ms == 0:
    print("profiled step: the profiler recorded no device time")
    return None
  share = lambda *keys: sum(_DevUs(e) for e in kernels if any(
      k in e.key.lower() for k in keys)) / 1e3 / busy_ms
  got = {label: share(*keys) for label, keys in shares}
  print(f"profiled one train step: device busy {busy_ms:.1f} ms of "
        f"{wall_ms:.1f} ms wall ({busy_ms / wall_ms:.1%}); GEMMs "
        f"{share('gemm', 'cutlass', 'nvjet'):.1%}, "
        + ", ".join(f"{label} {v:.1%}" for label, v in got.items())
        + f" of busy; {sum(e.count for e in kernels)} kernels")
  for e in kernels[:5]:
    print(f"  {_DevUs(e) / 1e3:9.2f} ms  {e.count:6d} x  {e.key[:90]}")
  return busy_ms, wall_ms, got


def _CliWord793k(torch, spi, trainer, executor, program, counters, tmp):
  """trainer.main on DenseLmWord793k as registered (20 steps a loop, 125
  eval batches of 8), --max_steps=20, on the card, with the kernel counts
  set to 0 just before: FINISHED holds 20, metrics.jsonl has finite train
  and eval_test losses, and the xent kernel launched exactly 20 + 125
  times, nothing else. Then one more train step of the same task under
  torch.profiler (its device busy share). Returns the launches."""
  import shutil
  from lingvo_tpu_torch.core import checkpointer
  logdir = os.path.join(tmp, "w793k")
  free = shutil.disk_usage(tmp).free
  print(f"logdir {logdir}: {free / 2**30:.1f} GiB free")
  captured, eval_s = [], []
  start, run = executor.ExecutorTpu.Start, program.EvalProgram.Run
  save_async = checkpointer.Checkpointer.SaveAsync

  def _SaveAsync(ckpt, step, *args, **kwargs):
    return False if step == 0 else save_async(ckpt, step, *args, **kwargs)

  def _Start(ex):
    captured.append(ex)
    captured.append(start(ex))
    return captured[-1]

  def _EvalRun(prog, state):
    t0 = time.perf_counter()
    out = run(prog, state)
    torch.cuda.synchronize()
    eval_s.append(time.perf_counter() - t0)
    return out

  executor.ExecutorTpu.Start, program.EvalProgram.Run = _Start, _EvalRun
  checkpointer.Checkpointer.SaveAsync = _SaveAsync
  try:
    torch.cuda.synchronize()
    counters.Zero()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = trainer.main([f"--model={W793K}", f"--logdir={logdir}",
                       "--mode=train", "--max_steps=20"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.Read()
  finally:
    executor.ExecutorTpu.Start, program.EvalProgram.Run = start, run
    checkpointer.Checkpointer.SaveAsync = save_async
  peak = torch.cuda.max_memory_allocated()
  with open(os.path.join(logdir, "train", "FINISHED")) as f:
    finished = f.read()
  with open(os.path.join(logdir, "metrics.jsonl")) as f:
    rows = [json.loads(line) for line in f]
  _Check(rc == 0 and finished == "20", f"rc {rc}, FINISHED {finished!r}")
  _Check([r["step"] for r in rows] == [20] and all(
      np.isfinite(rows[0][k]["loss"]) for k in ("train", "eval_test")),
         f"metrics.jsonl rows {rows}")
  want = dict.fromkeys(counters, 0)
  want["fused_xent_fwd"] = 20 + 125
  _Check(launches == want, f"launches {launches} != {want}")
  ex, state = captured
  train = rows[0]["train"]
  task = ex.task
  print(f"DenseLmWord793k through trainer.main: "
        f"{sum(x.numel() for x in task.parameters()):,} params, {wall:.1f} s "
        f"in all; the loop of 20 steps {1e3 / train['steps_per_second']:.1f}"
        f" ms/step from its dispatch to its end ({train['host_overhead_s']:.2f}"
        f" s of host dispatch), loss {train['loss']:.4f}, grad_norm "
        f"{train['grad_norm']:.4f}; eval_test (125 batches) {eval_s[0]:.2f} "
        f"s, loss {rows[0]['eval_test']['loss']:.4f}; peak memory "
        f"{peak / 2**30:.2f} GiB")
  for w in ex.checkpointer.writes:
    print(f"checkpoint step {w['step']}: {w['bytes'] / 2**30:.2f} GiB, "
          f"snapshot {w['snapshot_s']:.2f} s on the caller, write "
          f"{w['write_s']:.2f} s ({w['bytes'] / w['write_s'] / 2**30:.2f} "
          f"GiB/s)")
  print(f"launches in the CLI run: {launches} (a stats forward each train "
        "step and eval batch)")
  prog = program.TrainProgram(
      program.TrainProgram.Params().Set(steps_per_loop=1,
                                        async_infeed=False),
      task=task, input_generator=spi.DenseLmWord793k().Train().Instantiate())
  t0 = time.perf_counter()
  _StepBusy(torch, lambda: prog.Run(state))
  print(f"the profiled step took {time.perf_counter() - t0:.1f} s with the "
        "profiler's own work")
  # the runtime's own loop again, with no save in flight: its first Run
  # blocks for its own result
  steady = program.TrainProgram(
      program.TrainProgram.Params().Set(steps_per_loop=3), task=task,
      input_generator=spi.DenseLmWord793k().Train().Instantiate())
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  _, out = steady.Run(state)
  torch.cuda.synchronize()
  steady_ms = (time.perf_counter() - t0) / 3 * 1e3
  steady.Shutdown()
  print(f"3 more steps through the default (async) TrainProgram, no save "
        f"in flight: {steady_ms:.1f} ms/step ({out['host_overhead_s']:.2f} s"
        f" of host dispatch for the 3)")
  del captured, ex, task, prog, steady, state
  shutil.rmtree(logdir)
  gc.collect()
  torch.cuda.empty_cache()
  return launches, dict(ms_step=1e3 / train["steps_per_second"],
                        steady_ms_step=steady_ms, eval_s=eval_s[0],
                        peak=peak, wall=wall)


def _TinyCliRuns(trainer, key, logdir, device):
  """Train to 8 steps, resume to 16, then --mode=eval, all through the
  CLI: (train losses by step, eval losses by step, the last eval)."""
  common = [f"--model={key}", f"--logdir={logdir}", f"--device={device}"]
  for steps in (8, 16):
    _Check(trainer.main(common + [f"--max_steps={steps}"]) == 0,
           f"{device}: train to {steps}")
  _Check(trainer.main(common + ["--mode=eval"]) == 0, f"{device}: eval")
  with open(os.path.join(logdir, "metrics.jsonl")) as f:
    rows = [json.loads(line) for line in f]
  with open(os.path.join(logdir, "eval_test", "summaries.jsonl")) as f:
    evals = [json.loads(line) for line in f]
  train = {r["step"]: r["train"]["loss"] for r in rows}
  return train, [e["loss"] for e in evals]


def _CliTiny(torch, spi, trainer, model_registry, counters, tmp, base=None,
             launched=()):
  """`base`'s (default DenseLmTiny's) shapes and recipe through the CLI on
  the card and on the CPU (4 steps a loop and 32 eval samples, so that 8
  and 16 end loops): train to 8, resume to 16, eval the last checkpoint;
  each loop's loss and each eval loss within 1e-4 of the CPU's. The
  card's run launches each kernel of `launched` and no other (DenseLmTiny
  none: flash is off and the head is dense)."""
  base = base or spi.DenseLmTiny

  def _Task(self):
    p = base.Task(self)
    p.train.tpu_steps_per_loop = 4
    p.eval.samples_per_summary = 32
    return p

  name = f"{base.__name__}Loop4"
  key = model_registry.RegisterSingleTaskModel(
      type(name, (base,), {"Task": _Task}))._registry_key
  counters.Zero()
  got = _TinyCliRuns(trainer, key, os.path.join(tmp, f"{name}_cuda"), "cuda")
  launches = counters.Read()
  want = _TinyCliRuns(trainer, key, os.path.join(tmp, f"{name}_cpu"), "cpu")
  _Check(all((v > 0) == (k in launched) for k, v in launches.items()),
         f"{name}: launches {launches}, want only {launched}")
  _Check(sorted(got[0]) == sorted(want[0]) == [4, 8, 12, 16],
         f"{name}: train rows {got[0]} vs {want[0]}")
  err = max([abs(got[0][s] - want[0][s]) for s in want[0]] +
            [abs(a - b) for a, b in zip(got[1], want[1])])
  _Check(len(got[1]) == len(want[1]) == 5 and err <= 1e-4,
         f"{name}: card {got} vs CPU {want}, max err {err}")
  print(f"{name} (4 steps a loop) through the CLI, card vs CPU: train "
        f"to 8, resume to 16, eval: train losses {got[0]}, eval losses "
        f"{got[1]}; max |card - CPU| {err:.3g} (tol 1e-4); launches "
        f"{ {k: v for k, v in launches.items() if v} or 'none'}")
  return err


def _CliPhase(torch, fx, spi, counters):
  """Phase 26 (see the module docstring). Returns (the xent check at
  DenseLmWord793k's shape, the CLI run's launches and times)."""
  from lingvo_tpu_torch import model_registry
  from lingvo_tpu_torch import trainer
  from lingvo_tpu_torch.runners import executor
  from lingvo_tpu_torch.runners import program
  t_phase = time.perf_counter()
  geo = fx.StatsGeometry(2048, 793_600, torch.cuda.get_device_properties(
      0).multi_processor_count)
  print(f"row tiles x splits {geo['row_tiles']} x {geo['splits']} "
        f"({geo['tiles_per_split']} tiles of {geo['tile']} a split), "
        f"partials {5 * geo['splits'] * 2048 * 4 / 2**20:.1f} MiB; "
        "library: none")
  xent = _CheckXent(torch, fx, np.random.RandomState(26), 1024, 0.0, True,
                    m=2048, vocab=793_600, d=1024, table_seed=26)
  gc.collect()
  torch.cuda.empty_cache()
  print(f"phase 26: the kernel check took {time.perf_counter() - t_phase:.1f}"
        " s")
  with tempfile.TemporaryDirectory() as tmp:
    launches, cli = _CliWord793k(torch, spi, trainer, executor, program,
                                 counters, tmp)
    print(f"phase 26: DenseLmWord793k took "
          f"{time.perf_counter() - t_phase:.1f} s")
    cli["tiny_err"] = _CliTiny(torch, spi, trainer, model_registry, counters,
                               tmp)
  print(f"phase 26 took {time.perf_counter() - t_phase:.1f} s")
  return xent, dict(cli, launches=launches)


# -- phase 27: the hybrid's training ------------------------------------------


HYBRID_KEY = "lm.synthetic_packed_input.DenseLmSsmHybrid"
# the scan's backward kernel against `_PlainScanBwd`: each gradient's max
# |error| over its max |plain|. float32: the two sum the chunk products,
# the reverse state and d decay_log's row and column sums in other orders
SCAN_BWD_TOL = 1e-4
SCAN_SHARES = (("scan forward", ("ssdscankernel",)),
               ("scan backward", ("ssdscanbwd",)))


def _ScanBwdFlops(t, q, s_dim, h):
  """Operations one row's scan backward needs over t steps in chunks of
  q: per chunk of qc steps, the two state sweeps (each chunk's S_in
  recomputed, dS carried back), dy S_in, b dS_out^T and v dS_out, 2 qc S
  H each, and the causal lower triangle (diagonal included) of the five
  qc x qc products (c b^T, dy v^T, (G o L) b, (scores o L)^T dy and (G o
  L)^T c), qc (qc + 1) / 2 (3 S + 2 H) FMAs. Nothing is skipped: an
  identity chunk still passes dS and gives dc."""
  total = 0
  for start in range(0, t, q):
    qc = min(q, t - start)
    total += 2 * (5 * qc * s_dim * h
                  + qc * (qc + 1) // 2 * (3 * s_dim + 2 * h))
  return total


def _PackedScan(torch, ssm, rng, with_s0):
  """The scan's inputs at the hybrid's training shape ([8, 1024, 16], S =
  H = 64) as `GatedSSMLayer._MaskScanInputs` builds them from a packed
  batch: in row r segments start at 0, 300 + 17 r and 700 + 9 r (resets),
  and its last 64 + 8 r steps are padding. A random cotangent of y;
  with_s0: a nonzero s0 and a cotangent of s_final. Returns ([dl, b, c,
  v, s0, dy, ds_fin] on the card, the bytes the backward must move: each
  input read once, each gradient written once)."""
  b, t, n, s, h = 8, 1024, 16, 64, 64
  cuda = lambda a: torch.as_tensor(np.asarray(a, np.float32)).cuda()
  dl = cuda(-np.logaddexp(rng.randn(b, t, n), 0.0))
  b_in, c_in = (cuda(0.5 * rng.randn(b, t, n, s)) for _ in range(2))
  v = cuda(0.5 * rng.randn(b, t, n, h))
  dy = cuda(rng.randn(b, t, n, h))
  seg = np.ones((b, t), np.int32)
  pad = np.zeros((b, t), np.float32)
  for r in range(b):
    seg[r, 300 + 17 * r:] = 2
    seg[r, 700 + 9 * r:] = 3
    pad[r, t - 64 - 8 * r:] = 1.0
    seg[r, t - 64 - 8 * r:] = 0
  dl, v = ssm.GatedSSMLayer._MaskScanInputs(
      dl, v, cuda(pad), torch.as_tensor(seg).cuda())
  s0 = cuda(0.2 * rng.randn(b, n, h, s)) if with_s0 else None
  ds_fin = cuda(0.5 * rng.randn(b, n, h, s)) if with_s0 else None
  x = [dl, b_in, c_in, v, s0, dy, ds_fin]
  read = sum(a.numel() for a in x if a is not None)
  written = sum(a.numel() for a in (dl, b_in, c_in, v, s0) if a is not None)
  return x, (read + written) * 4


def _CheckScanBwd(torch, ssd, ssm, label, rng, with_s0, time_it):
  """The backward kernel against `_PlainScanBwd` on the card at the
  training shape (`_PackedScan`): every gradient finite and within
  SCAN_BWD_TOL, two calls bitwise equal; with time_it, the kernel's and
  the plain version's times beside the bound."""
  x, moved = _PackedScan(torch, ssm, rng, with_s0)
  args = (*x, 64)
  got = ssd._CudaScanBwd(*args)
  again = ssd._CudaScanBwd(*args)
  want = ssd._PlainScanBwd(*args)
  torch.cuda.synchronize()
  _Check(all(torch.equal(a, b) for a, b in zip(got, again) if a is not None),
         f"scan backward {label}: two calls differ bitwise")
  errs, rels = [], []
  for name, g, w in zip(("d decay_log", "d b_in", "d c_in", "d v", "d s0"),
                        got, want):
    if w is None:
      _Check(g is None, f"scan backward {label}: {name} without s0")
      continue
    _Check(bool(torch.isfinite(g).all()),
           f"scan backward {label} {name}: non-finite")
    err, top = float((g - w).abs().max()), float(w.abs().max())
    rel = err / top if top > 0 else err
    print(f"scan backward {label} {name}: max |err| {err:.3g} / max |plain| "
          f"{top:.3g} = {rel:.3g} (tol {SCAN_BWD_TOL})")
    _Check(rel <= SCAN_BWD_TOL, f"scan backward {label} {name}: {rel} > "
           f"{SCAN_BWD_TOL}")
    errs.append(err)
    rels.append(rel)
  del got, again, want
  geo = ssd.BwdGeometry(1024, 64, 64, 64)
  print(f"scan backward {label}: two calls bitwise equal; {geo['chunks']} "
        f"chunks of {geo['q']} a row; sweep kernel {2 * 128 * 2} blocks "
        "(each way, 128 rows, 2 slices of 32 state rows) of 128 threads, "
        f"{geo['sweep_smem']} B shared, {geo['sweep_regs']} registers, "
        f"{geo['sweep_local']} B local; chunk kernel {128 * geo['chunks']} "
        f"blocks of 256 threads, {geo['chunk_smem']} B shared (tiles "
        f"{'staged' if geo['full'] else 'read from device memory'}), "
        f"{geo['chunk_regs']} registers, {geo['chunk_local']} B local, "
        f"{geo['per_sm']} blocks resident per SM")
  res = dict(err=max(errs), rel=max(rels), geometry=geo)
  if time_it:
    ms = _TimeMs(torch, lambda: ssd._CudaScanBwd(*args), 20)
    plain_ms = _TimeMs(torch, lambda: ssd._PlainScanBwd(*args), 3,
                       waits_as="plain scan backward")
    flops = _ScanBwdFlops(1024, 64, 64, 64) * 8 * 16
    bound = _Bound(moved, flops)
    print(f"scan backward {label} [8, 1024, 16] S=64 H=64 chunk 64: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound[0]:.4f} ms "
          f"({bound[1]}; {flops / 1e9:.3f} GFLOP, {moved / 1e6:.1f} MB; "
          f"{_BoundShare(ms, bound[0])})")
    res.update(ms=ms, plain_ms=plain_ms, bound=bound)
  return res


def _CliHybrid(torch, spi, trainer, executor, program, counters, tmp):
  """trainer.main on DenseLmSsmHybrid as registered (remat 'full', 20
  steps a loop, 125 eval batches of 8), --max_steps=20, on the card, with
  the kernel counts set to 0 just before: FINISHED holds 20,
  metrics.jsonl has finite train and eval_test losses, and the scan
  kernels launched exactly 10 x (2 x 20 + 125) forward (remat 'full'
  runs each mixer's forward again in the backward) and 10 x 20 backward,
  nothing else. Then one more train step of the same task under
  torch.profiler. Returns (the launches, the run's numbers)."""
  import shutil
  cfg = spi.DenseLmSsmHybrid()
  logdir = os.path.join(tmp, "hybrid")
  captured, start = [], executor.ExecutorTpu.Start

  def _Start(ex):
    captured.append(ex)
    captured.append(start(ex))
    return captured[-1]

  executor.ExecutorTpu.Start = _Start
  try:
    torch.cuda.synchronize()
    counters.Zero()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = trainer.main([f"--model={HYBRID_KEY}", f"--logdir={logdir}",
                       "--mode=train", "--max_steps=20"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.Read()
  finally:
    executor.ExecutorTpu.Start = start
  peak = torch.cuda.max_memory_allocated()
  with open(os.path.join(logdir, "train", "FINISHED")) as f:
    finished = f.read()
  with open(os.path.join(logdir, "metrics.jsonl")) as f:
    rows = [json.loads(line) for line in f]
  _Check(rc == 0 and finished == "20", f"rc {rc}, FINISHED {finished!r}")
  _Check([r["step"] for r in rows] == [20] and all(
      np.isfinite(rows[0][k]["loss"]) for k in ("train", "eval_test")),
         f"metrics.jsonl rows {rows}")
  want = dict.fromkeys(counters, 0)
  want["ssd_scan"] = 10 * (2 * 20 + 125)
  want["ssd_scan_bwd"] = 10 * 20
  _Check(launches == want, f"launches {launches} != {want}")
  ex, state = captured
  task, train = ex.task, rows[0]["train"]
  ms = 1e3 / train["steps_per_second"]
  tokens = cfg.BATCH_SIZE * cfg.SEQUENCE_LENGTH
  print(f"DenseLmSsmHybrid through trainer.main: "
        f"{sum(x.numel() for x in task.parameters()):,} params, remat "
        f"{task.p.remat_policy!r}, {wall:.1f} s in all; the loop of 20 "
        f"steps {ms:.1f} ms/step from its dispatch to its end "
        f"({tokens / ms * 1e3:.0f} tokens/s, {train['host_overhead_s']:.2f}"
        f" s of host dispatch), loss {train['loss']:.4f}, grad_norm "
        f"{train['grad_norm']:.4f}, skipped {train['skipped_step']}; "
        f"eval_test (125 batches) loss {rows[0]['eval_test']['loss']:.4f}; "
        f"peak memory {peak / 2**30:.2f} GiB")
  print(f"launches in the CLI run: {launches} (a train step: 10 scans "
        "forward, 10 again in remat's recompute, 10 backward; an eval "
        "batch: 10 forward)")
  prog = program.TrainProgram(
      program.TrainProgram.Params().Set(steps_per_loop=1,
                                        async_infeed=False),
      task=task, input_generator=cfg.Train().Instantiate())
  t0 = time.perf_counter()
  busy = _StepBusy(torch, lambda: prog.Run(state), shares=SCAN_SHARES)
  print(f"the profiled step took {time.perf_counter() - t0:.1f} s with the "
        "profiler's own work")
  del captured, ex, task, prog, state
  shutil.rmtree(logdir)
  gc.collect()
  torch.cuda.empty_cache()
  return launches, dict(ms_step=ms, tokens_s=tokens / ms * 1e3, peak=peak,
                        wall=wall, busy=busy, loss=train["loss"])


def _HybridBf16(torch, spi, program, engine, ragged, attention, checkpointer,
                gshard, counters, tmp):
  """The bfloat16 half: one DenseLmSsmHybrid train step at fprop_dtype=
  bfloat16 (finite loss and grad_norm, no skipped step, 20 + 10 scan
  launches); the tiny twin on the card against the CPU (`_TinyBf16`);
  the full-width bf16 hybrid through ServingLoop (ragged, 8 requests, 8
  new tokens each) and GShardDecode (phase 25's requests and geometry),
  with exact launch counts. Returns what the phase prints."""
  cfg = spi.DenseLmSsmHybrid()
  bf16 = torch.bfloat16
  lm = cfg.Task().Set(fprop_dtype=bf16).Instantiate(device="cuda")
  state = lm.CreateTrainState(torch.Generator("cuda").manual_seed(0))
  prog = program.TrainProgram(
      program.TrainProgram.Params().Set(steps_per_loop=1,
                                        async_infeed=False),
      task=lm, input_generator=cfg.Train().Instantiate())
  torch.cuda.synchronize()
  counters.Zero()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  _, out = prog.Run(state)
  torch.cuda.synchronize()
  step_s = time.perf_counter() - t0
  launches = counters.Read()
  _Check(np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"])
         and out["skipped_step"] == 0, f"bf16 hybrid step: {out}")
  want = dict.fromkeys(counters, 0)
  want.update(ssd_scan=20, ssd_scan_bwd=10)
  _Check(launches == want, f"bf16 hybrid step: launches {launches} != "
         f"{want}")
  print(f"DenseLmSsmHybrid at fprop_dtype=bfloat16, one train step (the "
        f"task's first, warm-up included): {step_s:.2f} s, loss "
        f"{out['loss']:.4f}, grad_norm {out['grad_norm']:.4f}, skipped "
        f"{out['skipped_step']}, launches "
        f"{ {k: v for k, v in launches.items() if v} }, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
  del lm, state, prog
  gc.collect()
  torch.cuda.empty_cache()
  twin = _TinyBf16(torch, spi, engine, ragged, cfg=spi.DenseLmSsmHybridTiny())
  lm16 = _ServingLm(torch, cfg, fprop_dtype=bf16)
  serve = _ServeMain(torch, cfg, engine, counters,
                     dict(ssd_scan=10, ragged_block_attend_q_bf16=2),
                     lm=lm16, max_new=8, profile=False)
  del lm16
  gc.collect()
  torch.cuda.empty_cache()
  p = cfg.Task().Set(fprop_dtype=bf16)
  p.atten_tpl = attention.MultiHeadedAttention.Params().Set(
      decode_page_size=128)
  lm = p.Instantiate(device="cuda")
  lm.InstantiateVariables(torch.Generator("cuda").manual_seed(0))
  ckdir = os.path.join(tmp, "hybrid_bf16")
  checkpointer.Checkpointer(ckdir).Save(1, lm, force=True)
  arr, lens = _HybridRequests(cfg.VOCAB_SIZE)
  decoder = gshard.GShardDecode(
      lm, ckdir, os.path.join(tmp, "hybrid_bf16.jsonl"),
      max_decode_steps=HYBRID_STEPS, prefill_chunk_size=HYBRID_CHUNK,
      len_buckets=(HYBRID_BUCKET,))
  torch.cuda.synchronize()
  counters.Zero()
  recs = decoder.DecodeOnce(1, arr, lens)
  decode_launches = counters.Read()
  want = dict.fromkeys(counters, 0)
  want.update(ssd_scan=10 * (HYBRID_BUCKET // HYBRID_CHUNK),
              flash_decode_q_bf16=2 * HYBRID_STEPS)
  _Check(decode_launches == want, f"bf16 hybrid GShardDecode launches "
         f"{decode_launches} != {want}")
  out_ids = np.array([r["output_ids"] for r in recs])
  _Check(out_ids.shape == (8, HYBRID_STEPS) and ((out_ids >= 0) & (
      out_ids < cfg.VOCAB_SIZE)).all(), f"bf16 hybrid decode: {out_ids}")
  tel = recs[0]["telemetry"]
  print(f"DenseLmSsmHybrid GShardDecode at bfloat16 ({tel['kv_cache_dtype']}"
        f" cache, the task's first call): prefill_s {tel['prefill_s']:.3f}, "
        f"decode_s {tel['decode_s']:.3f}, launches "
        f"{ {k: v for k, v in decode_launches.items() if v} }, "
        f"decode_state_bytes_per_seq {tel['decode_state_bytes_per_seq']}")
  del lm, decoder
  gc.collect()
  torch.cuda.empty_cache()
  return dict(step_launches=launches, step_s=step_s, loss=out["loss"],
              twin_gap=twin, serve_launches=serve[0], serve_ms=serve[3],
              decode_launches=decode_launches)


def _HybridTrainPhase(torch, ssd, spi, engine, ragged, attention,
                      checkpointer, gshard, counters):
  """Phase 27 (see the module docstring). Returns (the backward kernel's
  two checks, the CLI run's launches and numbers, the bf16 half)."""
  from lingvo_tpu_torch import model_registry
  from lingvo_tpu_torch import trainer
  from lingvo_tpu_torch.core import ssm
  from lingvo_tpu_torch.runners import executor
  from lingvo_tpu_torch.runners import program
  t_phase = time.perf_counter()
  print("scan backward library_ms: null (no single PyTorch call computes "
        "the gradient of a gated chunked linear recurrence); it replaces "
        "no pallas_call (the reference's backward is an XLA recompute)")
  rng = np.random.RandomState(27)
  bwd = _CheckScanBwd(torch, ssd, ssm, "training", rng, False, True)
  bwd_s0 = _CheckScanBwd(torch, ssd, ssm, "training, s0 and a cotangent "
                         "of s_final", rng, True, False)
  gc.collect()
  torch.cuda.empty_cache()
  print(f"phase 27: the kernel checks took "
        f"{time.perf_counter() - t_phase:.1f} s")
  with tempfile.TemporaryDirectory() as tmp:
    launches, cli = _CliHybrid(torch, spi, trainer, executor, program,
                               counters, tmp)
    print(f"phase 27: DenseLmSsmHybrid through the CLI took "
          f"{time.perf_counter() - t_phase:.1f} s")
    cli["tiny_err"] = _CliTiny(
        torch, spi, trainer, model_registry, counters, tmp,
        base=spi.DenseLmSsmHybridTiny, launched=("ssd_scan", "ssd_scan_bwd"))
    print(f"phase 27: the tiny twin took {time.perf_counter() - t_phase:.1f}"
          " s")
    bf16 = _HybridBf16(torch, spi, program, engine, ragged, attention,
                       checkpointer, gshard, counters, tmp)
  print(f"phase 27 took {time.perf_counter() - t_phase:.1f} s")
  return bwd, bwd_s0, dict(cli, launches=launches), bf16


# -- phase 28: the 1B-words configs ---------------------------------------------


SAMPLED_KEY = "lm.one_billion_wds.WordLevelOneBwdsSampledSoftmax"
TRANSFORMER_1BW_KEY = "lm.one_billion_wds.OneBWdsTransformerLm"
# the CLI run of the sampled config cuts step and batch counts only: 3
# train steps a loop (registered 100) and --max_steps=3, 64 eval samples
# (registered 1000) in 2 batches of 32, one checkpoint kept (registered 10)
SAMPLED_STEPS = 3
SAMPLED_EVAL_SAMPLES = 64
# card against CPU on the tiny twin: float32 GEMMs summed in other orders
TWIN_LOSS_TOL = 1e-5
# exp on the card against the CPU: CUDA's expf is within 2 ulps of exp
# (the CUDA Math API's table), PyTorch's CPU exp within 1
EXP_ULPS = 3
# the share of negative ids that may differ card against CPU: at V 793,470
# the mean ulp of exp over the draws is 0.0051 of an id, so a gap of g ulps
# moves about g * 0.51% of the ids across an integer; 0.3% allows a mean
# gap of 0.6 ulps and fails a change in how the ids are truncated
IDS_OFF_SHARE = 0.003


def _HostMemory():
  """(MemAvailable, MemTotal) in bytes, from /proc/meminfo."""
  out = {}
  with open("/proc/meminfo") as f:
    for line in f:
      name, value = line.split(":", 1)
      out[name] = int(value.split()[0]) * 1024
  return out.get("MemAvailable", 0), out.get("MemTotal", 0)


@contextlib.contextmanager
def _SyncsCounted(torch):
  """Counts the host syncs made inside, the calls that
  `torch.cuda.set_sync_debug_mode("warn")` flags (a blocking copy, an
  item(), a stream or device synchronize), by their Python call sites:
  the yielded dict fills when the block ends."""
  import warnings
  sites = {}
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
      yield sites
    finally:
      torch.cuda.set_sync_debug_mode("default")
  for w in caught:
    if "called a synchronizing CUDA operation" in str(w.message):
      site = f"{os.path.basename(w.filename)}:{w.lineno}"
      sites[site] = sites.get(site, 0) + 1


@contextlib.contextmanager
def _RecordBernoulli(threefry, masks=None):
  """Counts `threefry.Bernoulli`'s calls (the dropout masks) in the
  yielded list's length; with `masks` a dict, also records each mask on
  the host by its key."""
  calls, orig = [], threefry.Bernoulli

  def _Recording(key, p, shape, device=None):
    mask = orig(key, p, shape, device)
    calls.append(tuple(shape))
    if masks is not None:
      masks[tuple(int(v) for v in key.cpu())] = mask.cpu()
    return mask

  threefry.Bernoulli = _Recording
  try:
    yield calls
  finally:
    threefry.Bernoulli = orig


def _SampledCli(torch, trainer, executor, program, model_registry, threefry,
                one_billion_wds, counters, tmp):
  """trainer.main on WordLevelOneBwdsSampledSoftmax at its registered
  widths (20 layers, d 1024, 32 x 512 tokens, 793,470 words, 4096
  negatives, Adam, residual dropout 0.1; random weights from a CPU
  generator seeded 1234), cut to SAMPLED_STEPS train steps and 2 eval
  batches, one checkpoint kept, the step-0 save of the random weights
  skipped (nothing reads it; the final save is written and timed), the
  counts set to 0 just before: FINISHED holds the step, the train and
  eval losses are finite, and the xent kernel launched once per eval
  batch and never in training. Prints the free disk and host memory
  before the save, ms/step, peak memory, the save's bytes and seconds;
  then profiles one more train step (its busy share; its TrainStep makes
  no host sync) and the dropout masks' plain threefry in it. Deletes the
  logdir."""
  import shutil
  from lingvo_tpu_torch.core import checkpointer
  base = one_billion_wds.WordLevelOneBwdsSampledSoftmax

  def _Task(self):
    p = base.Task(self)
    p.train.tpu_steps_per_loop = SAMPLED_STEPS
    p.eval.samples_per_summary = SAMPLED_EVAL_SAMPLES
    p.train.save_max_to_keep = 1
    return p

  key = model_registry.RegisterSingleTaskModel(type(
      "WordLevelOneBwdsSampledSoftmaxCut", (base,),
      {"Task": _Task}))._registry_key
  logdir = os.path.join(tmp, "w1bw")
  avail, total = _HostMemory()
  print(f"logdir {logdir}: {shutil.disk_usage(tmp).free / 2**30:.1f} GiB "
        f"free on its disk; host memory {avail / 2**30:.1f} of "
        f"{total / 2**30:.1f} GiB available; cuts: {SAMPLED_STEPS} steps a "
        f"loop (100 registered), --max_steps={SAMPLED_STEPS}, "
        f"{SAMPLED_EVAL_SAMPLES} eval samples (1000), 1 checkpoint kept (10),"
        " the step-0 save skipped")
  captured, eval_s = [], []
  start, run = executor.ExecutorTpu.Start, program.EvalProgram.Run
  save_async = checkpointer.Checkpointer.SaveAsync

  def _SaveAsync(ckpt, step, *args, **kwargs):
    return False if step == 0 else save_async(ckpt, step, *args, **kwargs)

  def _Start(ex):
    captured.append(ex)
    captured.append(start(ex))
    return captured[-1]

  def _EvalRun(prog, state):
    t0 = time.perf_counter()
    out = run(prog, state)
    torch.cuda.synchronize()
    eval_s.append(time.perf_counter() - t0)
    return out

  executor.ExecutorTpu.Start, program.EvalProgram.Run = _Start, _EvalRun
  checkpointer.Checkpointer.SaveAsync = _SaveAsync
  try:
    torch.cuda.synchronize()
    counters.Zero()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = trainer.main([f"--model={key}", f"--logdir={logdir}",
                       "--mode=train", f"--max_steps={SAMPLED_STEPS}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.Read()
  finally:
    executor.ExecutorTpu.Start, program.EvalProgram.Run = start, run
    checkpointer.Checkpointer.SaveAsync = save_async
  peak = torch.cuda.max_memory_allocated()
  with open(os.path.join(logdir, "train", "FINISHED")) as f:
    finished = f.read()
  with open(os.path.join(logdir, "metrics.jsonl")) as f:
    rows = [json.loads(line) for line in f]
  _Check(rc == 0 and finished == str(SAMPLED_STEPS),
         f"rc {rc}, FINISHED {finished!r}")
  _Check([r["step"] for r in rows] == [SAMPLED_STEPS] and all(
      np.isfinite(rows[0][k]["loss"]) for k in ("train", "eval_test")),
         f"metrics.jsonl rows {rows}")
  batches = -(-SAMPLED_EVAL_SAMPLES // 32)
  want = dict.fromkeys(counters, 0)
  want["fused_xent_fwd"] = batches
  _Check(launches == want, f"launches {launches} != {want}")
  ckpts = [d for d in os.listdir(os.path.join(logdir, "train"))
           if d.startswith("ckpt_")]
  ex, state = captured
  _Check(len(ckpts) == 1 and [w["step"] for w in ex.checkpointer.writes]
         == [SAMPLED_STEPS], f"checkpoints kept: {ckpts}, written: "
         f"{[w['step'] for w in ex.checkpointer.writes]}")
  task = ex.task
  train, evals = rows[0]["train"], rows[0]["eval_test"]
  n_params = sum(x.numel() for x in task.parameters())
  print(f"WordLevelOneBwdsSampledSoftmax through trainer.main: {n_params:,} "
        f"params, {wall:.1f} s in all; the loop of {SAMPLED_STEPS} steps "
        f"{1e3 / train['steps_per_second']:.1f} ms/step from its dispatch "
        f"to its end ({train['host_overhead_s']:.2f} s of host dispatch), "
        f"sampled loss {train['loss']:.4f}, grad_norm "
        f"{train['grad_norm']:.4f}, skipped {train['skipped_step']}; "
        f"eval_test ({batches} batches through the xent kernel) "
        f"{eval_s[0]:.2f} s, full-softmax loss {evals['loss']:.4f}, "
        f"accuracy {evals['fraction_of_correct_next_step_preds']:.6f}; "
        f"peak memory {peak / 2**30:.2f} GiB")
  saves = []
  for w in ex.checkpointer.writes:
    saves.append(w)
    print(f"checkpoint step {w['step']}: {w['bytes'] / 2**30:.2f} GiB "
          f"(theta and Adam's m and v), snapshot {w['snapshot_s']:.2f} s on "
          f"the caller, write {w['write_s']:.2f} s "
          f"({w['bytes'] / w['write_s'] / 2**30:.2f} GiB/s)")
  print(f"launches in the CLI run: {launches} (none in the {SAMPLED_STEPS} "
        f"sampled train steps, one a full-softmax eval batch)")
  prog = program.TrainProgram(
      program.TrainProgram.Params().Set(steps_per_loop=1,
                                        async_infeed=False),
      task=task, input_generator=base().Train().Instantiate())
  t0 = time.perf_counter()
  train_step, syncs = task.TrainStep, {}

  def _Counted(*args, **kwargs):
    with _SyncsCounted(torch) as sites:
      out = train_step(*args, **kwargs)
    syncs.update(sites)
    return out

  task.TrainStep = _Counted
  try:
    with _RecordBernoulli(threefry) as masks:
      busy = _StepBusy(torch, lambda: prog.Run(state))
  finally:
    del task.TrainStep
  print(f"the profiled step took {time.perf_counter() - t0:.1f} s with the "
        f"profiler's own work; {len(masks)} dropout masks drawn in it "
        f"(2 a layer in the forward, again in remat's recompute); "
        f"{sum(syncs.values())} host syncs in its TrainStep {syncs}")
  _Check(not syncs, f"the train step synced the host: {syncs}")
  # a CPU key drawn on the card, as the dropout layer draws it
  mask_key = threefry.FoldIn(threefry.PRNGKey(1234), 7)
  mask_ms = _TimeMs(torch, lambda: threefry.Bernoulli(
      mask_key, 0.9, (32, 512, 1024), "cuda"), 3,
                    waits_as="the plain threefry mask")
  mask_share = (len(masks) * mask_ms / busy[0]) if busy else None
  print(f"one [32, 512, 1024] mask by the plain threefry: {mask_ms:.3f} ms; "
        f"{len(masks)} a step: {len(masks) * mask_ms:.1f} ms"
        + (f", {mask_share:.1%} of the profiled step's busy {busy[0]:.1f} ms"
           if busy else ""))
  # Adam's update of every parameter and slot, as the learner runs it
  # after the backward (zero gradients: the same work)
  from lingvo_tpu_torch.core import base_layer
  params = task.TrainableTheta()
  grads = {k: base_layer.StackedLeaf(tuple(torch.zeros_like(x)
                                           for x in v.layers))
           if isinstance(v, base_layer.StackedLeaf) else torch.zeros_like(v)
           for k, v in params.items()}
  lr = torch.tensor(1e-3, dtype=torch.float32)
  adam_ms = _TimeMs(torch, lambda: task.learner.opt.Update(
      state.opt_states[0], grads, params, lr, SAMPLED_STEPS), 2,
                    waits_as="Adam's update")
  print(f"Adam's update of the {n_params:,} parameters and their m and v: "
        f"{adam_ms:.1f} ms" + (f", {adam_ms / busy[0]:.1%} of the profiled "
                               "step's busy" if busy else ""))
  del captured, ex, task, prog, state, params, grads
  shutil.rmtree(logdir)
  gc.collect()
  torch.cuda.empty_cache()
  return dict(launches=launches, ms_step=1e3 / train["steps_per_second"],
              eval_s=eval_s[0], peak=peak, wall=wall, saves=saves,
              masks=len(masks), mask_ms=mask_ms, mask_share=mask_share,
              busy=busy, adam_ms=adam_ms, syncs=sum(syncs.values()))


def _TransformerLm1Bw(torch, program, one_billion_wds, counters):
  """OneBWdsTransformerLm as registered (20 layers, d 1024, 32 x 512
  tokens, 32,000-word tied head with the cap, Adam, residual dropout 0.1;
  random weights from a CPU generator seeded 1234): two train steps of the
  task on the card through TrainProgram, counts set to 0 just before:
  finite losses, no skipped step, no kernel launched (flash off and the
  dense head, as registered)."""
  cfg = one_billion_wds.OneBWdsTransformerLm()
  task = cfg.Task().Instantiate(device="cuda")
  task.FinalizePaths()
  state = task.CreateTrainState(torch.Generator("cpu").manual_seed(1234))
  prog = program.TrainProgram(
      program.TrainProgram.Params().Set(steps_per_loop=2,
                                        async_infeed=False),
      task=task, input_generator=cfg.Train().Instantiate())
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  counters.Zero()
  t0 = time.perf_counter()
  _, out = prog.Run(state)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = counters.Read()
  _Check(state.step == 2 and np.isfinite(out["loss"])
         and np.isfinite(out["grad_norm"]) and out["skipped_step"] == 0,
         f"OneBWdsTransformerLm: step {state.step}, {out}")
  _Check(not any(launches.values()), f"launches {launches}")
  peak = torch.cuda.max_memory_allocated()
  print(f"OneBWdsTransformerLm: {sum(x.numel() for x in task.parameters()):,}"
        f" params, 2 train steps in {wall:.2f} s (the first with cuBLAS's "
        f"start), loss {out['loss']:.4f}, grad_norm {out['grad_norm']:.4f}, "
        f"peak memory {peak / 2**30:.2f} GiB, no kernel launched")
  del task, state, prog
  gc.collect()
  torch.cuda.empty_cache()
  return dict(ms_step=wall / 2 * 1e3, peak=peak, loss=out["loss"])


def _SampledTwin(torch, threefry, counters, tmp):
  """A tiny twin of the sampled config (2 layers, d 64, V 1003, 64
  negatives, residual dropout 0.1) on the card and on the CPU from one
  npz: two TrainSteps with the program's base key, each dropout mask
  recorded by its key (the same keys, the masks bitwise equal), the
  losses within TWIN_LOSS_TOL; an EvalStep (the xent kernel on the card,
  one launch, the plain version on the CPU) within it too. The negative
  ids the card draws against the CPU's at V 793,470 over 50 step keys:
  the mismatches counted, each one id away."""
  from lingvo_tpu_torch.core import checkpointer
  from lingvo_tpu_torch.core import layers
  from lingvo_tpu_torch.core import py_utils
  from lingvo_tpu_torch.models.lm import input_generator
  from lingvo_tpu_torch.models.lm import layers as lm_layers
  from lingvo_tpu_torch import convert

  def _Lm(device):
    return lm_layers.TransformerLm.Params().Set(
        name="lm", vocab_size=1003, model_dim=64, num_layers=2, num_heads=4,
        hidden_dim=128, softmax_num_sampled=64,
        residual_dropout_prob=0.1).Instantiate(device=device)

  src = _Lm("cpu")
  src.InstantiateVariables(torch.Generator("cpu").manual_seed(28))
  npz = os.path.join(tmp, "twin.npz")
  np.savez(npz, **dict(convert.ThetaToNumpy(src).FlattenItems()))
  gen = input_generator.SyntheticLmInput.Params().Set(
      batch_size=4, seq_len=64, vocab_size=1003, seed=5).Instantiate()
  batches = [gen.GetPreprocessedInputBatch() for _ in range(3)]
  runs = {}
  for device in ("cpu", "cuda"):
    lm = _Lm(device)
    lm.FinalizePaths()
    checkpointer.ImportNpzCheckpoint(lm, npz)
    state = lm.CreateTrainState()
    masks, losses = {}, []
    counters.Zero()
    with _RecordBernoulli(threefry, masks):
      for b in batches[:2]:
        out = lm.TrainStep(state, b.Transform(
            lambda x: torch.as_tensor(x).to(device)), threefry.PRNGKey(1234))
        losses.append(float(out.metrics.loss[0]))
    metrics, _ = lm.EvalStep(batches[2].Transform(
        lambda x: torch.as_tensor(x).to(device)))
    runs[device] = dict(masks=masks, losses=losses,
                        eval=float(metrics.loss[0]), launches=counters.Read())
  cpu, card = runs["cpu"], runs["cuda"]
  _Check(sorted(card["masks"]) == sorted(cpu["masks"]) and len(cpu["masks"])
         == 8, f"twin mask keys: {len(card['masks'])} vs {len(cpu['masks'])}")
  _Check(all(torch.equal(card["masks"][k], cpu["masks"][k])
             for k in cpu["masks"]), "twin: a dropout mask differs")
  err = max([abs(a - b) for a, b in zip(card["losses"], cpu["losses"])]
            + [abs(card["eval"] - cpu["eval"])])
  _Check(err <= TWIN_LOSS_TOL, f"twin: card {card} vs CPU {cpu} losses")
  want = dict.fromkeys(counters, 0)
  want["fused_xent_fwd"] = 1
  _Check(card["launches"] == want and not any(cpu["launches"].values()),
         f"twin launches: card {card['launches']}, CPU {cpu['launches']}")
  head = layers.SampledSoftmax.Params().Set(
      name="sampled_softmax", input_dim=8, num_classes=793_470,
      num_sampled=4096).Instantiate(device="meta")
  head.FinalizePaths("lm/sampled_softmax")
  off, total, worst = _NegativeIdsCardVsCpu(torch, threefry, py_utils, head)
  print(f"tiny sampled twin card vs CPU: {len(cpu['masks'])} dropout masks "
        f"bitwise equal; losses {card['losses']} vs {cpu['losses']}, eval "
        f"{card['eval']:.6f} vs {cpu['eval']:.6f}: max |card - CPU| "
        f"{err:.3g} (tol {TWIN_LOSS_TOL}); negative ids at V 793,470 over "
        f"50 step keys: {off} of {total} differ between the card and the CPU"
        f", each by one id where the two exp differ (by at most {worst} "
        f"ulps; tol {EXP_ULPS}; limit {IDS_OFF_SHARE:.1%} of the ids)")
  return dict(err=err, masks=len(cpu["masks"]), ids_off=off, ids=total,
              exp_ulps=worst)


def _NegativeIdsCardVsCpu(torch, threefry, py_utils, head, steps=50):
  """The negative ids `head` draws on the card against the CPU's over the
  first `steps` step keys (base 1234): the uniforms bitwise equal, the two
  exp(u log(V + 1)) within EXP_ULPS, every id that differs one id away,
  where the exps differ, and at most IDS_OFF_SHARE of them. Returns (ids
  that differ, ids, the widest exp gap in ulps)."""
  scale = np.log(head.p.num_classes + 1.0)
  off = total = worst = 0
  for step in range(steps):
    with py_utils.StepSeedContext(threefry.FoldIn(threefry.PRNGKey(1234),
                                                  step)):
      key = py_utils.StepSeed(f"{head.path}/sampled_softmax")
    u = {d: threefry.Uniform01(key, (head.p.num_sampled,), d)
         for d in ("cpu", "cuda")}
    _Check(torch.equal(u["cuda"].cpu(), u["cpu"]), "the uniforms differ")
    e = {d: torch.exp(x * scale).cpu().view(torch.int32).long()
         for d, x in u.items()}
    ulps = (e["cuda"] - e["cpu"]).abs()
    worst = max(worst, int(ulps.max()))
    a = head.SampleNegatives(key, "cuda").cpu()
    b = head.SampleNegatives(key, "cpu")
    diff = a != b
    _Check(bool(((a[diff].long() - b[diff].long()).abs() == 1).all())
           and bool((ulps[diff] > 0).all()),
           "a negative id differs by more than one, or where exp agrees")
    off += int(diff.sum())
    total += a.numel()
  _Check(worst <= EXP_ULPS, f"exp on the card and the CPU {worst} ulps apart")
  _Check(off <= IDS_OFF_SHARE * total,
         f"{off} of {total} negative ids differ card vs CPU (limit "
         f"{IDS_OFF_SHARE:.1%})")
  return off, total, worst


def _OneBWdsPhase(torch, fx, threefry, counters):
  """Phase 28 (see the module docstring). Returns (the xent checks at the
  sampled eval's shape and at V 1003, the CLI run, OneBWdsTransformerLm's
  steps, the tiny twin)."""
  from lingvo_tpu_torch import model_registry
  from lingvo_tpu_torch import trainer
  from lingvo_tpu_torch.models.lm.params import one_billion_wds
  from lingvo_tpu_torch.runners import executor
  from lingvo_tpu_torch.runners import program
  t_phase = time.perf_counter()
  rows = 32 * 512
  geo = fx.StatsGeometry(rows, 793_470, torch.cuda.get_device_properties(
      0).multi_processor_count)
  print(f"row tiles x splits {geo['row_tiles']} x {geo['splits']} "
        f"({geo['tiles_per_split']} tiles of {geo['tile']} a split; the last "
        f"tile holds {793_470 % geo['tile']} of its {geo['tile']} columns); "
        "library: none")
  xent = _CheckXent(torch, fx, np.random.RandomState(28), 1024, 0.0, True,
                    m=rows, vocab=793_470, d=1024, table_seed=28, cap=0.0,
                    bias_seed=29, iters=(3, 0))
  small = _CheckXent(torch, fx, np.random.RandomState(30), 1024, 0.0, False,
                     m=300, vocab=1003, d=1024, cap=0.0, bias_seed=31)
  xent["err"] = max(xent["err"], small["err"])
  gc.collect()
  torch.cuda.empty_cache()
  print(f"phase 28: the kernel checks took "
        f"{time.perf_counter() - t_phase:.1f} s")
  with tempfile.TemporaryDirectory() as tmp:
    cli = _SampledCli(torch, trainer, executor, program, model_registry,
                      threefry, one_billion_wds, counters, tmp)
    print(f"phase 28: the sampled config through the CLI took "
          f"{time.perf_counter() - t_phase:.1f} s")
    tlm = _TransformerLm1Bw(torch, program, one_billion_wds, counters)
    twin = _SampledTwin(torch, threefry, counters, tmp)
  print(f"phase 28 took {time.perf_counter() - t_phase:.1f} s")
  return xent, cli, tlm, twin


# phase 29: the trainer's remaining training surface
DISTILL_STEPS, DISTILL_RESUME = 4, 6   # --max_steps of the run and its resume
DISTILL_LOOP = 2                       # steps a loop: two loops, then one
STUDENT_LAYERS = 8                     # OneBWdsTransformerLm's 20, cut
MT_STEPS, MT_LOOP = 8, 2               # 4 multi-task cycles of 2 steps
# the two learners: Adam over the student's embedding and norms, Shampoo
# over the rest of the student (DistillationTask excludes the teacher)
EMB_NORM = r"^student\.(emb\.|final_ln\.|.*\.ln\.)"
REST = r"^student\.(?!emb\.|final_ln\.)(?!.*\.ln\.)"
FFN_W = r"student\.stack\.x_layers\[\d+\]\.fflayer\.ffn_(in|out)\.w"
SHARE = [(r"emb\.(.*)", r"shared_emb.\1")]
TWIN29_TOL = 1e-4
# the tiny distillation's losses after Shampoo's step-10 refresh, card vs
# CPU (measured 2.6e-4 on one H100)
SHAMPOO_TWIN_TOL = 1e-3


def _Flash(p):
  from lingvo_tpu_torch.core import attention
  p.atten_tpl = attention.MultiHeadedAttention.Params().Set(
      use_flash_attention=True)
  return p


def _Student(one_billion_wds, tiny):
  """OneBWdsTransformerLm's task at its registered widths (or
  DenseLmTiny's), cut to STUDENT_LAYERS (2) unrolled layers, flash on."""
  p = _Flash(one_billion_wds.OneBWdsTransformerLm().Task())
  p.num_layers = 2 if tiny else STUDENT_LAYERS
  p.use_repeat_layer = False
  if tiny:
    p.Set(model_dim=64, num_heads=4, hidden_dim=128, vocab_size=128)
  return p


def _Learner(name, regex, opt):
  from lingvo_tpu_torch.core import learner
  from lingvo_tpu_torch.core import schedule
  return learner.Learner.Params().Set(
      name=name, learning_rate=1e-3, bprop_variable_filter=regex,
      optimizer=opt, clip_gradient_norm_to_value=1.0,
      lr_schedule=schedule.LinearRampupCosineDecay.Params().Set(
          warmup_steps=2, total_steps=1000))


def _DistillModel(spi, one_billion_wds, tiny):
  """A registered experiment: DenseLm1B's task (DenseLmTiny's) as the
  frozen teacher with flash on, the student above, two learners, the EMA
  and pruning of the student's FFN weights; DenseLm1B's input."""
  from lingvo_tpu_torch import model_registry
  from lingvo_tpu_torch.core import base_model_params
  from lingvo_tpu_torch.core import distillation_task
  from lingvo_tpu_torch.core import optimizer
  from lingvo_tpu_torch.core import pruning
  data = spi.DenseLmTiny() if tiny else spi.DenseLm1B()

  def _Task(self):
    p = distillation_task.DistillationTask.Params().Set(
        name="distill", teacher=_Flash(data.Task()),
        student=_Student(one_billion_wds, tiny), distill_weight=0.5,
        temperature=2.0)
    p.train.learner = [
        _Learner("emb_norm", EMB_NORM,
                 optimizer.Adam.Params().Set(beta2=0.98)),
        _Learner("shampoo", REST,
                 optimizer.DistributedShampoo.Params().Set(block_size=4096))]
    p.train.ema_decay = 0.999
    p.train.pruning = pruning.PruningSchedule.Params().Set(
        weight_regex=FFN_W, final_sparsity=0.5, begin_step=0,
        end_step=16 if tiny else DISTILL_RESUME, frequency=1)
    p.train.tpu_steps_per_loop = 4 if tiny else DISTILL_LOOP
    p.train.save_interval_steps = 1_000_000
    p.train.save_max_to_keep = 1
    p.eval.samples_per_summary = 32 if tiny else data.BATCH_SIZE
    return p

  name = "DistillTiny" if tiny else "Distill1B"
  return model_registry.RegisterSingleTaskModel(type(
      name, (base_model_params.SingleTaskModelParams,),
      {"Train": lambda self: data.Train(), "Test": lambda self: data.Test(),
       "Task": _Task}))._registry_key


def _CloneTensors(tensors):
  return [t.detach().clone() for t in tensors]


def _StateTensors(checkpointer, state):
  return [t for _, t in checkpointer._OptItems(state)]


def _DistillCli(torch, spi, one_billion_wds, counters, tmp):
  """Phase 29 (a): trainer.main on the distillation experiment to
  DISTILL_STEPS, then a resume to DISTILL_RESUME, with the counts set to 0
  before each run. Returns the launches of both runs and the numbers."""
  from lingvo_tpu_torch import trainer
  from lingvo_tpu_torch.core import base_model
  from lingvo_tpu_torch.core import checkpointer
  from lingvo_tpu_torch.core import pruning
  from lingvo_tpu_torch.runners import executor
  key = _DistillModel(spi, one_billion_wds, tiny=False)
  logdir = os.path.join(tmp, "distill")
  runs, step_ms = [], []
  start, main_loop = executor.ExecutorTpu.Start, executor.ExecutorTpu._MainLoop
  restore = checkpointer.Checkpointer.Restore
  save = checkpointer.Checkpointer.Save
  save_async = checkpointer.Checkpointer.SaveAsync
  train_step = base_model.BaseTask.TrainStep
  restored = {}

  def _Start(ex):
    runs.append(dict(ex=ex))
    runs[-1]["state"] = start(ex)
    return runs[-1]["state"]

  def _MainLoop(ex, state, start_step):
    runs[-1]["teacher"] = _CloneTensors(ex.task.teacher.parameters())
    return main_loop(ex, state, start_step)

  def _Restore(ckpt, task, step=None, state=None):
    out = restore(ckpt, task, step=step, state=state)
    if len(runs) == 2 and state is not None:
      old = _StateTensors(checkpointer, runs[0]["state"])
      new = _StateTensors(checkpointer, out[0])
      restored["ok"] = len(old) == len(new) and all(
          torch.equal(a, b) for a, b in zip(old, new))
      restored["tensors"] = len(new)
      restored["ema"] = sum(1 for k, _ in checkpointer._OptItems(out[0])
                            if k.startswith("ema_theta"))
    return out

  def _Save(ckpt, step, *args, **kwargs):
    # one save: the first run's final one; the resume's final save skipped
    return False if step == DISTILL_RESUME else save(ckpt, step, *args,
                                                     **kwargs)

  def _SaveAsync(ckpt, step, *args, **kwargs):
    return False if step == 0 else save_async(ckpt, step, *args, **kwargs)

  def _TrainStep(task, *args, **kwargs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train_step(task, *args, **kwargs)
    torch.cuda.synchronize()
    step_ms.append((args[0].step - 1, (time.perf_counter() - t0) * 1e3))
    return out

  launches, peaks, walls = [], [], []
  (executor.ExecutorTpu.Start, executor.ExecutorTpu._MainLoop,
   checkpointer.Checkpointer.Restore, checkpointer.Checkpointer.Save,
   checkpointer.Checkpointer.SaveAsync, base_model.BaseTask.TrainStep) = (
       _Start, _MainLoop, _Restore, _Save, _SaveAsync, _TrainStep)
  try:
    for steps in (DISTILL_STEPS, DISTILL_RESUME):
      torch.cuda.synchronize()
      counters.Zero()
      torch.cuda.reset_peak_memory_stats()
      t0 = time.perf_counter()
      rc = trainer.main([f"--model={key}", f"--logdir={logdir}",
                         "--mode=train", f"--max_steps={steps}"])
      torch.cuda.synchronize()
      walls.append(time.perf_counter() - t0)
      launches.append(counters.Read())
      peaks.append(torch.cuda.max_memory_allocated())
      with open(os.path.join(logdir, "train", "FINISHED")) as f:
        finished = f.read()
      _Check(rc == 0 and finished == str(steps),
             f"distillation to {steps}: rc {rc}, FINISHED {finished!r}")
      run = runs[-1]
      ex, task = run["ex"], run["ex"].task
      unchanged = all(torch.equal(a, b) for a, b in
                      zip(run.pop("teacher"), task.teacher.parameters()))
      _Check(unchanged, f"distillation to {steps}: the teacher's theta moved")
      # the schedule's zeros at the run's last step, k = int(sparsity *
      # size) a matrix; ties at a matrix's threshold are pruned too (the
      # reference's rule), so a few more may be zero
      sched = pruning.PruningSchedule(task.p.train.pruning)
      masks = ex.pruning_masks
      total = sum(m.numel() for m in masks.values())
      want = sum(int(sched.SparsityAt(steps) * m.numel())
                 for m in masks.values())
      got = round(pruning.Sparsity(masks, sched) * total)
      _Check(len(masks) == 2 * STUDENT_LAYERS and 0 <= got - want <= 64,
             f"distillation to {steps}: {len(masks)} masks, {got} zeros vs "
             f"the schedule's {want} of {total}")
      run.update(sparsity=got / total, tie_zeros=got - want)
      if steps == DISTILL_STEPS:   # the resume restores from these
        del run["ex"]
      else:
        del runs[0]["state"]
      del ex, task
      gc.collect()
      torch.cuda.empty_cache()
  finally:
    (executor.ExecutorTpu.Start, executor.ExecutorTpu._MainLoop,
     checkpointer.Checkpointer.Restore, checkpointer.Checkpointer.Save,
     checkpointer.Checkpointer.SaveAsync, base_model.BaseTask.TrainStep) = (
         start, main_loop, restore, save, save_async, train_step)
  _Check(restored.get("ok") and restored["ema"] > 0,
         f"the resume did not restore the saved state: {restored}")
  with open(os.path.join(logdir, "metrics.jsonl")) as f:
    rows = [json.loads(line) for line in f]
  _Check([r["step"] for r in rows] == [2, 4, 6] and all(
      np.isfinite(r[k]["loss"]) for r in rows for k in ("train",
                                                        "eval_test")),
         f"distillation metrics.jsonl rows {rows}")
  # per learner and step: the teacher forward only (24 layers), the
  # student forward and backward (8 layers); an eval batch both forwards
  teacher_layers = spi.DenseLm1B.NUM_LAYERS
  for steps, got, evals in ((DISTILL_STEPS, launches[0], 2),
                            (DISTILL_RESUME - DISTILL_STEPS, launches[1], 1)):
    want = dict.fromkeys(counters, 0)
    want["flash_attention_fwd"] = (steps * 2 * (teacher_layers
                                                + STUDENT_LAYERS)
                                   + evals * (teacher_layers
                                              + STUDENT_LAYERS))
    want["flash_attention_dkdv"] = want["flash_attention_dq"] = (
        steps * 2 * STUDENT_LAYERS)
    _Check(got == want, f"distillation launches {got} != {want}")
  refresh = [ms for s, ms in step_ms if s == 0]
  plain = [ms for s, ms in step_ms if s != 0]
  last = rows[-1]
  print(f"distillation (DenseLm1B teacher, 8-layer OneBWds student, 2 "
        f"learners, EMA 0.999, FFN pruning to 0.5) through trainer.main: "
        f"{walls[0]:.1f} s to {DISTILL_STEPS} steps, {walls[1]:.1f} s for the "
        f"resume to {DISTILL_RESUME}; the refresh step (0) {refresh[0]:.1f} "
        f"ms against {np.mean(plain):.1f} ms a plain step (mean of "
        f"{len(plain)}: {[round(ms, 1) for _, ms in step_ms]}); peak memory "
        f"{peaks[0] / 2**30:.2f} / {peaks[1] / 2**30:.2f} GiB; last loss "
        f"{last['train']['loss']:.4f} (hard {last['train']['hard_loss']:.4f}"
        f", distill {last['train']['distill_loss']:.4f}), eval on the EMA "
        f"{last['eval_test']['loss']:.4f}; sparsity {runs[0]['sparsity']:.6f}"
        f" ({runs[0]['tie_zeros']} zeros past the schedule's: ties at a "
        f"threshold); the resume restored {restored['tensors']} state tensors "
        f"({restored['ema']} of the EMA) bit for bit; launches {launches}")
  shutil.rmtree(logdir)
  return launches, dict(walls=walls, refresh_ms=refresh[0],
                        plain_ms=float(np.mean(plain)), peaks=peaks,
                        step_ms=step_ms)


def _EighMs(torch, optimizer):
  """Device ms of one Shampoo inverse root (eigh and the products) at
  4096 and 1024, on a full-rank statistic."""
  out = {}
  opt = optimizer.DistributedShampoo.Params().Instantiate(device="cuda")
  for n in (4096, 1024):
    g = torch.randn(n, n + 64, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(n))
    stat = g @ g.T
    opt.InverseQuarterRoot(stat)
    eigh = [_EventMs(torch, lambda: torch.linalg.eigh(stat))
            for _ in range(3)]
    root = [_EventMs(torch, lambda: opt.InverseQuarterRoot(stat))
            for _ in range(3)]
    out[n] = dict(eigh_ms=min(eigh), root_ms=min(root))
  per_refresh = 2 * STUDENT_LAYERS * (out[4096]["root_ms"]
                                      + out[1024]["root_ms"])
  print(f"Shampoo's inverse root (torch.linalg.eigh: cuSOLVER, a library "
        f"call; the reference's jnp.linalg.eigh is no pallas_call): eigh "
        f"4096 {out[4096]['eigh_ms']:.1f} ms, 1024 {out[1024]['eigh_ms']:.1f}"
        f" ms; the whole root {out[4096]['root_ms']:.1f} / "
        f"{out[1024]['root_ms']:.1f} ms; {2 * STUDENT_LAYERS} FFN matrices "
        f"a refresh: {per_refresh:.0f} ms")
  return dict(out, per_refresh_ms=per_refresh)


def _MultiTask(torch, spi, one_billion_wds, tmp, device, tiny, counters=None):
  """Phase 29 (b): ExecutorTpu over a MultiTaskProgramSchedule of two LM
  tasks (EGDD; AdaGraft(Adam, Momentum)) sharing their embedding,
  ConstantScheduler seed 3, MT_STEPS steps in cycles of MT_LOOP. Returns
  (metrics rows, launches or None, final state, the schedule)."""
  from lingvo_tpu_torch.core import checkpointer
  from lingvo_tpu_torch.core import hyperparams
  from lingvo_tpu_torch.core import learner
  from lingvo_tpu_torch.core import multitask_model
  from lingvo_tpu_torch.core import optimizer
  from lingvo_tpu_torch.core import task_scheduler
  from lingvo_tpu_torch.runners import executor
  from lingvo_tpu_torch.runners import program
  data = spi.DenseLmTiny() if tiny else spi.DenseLm1B()
  opts = dict(a=optimizer.EGDD.Params(), b=optimizer.AdaGraft.Params().Set(
      magnitude_optimizer=optimizer.Adam.Params().Set(beta2=0.98),
      direction_optimizer=optimizer.Momentum.Params()))
  logdir = os.path.join(tmp, f"multitask_{device}_{tiny}")
  train_programs = hyperparams.Params()
  tasks, gens = {}, {}
  for i, name in enumerate(("a", "b")):
    p = _Student(one_billion_wds, tiny).Set(name=name, xent_block_size=(
        32 if tiny else 1280))
    p.train.learner = learner.Learner.Params().Set(
        name="lrn", learning_rate=1e-3, optimizer=opts[name],
        clip_gradient_norm_to_value=1.0)
    p.train.max_steps = MT_STEPS
    p.train.save_interval_steps = 1_000_000
    p.train.save_max_to_keep = 1
    tasks[name] = p.Instantiate(device=device)
    train_programs.Define(name, program.TrainProgram.Params().Set(
        task=p, logdir=logdir, name=f"train_{name}",
        steps_per_loop=MT_LOOP), "")
    gens[(name, "Train")] = data.Train().Set(seed=11 + i).Instantiate()
  sched = program.MultiTaskProgramSchedule(
      program.MultiTaskProgramSchedule.Params().Set(
          task_schedule=task_scheduler.ConstantScheduler.Params().Set(
              task_probs=[("a", 0.5), ("b", 0.5)], seed=3),
          train_programs=train_programs, variable_renaming_rules=SHARE),
      tasks=tasks, input_generators=gens)
  shared = list(multitask_model.SharedVariableRules(SHARE).SharedPaths(
      tasks).values())
  run, tied = sched.Run, []

  def _Run(state):
    state, results = run(state)
    theta = {n: dict(t.ThetaTree().FlattenItems()) for n, t in tasks.items()}
    tied.append(all(torch.equal(theta[n][p], theta[e[0][0]][e[0][1]])
                    for e in shared for n, p in e[1:]))
    return state, results

  sched.Run = _Run
  if counters is not None:
    torch.cuda.synchronize()
    counters.Zero()
  save = checkpointer.Checkpointer.Save

  def _Save(ckpt, step, *args, **kwargs):
    # the step-0 save of the random weights, which nothing reads, skipped
    return False if step == 0 else save(ckpt, step, *args, **kwargs)

  checkpointer.Checkpointer.Save = _Save
  try:
    state = executor.ExecutorTpu(None, logdir, schedule=sched).Start()
  finally:
    checkpointer.Checkpointer.Save = save
  launches = None
  if counters is not None:
    torch.cuda.synchronize()
    launches = counters.Read()
  with open(os.path.join(logdir, "metrics.jsonl")) as f:
    rows = [json.loads(line) for line in f]
  cycles = [r["sampled_task"] for r in rows if "sampled_task" in r]
  _Check(len(cycles) == MT_STEPS // MT_LOOP and set(cycles) == {"a", "b"}
         and all(tied) and state.step == MT_STEPS,
         f"multi-task on {device}: cycles {cycles}, shared leaves tied "
         f"after each {tied}, step {state.step}")
  losses = [r[k]["loss"] for r in rows for k in r if k.startswith("train_")]
  _Check(all(np.isfinite(losses)), f"multi-task losses {losses}")
  # the combined checkpoint round-trips into a fresh state
  ckpt = checkpointer.Checkpointer(os.path.join(logdir, "train"))
  fresh = sched.CreateTrainState()
  restored, step = ckpt.Restore(sched.model, state=fresh)
  same = all(torch.equal(a, b) for a, b in zip(
      _StateTensors(checkpointer, restored),
      _StateTensors(checkpointer, state)))
  _Check(step == MT_STEPS and same and all(
      restored.tasks[n].step == state.tasks[n].step for n in tasks),
         f"multi-task checkpoint round trip: step {step}, tensors equal "
         f"{same}")
  return rows, launches, state, sched


def _TrainSurfacePhase(torch, spi, counters):
  """Phase 29 (see the module docstring). Returns (the distillation run's
  launches and numbers, the multi-task run's launches, the eigh times,
  the tiny twins' errors)."""
  from lingvo_tpu_torch import trainer
  from lingvo_tpu_torch.core import optimizer
  from lingvo_tpu_torch.models.lm.params import one_billion_wds
  t_phase = time.perf_counter()
  eigh = _EighMs(torch, optimizer)
  with tempfile.TemporaryDirectory() as tmp:
    print(f"{tmp}: {shutil.disk_usage(tmp).free / 2**30:.1f} GiB free")
    distill, dnum = _DistillCli(torch, spi, one_billion_wds, counters, tmp)
    print(f"phase 29 (a) done at {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows, mt_launches, state, sched = _MultiTask(
        torch, spi, one_billion_wds, tmp, "cuda", tiny=False,
        counters=counters)
    mt_s = time.perf_counter() - t0
    want = dict.fromkeys(counters, 0)
    want["flash_attention_fwd"] = want["flash_attention_dkdv"] = want[
        "flash_attention_dq"] = MT_STEPS * STUDENT_LAYERS
    want["fused_xent_fwd"] = MT_STEPS
    _Check(mt_launches == want, f"multi-task launches {mt_launches} != "
           f"{want}")
    cycles = [r["sampled_task"] for r in rows if "sampled_task" in r]
    print(f"multi-task (two 8-layer OneBWds-width tasks, EGDD and "
          f"AdaGraft(Adam, Momentum), the embedding shared) through "
          f"ExecutorTpu: {mt_s:.1f} s, cycles {cycles}, steps "
          f"{ {n: s.step for n, s in state.tasks.items()} }, shared leaves "
          f"bitwise equal after every cycle, the checkpoint round-tripped; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB;"
          f" launches {mt_launches}")
    del state, sched
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 29 (b) done at {time.perf_counter() - t_phase:.1f} s")
    key = _DistillModel(spi, one_billion_wds, tiny=True)
    got = _TinyCliRuns(trainer, key, os.path.join(tmp, "dt_cuda"), "cuda")
    want = _TinyCliRuns(trainer, key, os.path.join(tmp, "dt_cpu"), "cpu")
    _Check(sorted(got[0]) == sorted(want[0]) == [4, 8, 12, 16]
           and len(got[1]) == len(want[1]) == 5,
           f"tiny distillation rows: {got} vs {want}")
    # the losses up to step 8 (the train rows at 4 and 8, the evals at 4
    # and 8) come before Shampoo's second refresh (step 10); after it the
    # roots' near-null directions follow the solver's rounding (cuSOLVER
    # against LAPACK: ROADMAP §3), which the later losses carry
    diffs = ([abs(got[0][s] - want[0][s]) for s in sorted(want[0])] +
             [abs(a - b) for a, b in zip(got[1], want[1])])
    before = max(diffs[:2] + diffs[4:6])
    distill_err = max(diffs)
    _Check(before <= TWIN29_TOL and distill_err <= SHAMPOO_TWIN_TOL,
           f"tiny distillation, card {got} vs CPU {want}: max err "
           f"{before} before step 10's refresh, {distill_err} in all")
    mt = {dev: _MultiTask(torch, spi, one_billion_wds, tmp, dev,
                          tiny=True)[0] for dev in ("cuda", "cpu")}
    pairs = [(a[k]["loss"], b[k]["loss"]) for a, b in zip(mt["cuda"],
                                                          mt["cpu"])
             for k in a if k.startswith("train_")]
    _Check([r.get("sampled_task") for r in mt["cuda"]] ==
           [r.get("sampled_task") for r in mt["cpu"]] and pairs,
           f"tiny multi-task rows {mt}")
    mt_err = max(abs(a - b) for a, b in pairs)
    _Check(mt_err <= TWIN29_TOL, f"tiny multi-task, card vs CPU: {pairs}")
    print(f"tiny twins, card vs CPU: distillation through the CLI (train to "
          f"8, resume to 16, eval) max |card - CPU| {before:.3g} up to step "
          f"8 (tol {TWIN29_TOL}), {distill_err:.3g} in all (tol "
          f"{SHAMPOO_TWIN_TOL}: Shampoo's step-10 refresh), losses "
          f"{got[0]}; multi-task max {mt_err:.3g} over {len(pairs)} cycles "
          f"(tol {TWIN29_TOL})")
  print(f"phase 29 took {time.perf_counter() - t_phase:.1f} s")
  return distill, dnum, mt_launches, eigh, dict(
      distill_to_step_8=before, distill=distill_err, multitask=mt_err)


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
  sources = ("ragged_block_attend", "ssd_scan", "ssd_scan_bwd",
             "flash_attention", "fused_xent", "block_decode", "flash_decode",
             "int8_matmul", "sample_tokens")

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

    _Phase(f"16. quantized serving main path: DenseLm1B (at {SERVE_DEPTH} of "
           "its 24 layers) through ServingLoop with int8 and bfloat16 KV "
           "pools")
    for mode, dtype in (("ragged", "int8"), ("legacy", "int8"),
                        ("ragged", "bfloat16")):
      _TinyReference(torch, spi.DenseLmTiny(), engine, ragged,
                     step_mode=mode, kv_cache_dtype=dtype)
    cfg16 = _DenseLm1BCut(spi)
    lm = _ServingLm(torch, cfg16)
    quant_serve, phase_ms, base_streams = {}, {}, {}
    # each step mode serves float32 pools first, unprofiled: the baseline
    # of the same process at the same point (walls drift over a process)
    for mode, kernel in (("ragged", "ragged_block_attend"),
                         ("legacy", "block_decode")):
      for dtype, suffix in ((None, ""), ("int8", "_int8"),
                            ("bfloat16", "_bf16")):
        key = kernel + suffix
        per_step = {key: SERVE_DEPTH} if mode == "ragged" else {}
        per_decode = {key: SERVE_DEPTH} if mode == "legacy" else None
        launches, _, streams, ms = _ServeMain(
            torch, cfg16, engine, counters, per_step, per_decode,
            step_mode=mode, kv_cache_dtype=dtype, lm=lm,
            profile=dtype == "int8",
            windows=LEGACY_WINDOWS if mode == "legacy" else ("first",
                                                             "last"))
        quant_serve[key] = launches[key]
        phase_ms[mode, dtype] = ms
        base_streams.setdefault(mode, streams)
        same = sum(list(a) == list(b)
                   for a, b in zip(streams, base_streams[mode]))
        print(f"(information, not a check: {same} of 8 {dtype or 'float32'} "
              f"{mode} streams equal this phase's float32 streams; {ms:.2f} "
              f"ms/step vs {phase_ms[mode, None]:.2f} for float32 pools in "
              f"this phase at {SERVE_DEPTH} layers, {serve_ms:.2f} in phase 5 "
              f"at 24)")
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
        "threefry Gumbel noise); the parent's top-k threshold, torch.topk, "
        "is timed beside it")
  mix = _SassLoopMix(cuda_build, "sample_tokens", "SampleAllKernel")
  if mix is not None:
    n = 264 * 32000
    ops = mix["ops"]
    alu = sum(ops.get(k, 0) for k in ("SHF", "LOP3", "ISETP"))
    imad = ops.get("IMAD", 0)
    print(f"sample_tokens full-row element loop (SASS, per element of the "
          f"{mix['loads']} it loads): {mix['total']:g} instructions, "
          f"{mix['int']:g} integer, {mix['float']:g} float, "
          f"{mix['other']:g} other; by pipe: {alu:g} shift / logic / "
          f"compare (ALU pipe only), {imad:g} IMAD (FMA pipe), "
          f"{mix['int'] - alu - imad:g} other integer; the algorithm counts "
          f"{st.INT_OPS_PER_ELEMENT} int32 operations, "
          f"{st.ALU_OPS_PER_ELEMENT} of them ALU-only; at [264, 32000] the "
          f"compiled loop's ALU-only instructions take "
          f"{n * alu / INT32_OPS_PER_S * 1e3:.4f} ms at 64 lanes an SM a "
          f"clock, its instructions "
          f"{n * mix['total'] / INSTRUCTIONS_PER_S * 1e3:.4f} ms at 128; by "
          f"opcode { {k: round(c, 2) for k, c in ops.items()} }")
  # the four shapes of the sampled steps (the ragged step's T = 264 packed
  # tokens and GShardDecode's 8 rows, top_k 0 and 40), and the ragged
  # step's draw since it draws only the rows it commits: R' = 8 of 264
  samp = {(r, f, k): _CheckSample(torch, st, threefry, r, f, k,
                                  seed=23 + k + r, mix=mix, time_it=True)
          for r, f in ((264, 2), (8, 1)) for k in (0, 40)}
  rows8 = [3, 40, 77, 111, 150, 199, 230, 263]
  for k in (0, 40):
    samp[264, 2, k, "rows"] = _CheckSample(
        torch, st, threefry, 264, 2, k, seed=31 + k, mix=mix, rows=rows8,
        time_it=True)
  tiny_sample = dict(temperature=0.8, top_k=5, sample_seed=3)
  for mode in ("ragged", "legacy"):
    _TinyReference(torch, spi.DenseLmTiny(), engine, ragged, step_mode=mode,
                   sample=tiny_sample)
  sample = dict(temperature=0.8, top_k=40, sample_seed=3)
  seeds = list(range(100, 108))
  cfg = spi.DenseLm1B()
  lm = _ServingLm(torch, cfg)
  sample_syncs = {}
  sample_launches, sample_steps, sampled, sample_ms = _ServeMain(
      torch, cfg, engine, counters,
      dict(ragged_block_attend=24, sample_tokens=1), lm=lm, sample=sample,
      seeds=seeds, syncs=sample_syncs)
  drawn, widest = counters.served_rows["sample_tokens"]
  _Check(0 < widest <= cfg.BATCH_SIZE and drawn <= cfg.BATCH_SIZE
         * sample_steps, f"sampled DenseLm1B: the steps drew {drawn} rows, "
         f"{widest} in the widest, of {sample_steps} steps")
  topk = {k: v for k, v in sample_syncs.items() if k.startswith("topk_")}
  _Check(topk and not any(topk.values()), f"sampled DenseLm1B: torch.topk "
         f"in the profiled steps: {topk}")
  print(f"sampled DenseLm1B: {sample_steps} steps drew {drawn} rows in all "
        f"({drawn / sample_steps:.2f} a step, at most {widest}, of the T = "
        f"264 packed tokens a step; one launch a step); profiled windows: "
        f"no torch.topk call or kernel ({topk})")
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
         f"then DenseLm1B (at {SERVE_DEPTH} of its 24 layers) at "
         "fprop_dtype=bfloat16 through ServingLoop and GShardDecode")
  bf16q, int8_bf16, bf16_serve, bf16_gshard, bf16_gshard_f32 = _Bf16Phase(
      torch, rba, bd, fd, im, ragged, spi, engine, attention, checkpointer,
      gshard, counters, prompt_lens)

  _Phase("25. hybrid and pure-SSM batch decode through GShardDecode, and "
         "the paged steps' gather-dense fallback")
  ssm_decode, pure_ssm, fallback = _SsmDecodePhase(
      torch, ssd, fd, spi, engine, attention, checkpointer, gshard, counters)

  _Phase("26. the trainer CLI: the xent kernel at DenseLmWord793k's shape, "
         "then DenseLmWord793k and DenseLmTiny through trainer.main")
  xent793, cli = _CliPhase(torch, fx, spi, counters)

  _Phase("27. the hybrid's training: the scan's backward kernel, then "
         "DenseLmSsmHybrid through trainer.main, its tiny twin card vs "
         "CPU, and the bfloat16 half")
  bwd, bwd_s0, hyb, hyb16 = _HybridTrainPhase(
      torch, ssd, spi, engine, ragged, attention, checkpointer, gshard,
      counters)

  _Phase("28. the 1B-words configs: the xent kernel at the sampled eval's "
         "shape, WordLevelOneBwdsSampledSoftmax through trainer.main, "
         "OneBWdsTransformerLm, the tiny sampled twin card vs CPU")
  xent1bw, cli1bw, tlm1bw, twin1bw = _OneBWdsPhase(torch, fx, threefry,
                                                   counters)

  _Phase("29. the trainer's remaining training surface: distillation of "
         "DenseLm1B into an 8-layer student with two learners (Adam, "
         "DistributedShampoo), the EMA and pruning through trainer.main; two "
         "tasks through a MultiTaskProgramSchedule; the tiny twins card vs "
         "CPU")
  distill29, dnum29, mt29, eigh29, twins29 = _TrainSurfacePhase(
      torch, spi, counters)

  _Phase("30. result")
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
      "max_abs_err": max(r["err"] for r in scan_cases + tuple(
          ssm_decode["scans"])),
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
      "local_bytes": scan_serve["geometry"]["local"],
      # the hybrid's GShardDecode prefill: layer 0's chunks 1 (zero s0)
      # and 2 (the carried s0), [8, 160, 16] with S = H = 64
      "decode_prefill_ms": [r["ms"] for r in ssm_decode["scans"]],
      "decode_prefill_plain_ms": [r["plain_ms"] for r in ssm_decode["scans"]],
      "decode_prefill_bound_ms": [r["live_bound"][0]
                                  for r in ssm_decode["scans"]],
      "decode_prefill_bound_by": [r["live_bound"][1]
                                  for r in ssm_decode["scans"]],
      "gshard_hybrid_launches": ssm_decode["launches"]["ssd_scan"],
      "gshard_pure_ssm_launches": pure_ssm[16][0]["ssd_scan"],
      # the hybrid's training through trainer.main (phase 27)
      "train_cli_launches": hyb["launches"]["ssd_scan"]}, {
      "name": "ssd_scan_bwd", "route": "cuda",
      "source": "lingvo_tpu_torch/ops/csrc/ssd_scan_bwd.cu",
      "replaces": None,
      "note": ("replaces no pallas_call: the reference's backward "
               "_PallasScanBwd (lingvo_tpu/ops/ssd_scan.py:260) is the VJP "
               "of its XLA chunked path, recomputed"),
      "launches": hyb["launches"]["ssd_scan_bwd"],
      "max_abs_err": max(bwd["err"], bwd_s0["err"]),
      "max_err_over_max_plain": max(bwd["rel"], bwd_s0["rel"]),
      "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
      "bound_ms": bwd["bound"][0], "bound_by": bwd["bound"][1],
      "library_ms": None,
      "registers": [bwd["geometry"]["sweep_regs"],
                    bwd["geometry"]["chunk_regs"]],
      "local_bytes": [bwd["geometry"]["sweep_local"],
                      bwd["geometry"]["chunk_local"]],
      "bf16_step_launches": hyb16["step_launches"]["ssd_scan_bwd"],
      "shape": ("[8, 1024, 16], S = H = 64, chunk 64: DenseLmSsmHybrid's "
                "training shape, packed resets and a padded tail; launches "
                "from its 20 train steps through trainer.main")}]
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
        "library_ms": res["library_ms"],
        # phase 29: the distillation run and its resume, the multi-task run
        "distill_cli_launches": [run[name] for run in distill29],
        "multitask_launches": mt29[name]})
  kernels.append({
      "name": "fused_xent_fwd", "route": "cuda",
      "source": "lingvo_tpu_torch/ops/csrc/fused_xent.cu",
      "replaces": "lingvo_tpu/ops/fused_xent.py:277",
      "launches": train_launches["fused_xent_fwd"],
      "max_abs_err": xent["err"], "ms": xent["ms"],
      "plain_ms": xent["plain_ms"], "bound_ms": xent["bound"][0],
      "bound_by": xent["bound"][1], "library_ms": None,
      "multitask_launches": mt29["fused_xent_fwd"]})
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
  hybrid_fdec = ssm_decode["fdec"][HYBRID_BUCKET + HYBRID_STEPS - 1]
  kernels.append({
      "name": "flash_decode", "route": "cuda",
      "source": "lingvo_tpu_torch/ops/csrc/flash_decode.cu",
      "replaces": "lingvo_tpu/ops/flash_decode.py:208",
      "launches": gshard_launches["flash_decode"],
      "max_abs_err": max(r["err"] for r in list(fdec.values())
                         + list(ssm_decode["fdec"].values())),
      "ms": main_fdec["ms"], "plain_ms": main_fdec["plain_ms"],
      "bound_ms": main_fdec["bound"][0], "bound_by": main_fdec["bound"][1],
      "library_ms": main_fdec["library_ms"],
      # the hybrid's GShardDecode step: [8, 512, 16, 64] at t 511
      "hybrid_ms": hybrid_fdec["ms"], "hybrid_plain_ms": hybrid_fdec["plain_ms"],
      "hybrid_bound_ms": hybrid_fdec["bound"][0],
      "hybrid_bound_by": hybrid_fdec["bound"][1],
      "hybrid_library_ms": hybrid_fdec["library_ms"],
      "gshard_hybrid_launches": ssm_decode["launches"]["flash_decode"]})
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
  kernels.append({
      "name": "fused_xent_fwd_word793k", "route": "cuda",
      "source": "lingvo_tpu_torch/ops/csrc/fused_xent.cu",
      "replaces": "lingvo_tpu/ops/fused_xent.py:277",
      "launches": cli["launches"]["fused_xent_fwd"],
      "max_abs_err": xent793["err"], "ms": xent793["ms"],
      "plain_ms": xent793["plain_ms"], "bound_ms": xent793["bound"][0],
      "bound_by": xent793["bound"][1], "library_ms": None,
      "shape": "x [2048, 1024] x table [793600, 1024] float32, cap 30: "
               "DenseLmWord793k through trainer.main",
      "cli_ms_per_step": cli["ms_step"],
      "cli_steady_ms_per_step": cli["steady_ms_step"],
      "cli_eval_s": cli["eval_s"]})
  kernels.append({
      "name": "fused_xent_fwd_1bwds_eval", "route": "cuda",
      "source": "lingvo_tpu_torch/ops/csrc/fused_xent.cu",
      "replaces": "lingvo_tpu/ops/fused_xent.py:277",
      "launches": cli1bw["launches"]["fused_xent_fwd"],
      "max_abs_err": xent1bw["err"], "ms": xent1bw["ms"],
      "plain_ms": xent1bw["plain_ms"], "bound_ms": xent1bw["bound"][0],
      "bound_by": xent1bw["bound"][1], "library_ms": None,
      "shape": "x [16384, 1024] x table [793470, 1024] float32 with a "
               "bias, no cap: WordLevelOneBwdsSampledSoftmax's eval through "
               "trainer.main",
      "cli_ms_per_step": cli1bw["ms_step"], "cli_eval_s": cli1bw["eval_s"],
      "dropout_masks_a_step": cli1bw["masks"],
      "dropout_mask_ms": cli1bw["mask_ms"],
      "train_step_host_syncs": cli1bw["syncs"],
      "negative_ids_card_vs_cpu_differing": twin1bw["ids_off"]})
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
  # the main path's draw: the ragged step's committed rows, R' = 8 of
  # its T = 264 packed tokens, top_k 40
  main_samp, gshard_samp = samp[264, 2, 40, "rows"], samp[8, 1, 40]
  kernels.append({
      "name": "sample_tokens", "route": "cuda",
      "source": "lingvo_tpu_torch/ops/csrc/sample_tokens.cu",
      "replaces": None,
      "note": ("replaces no pallas_call: the top-k threshold and the "
               "jax.random.categorical of lingvo_tpu/core/sampling.py:34 "
               "SampleFromLogits"),
      "launches": sample_launches["sample_tokens"],
      "max_abs_err": max(r["err"] for r in samp.values()),
      "max_ulps": max(r["ulps"] for r in samp.values()),
      "ms": main_samp["ms"], "plain_ms": main_samp["plain_ms"],
      "bound_ms": main_samp["bound"][0], "bound_by": main_samp["bound"][1],
      "library_ms": None,
      "parent_topk_ms": main_samp["topk_ms"],
      "times_ms": {f"[{r}, 32000]{' rows 8' if len(key) > 3 else ''} "
                   f"top_k {k}": dict(ms=res["ms"], bound_ms=res["bound"][0],
                                      plain_ms=res["plain_ms"],
                                      topk_ms=res["topk_ms"],
                                      cluster=res["cluster"])
                   for key, res in samp.items()
                   for r, k in [(key[0], key[2])]},
      "gshard_ms": gshard_samp["ms"],
      "gshard_bound_ms": gshard_samp["bound"][0],
      "gshard_launches": sample_gshard["sample_tokens"],
      "steps": sample_steps,
      "rows_drawn": drawn, "widest_draw": widest,
      "sass_int_per_element": None if mix is None else mix["int"],
      "sass_float_per_element": None if mix is None else mix["float"],
      "shape": ("8 rows of [264, 32000] float32 drawn in place (rows), "
                "top_k 40, (seed, position) folds")})
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
  print(f"phase 29, not a kernel: Shampoo's inverse root is "
        f"torch.linalg.eigh (cuSOLVER): {json.dumps(eigh29)}; the refresh "
        f"step {dnum29['refresh_ms']:.1f} ms against a plain step "
        f"{dnum29['plain_ms']:.1f} ms; tiny twins {twins29}")
  print(json.dumps({"kernels": kernels}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
