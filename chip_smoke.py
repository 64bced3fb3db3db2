#!/usr/bin/env python3
"""Drives the lingvo_tpu_torch port on one NVIDIA GPU, phase by phase.

    python3 chip_smoke.py

1. Versions, the card's name and power limit, the TF32 flags (off).
2. Builds every CUDA kernel of the port from the sources in this checkout.
3. Holds the ragged paged-attention kernel against its plain PyTorch
   version on the card, at the serving step's shapes (N=16, H=128, T=264,
   page_size 16 with 64-page tables, then page_size 128), on a pack of
   decode rows, two prefill chunks, a tree row with real ancestor masks and
   padding tokens, with freed pages, stale slots and table entries past
   each row's pages poisoned with NaN. Tolerance: float32, max abs
   difference <= 1e-5. Times the kernel, the plain version and the bound.
4. Serves DenseLm1B at full width and depth (random weights from a seeded
   torch.Generator) through `ServingLoop`: 8 requests with prompts of
   64..768 tokens, 32 new tokens each, through Start/Submit/Result/Stop.
   Checks the streams, and that the kernel ran exactly 24 times per step.
   Before that, a DenseLmTiny engine on the card must reproduce the same
   model's CPU streams (the CPU path is held against the JAX reference by
   tests/test_torch_*.py). After the counted run, the same requests are
   served again with torch.profiler on over the first 4 and the last 4
   steps, to show where the device time goes.
5. Prints the per-kernel JSON line, then the result line.

Exits non-zero, printing no result line, if any phase fails, if CUDA is
not available, or if the lingvo_tpu_torch package is not beside it.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32, CUDA cores (data sheet)
TOL = 1e-5


def _Phase(name):
  print(f"\n== {name}", flush=True)


def _Check(ok, msg):
  if not ok:
    raise RuntimeError(f"chip_smoke check failed: {msg}")


def _TimeMs(torch, fn, iters, flush_bytes=64 << 20):
  """Mean device ms of fn() over iters launches, each after an L2 flush
  (a 64 MB write), timed with CUDA events around fn alone."""
  scratch = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")
  fn()
  torch.cuda.synchronize()
  total = 0.0
  for _ in range(iters):
    scratch.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    total += start.elapsed_time(end)
  return total / iters


def _AttendPack(torch, ragged, page, rng):
  """The kernel-check pack at page size `page` (see the module docstring)."""
  n, h, t, b, max_seq = 16, 128, 264, 8, 1024
  t_pages = max_seq // page
  num_pages = 512 * 16 // page
  parents = np.array([-1, 0, 1, -1, 3, 4], np.int32)   # 2 branches of 3
  #          decode rows ........ | prefill | prefill | tree
  q_pos = [999, 516, 63, 32, 299, 256, 0, 700]
  lens = [1, 1, 1, 1, 1, 128, 120, 7]
  rows = ragged.BuildRaggedRows(lens, q_pos, t, 256, {7: parents})
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
  for pool in (k_pool, v_pool):
    pool[freed] = np.nan                      # freed pages
    for r in range(b):                        # stale slots past each row
      pool[owned[r][-1], row_end[r] - (need[r] - 1) * page:] = np.nan
  q = (rng.randn(t, n, h) / np.sqrt(h)).astype(np.float32)
  moved = (2 * sum(row_end) * n * h * 4        # each row's live K/V slots
           + 2 * q.nbytes                      # q read, out written
           + sum(need) * 4 + 5 * t * 4)        # live table entries, per-token ints
  flops = int(4 * q_end.astype(np.int64).sum() * n * h)
  cuda = {k: torch.as_tensor(v).cuda() for k, v in dict(
      q=q, k_pool=k_pool, v_pool=v_pool, tables=tables,
      row_of=rows.row_of, q_end=q_end, q_start=q_start,
      anc_lo=rows.anc_lo, anc_hi=rows.anc_hi).items()}
  return cuda, q_end == 0, moved, flops


def _CheckKernel(torch, rba, ragged, page, rng):
  x, pad, moved, flops = _AttendPack(torch, ragged, page, rng)
  args = (x["q"], x["k_pool"], x["v_pool"], x["tables"], x["row_of"],
          x["q_end"])
  tree = dict(q_start=x["q_start"], anc_lo=x["anc_lo"], anc_hi=x["anc_hi"])
  out = rba.RaggedAttend(*args, page_size=page, **tree)
  plain = rba._PlainRaggedAttend(*args, page, **tree)
  torch.cuda.synchronize()
  _Check(bool(torch.isfinite(out).all()), f"P={page}: non-finite output")
  _Check(bool((out[torch.as_tensor(pad).cuda()] == 0).all()),
         f"P={page}: padding outputs not exactly zero")
  err = float((out - plain).abs().max())
  _Check(err <= TOL, f"P={page}: kernel vs plain max abs err {err} > {TOL}")
  kernel_ms = _TimeMs(torch, lambda: rba.RaggedAttend(
      *args, page_size=page, **tree), iters=20)
  plain_ms = _TimeMs(torch, lambda: rba._PlainRaggedAttend(
      *args, page, **tree), iters=3)
  bytes_ms = moved / HBM_BYTES_PER_S * 1e3
  ops_ms = flops / FP32_FLOPS_PER_S * 1e3
  res = dict(page_size=page, max_abs_err=err, kernel_ms=kernel_ms,
             plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
             bound_by="bytes" if bytes_ms >= ops_ms else "operations",
             bytes=moved, flops=flops, library_ms=None)
  print(json.dumps(res))
  return res


def _TinyReference(torch, spi, engine, ragged):
  """DenseLmTiny on the card against the same weights on the CPU."""
  p = spi.DenseLmTiny().Task()
  cpu_lm = p.Instantiate(device="cpu")
  cpu_lm.InstantiateVariables(torch.Generator("cpu").manual_seed(1))
  gpu_lm = p.Instantiate(device="cuda")
  gpu_lm.load_state_dict(cpu_lm.state_dict())
  rows = ragged.BuildRaggedRows([1, 9, 0, 4], [5, 0, 1, 2], 16, 9)
  ids = np.random.RandomState(3).randint(0, 128, size=(1, 16)).astype(np.int32)
  tables = np.arange(16, dtype=np.int32).reshape(4, 4)
  logits = {}
  for name, lm in (("cpu", cpu_lm), ("cuda", gpu_lm)):
    states = lm.InitPagedDecodeState(17, 8)
    with torch.no_grad():
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
    eng = engine.ServingLoop(lm, device=lm.device, **kw)
    streams[name] = eng.RunBatch(prompts, lens, max_new_tokens=8)
  _Check(np.array_equal(streams["cpu"], streams["cuda"]),
         f"tiny greedy streams differ:\n{streams['cpu']}\n{streams['cuda']}")
  print(f"tiny reference: logits max abs err {err:.3g} (<= 1e-4), "
        f"{len(lens)} greedy streams identical to the CPU path")


def _DevUs(e):
  return (getattr(e, "self_device_time_total", 0)
          or getattr(e, "self_cuda_time_total", 0))


def _Profile(torch, eng, prompts, steps, window=4):
  """Serves the same requests again, stepping inline, and profiles only
  two windows of `window` steps: the first (prefill chunks beside decode
  rows) and the last (decode only) of the `steps` the schedule takes.
  Prints, per window, device busy ms per step and its share of the wall,
  the GEMMs' and the ragged attention kernel's shares, and the top
  kernels."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  for pr in prompts:
    eng.Submit(pr, 32, eos_id=None)
  done = 0
  for label, start in (("first", 0), ("last", steps - window)):
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
    attn = sum(_DevUs(e) for e in kernels if "RaggedAttend" in e.key) / 1e3
    gemm = sum(_DevUs(e) for e in kernels
               if "gemm" in e.key.lower() or "cutlass" in e.key.lower()) / 1e3
    print(f"profiled the {label} {window} of {steps} steps: device busy "
          f"{busy_ms / window:.2f} ms/step ({busy_ms / wall_ms:.1%} of the "
          f"wall under the profiler, {wall_ms / window:.2f} ms/step), GEMMs "
          f"{gemm / busy_ms:.1%} of busy, ragged attention "
          f"{attn / busy_ms:.1%} of busy")
    for e in kernels[:5]:
      print(f"  {_DevUs(e) / 1e3:9.2f} ms  {e.count:6d} x  {e.key[:90]}")
  _Check(not eng.sched.HasWork() and done == steps,
         f"profiled re-run took more than the counted run's {steps} steps")


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
  from lingvo_tpu_torch.core import ragged
  from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
  from lingvo_tpu_torch.ops import cuda_build
  from lingvo_tpu_torch.ops import ragged_block_attend as rba
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

  _Phase("2. build kernels")
  t0 = time.perf_counter()
  cuda_build.Load("ragged_block_attend")
  print(f"built ragged_block_attend in {time.perf_counter() - t0:.2f} s")
  for line in cuda_build.BuildLog("ragged_block_attend").splitlines():
    if "registers" in line or "spill" in line:
      print(f"  {line.strip()}")

  _Phase("3. ragged attention kernel vs plain version (f32, tol 1e-5)")
  print("library_ms: null (no single PyTorch call computes paged ragged "
        "attention over block tables)")
  rng = np.random.RandomState(0)
  checks = [_CheckKernel(torch, rba, ragged, page, rng) for page in (16, 128)]

  _Phase("4. main path: DenseLm1B through ServingLoop")
  _TinyReference(torch, spi, engine, ragged)
  t0 = time.perf_counter()
  cfg = spi.DenseLm1B()
  lm = cfg.Task().Instantiate(device="cuda")
  lm.InstantiateVariables(torch.Generator("cuda").manual_seed(0))
  n_params = sum(p.numel() for p in lm.parameters())
  eng = engine.ServingLoop(lm, page_size=16, num_pages=512,
                           max_batch=cfg.BATCH_SIZE,
                           max_seq_len=cfg.SEQUENCE_LENGTH, prefill_chunk=256)
  torch.cuda.synchronize()
  print(f"DenseLm1B: {n_params / 1e9:.3f} B params, engine T="
        f"{eng._ragged_t}, built in {time.perf_counter() - t0:.1f} s")
  eng.RunBatch(np.arange(1, 33, dtype=np.int32)[None], [32],
               max_new_tokens=2)   # warm-up: cuBLAS handles, allocator
  prng = np.random.RandomState(1)
  lens = prng.permutation(np.linspace(64, 768, 8).astype(np.int32))
  prompts = [prng.randint(0, cfg.VOCAB_SIZE, size=n) for n in lens]
  steps0 = eng.Stats()["steps"]
  rba.RaggedAttend.launches = 0
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  eng.Start()
  handles = [eng.Submit(pr, 32, eos_id=None) for pr in prompts]
  streams = [h.Result(timeout=900) for h in handles]
  eng.Stop()
  wall = time.perf_counter() - t0
  launches = rba.RaggedAttend.launches
  steps = eng.Stats()["steps"] - steps0
  for s in streams:
    _Check(len(s) == 32 and all(0 <= x < cfg.VOCAB_SIZE for x in s),
           f"bad stream {s}")
  ttft = sorted(h.first_token_time - h.submit_time for h in handles)
  tpot = [(h.finish_time - h.first_token_time) / 31 for h in handles]
  _Check(launches == 24 * steps,
         f"kernel launches {launches} != 24 layers x {steps} steps")
  print(f"served 8 requests (prompts {sorted(lens.tolist())}): {steps} steps,"
        f" {wall / steps * 1e3:.2f} ms/step, "
        f"{8 * 32 / wall:.1f} generated tok/s, "
        f"{int(lens.sum()) / wall:.1f} prompt tok/s, kernel launches "
        f"{launches} = 24 x {steps}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
  print(f"time to first token: median {np.median(ttft) * 1e3:.1f} ms, max "
        f"{ttft[-1] * 1e3:.1f} ms; time per output token: mean "
        f"{np.mean(tpot) * 1e3:.2f} ms")
  _Profile(torch, eng, prompts, steps)

  _Phase("5. result")
  main_check = checks[0]
  kernel = {
      "name": "ragged_block_attend", "route": "cuda",
      "source": "lingvo_tpu_torch/ops/csrc/ragged_block_attend.cu",
      "replaces": "lingvo_tpu/ops/ragged_block_attend.py:252",
      "launches": launches,
      "max_abs_err": max(c["max_abs_err"] for c in checks),
      "ms": main_check["kernel_ms"], "plain_ms": main_check["plain_ms"],
      "bound_ms": main_check["bound_ms"], "bound_by": main_check["bound_by"],
      "library_ms": None}
  print(json.dumps({"kernels": [kernel]}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
