#!/usr/bin/env python3
"""Times the int8 serving kernels of one or more checkouts of the port on one card.

    python3 tools/torch_int8_probe.py [tree ...] [--out build/int8_probe]

With no tree, times this checkout. Each tree's `lingvo_tpu_torch` is
imported in a child process of its own (the packages share one name); with
several trees the children run in the order given and then in reverse
(A, B, B, A), so that a drift of the card shows as a difference between
two runs of one tree. A child builds the tree's `ops/csrc/int8_matmul.cu`
and runs this checkout's `chip_smoke._CheckInt8Gemm` on it at the 145
products of a DenseLm1B step with m = 264 and m = 8 rows: kernels (a) and
(b) bitwise against their plain versions, then each kernel's device time,
both from one `Int8Matmul` call, beside the bound, torch._int_mm (at m =
8 on x8 padded to 24 rows) and the float32 matmul; then
`chip_smoke._CheckInt8Bf16`, the bfloat16 instantiations at the same
shapes; then kernel (a) at the largest x of the ported paths, [2048,
8192] float32. Prints the card, each child's lines, and one JSON line per
child with the step sums; child logs go to --out. Needs one CUDA card and
imports no JAX. For the parent against this checkout:

    git archive HEAD~1 | (mkdir -p build/parent && tar -x -C build/parent)
    python3 tools/torch_int8_probe.py build/parent .
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KEYS = ("a_ms", "b_ms", "ab_ms", "a_plain_ms", "b_plain_ms", "a_bound",
         "b_bound", "int_mm_ms", "int_mm_pad_ms", "f32_ms")
_BF16_KEYS = ("a_ms", "b_ms", "a_bound", "b_bound")


def _Child(tree):
  tree = os.path.abspath(tree)
  sys.path.insert(0, tree)
  import torch
  from lingvo_tpu_torch.ops import int8_matmul as im
  if not os.path.dirname(im.__file__).startswith(tree):
    raise RuntimeError(f"imported {im.__file__}, not the tree {tree}")
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
  cs = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(cs)
  torch.backends.cuda.matmul.allow_tf32 = False
  res = {"tree": tree}
  for m in (264, 8):
    step = cs._CheckInt8Gemm(torch, im, np.random.RandomState(21), m)
    res.update({f"m{m}_{k}": step[k] for k in _KEYS})
  for m, step in cs._CheckInt8Bf16(torch, im,
                                   np.random.RandomState(27)).items():
    res.update({f"bf16_m{m}_{k}": step[k] for k in _BF16_KEYS})
  # the largest x of the ported paths: a legacy mixed step's FFN output
  # projection, [B x C, 8192] = [2048, 8192] float32 (64 MB)
  x = torch.as_tensor(np.random.RandomState(4).randn(2048, 8192).astype(
      np.float32)).cuda()
  res["a_2048x8192_ms"] = cs._TimeMs(torch,
                                     lambda: im.QuantizeActivations(x), 20)
  print(f"kernel (a) at [2048, 8192] float32: {res['a_2048x8192_ms']:.4f} ms",
        flush=True)
  print(json.dumps(res), flush=True)


def _Sweep():
  """Attribution by sweep, this checkout only: each kernel at a few step
  shapes under every launch plan its C entry takes (kernel (a): 1 to 8
  blocks, rows held or all read twice; kernel (b): every K split), beside
  the timing's floor (one tiny elementwise kernel and the smallest launch
  of each kernel). One line a launch."""
  sys.path.insert(0, REPO)
  import torch
  from lingvo_tpu_torch.ops import int8_matmul as im
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
  cs = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(cs)
  lib, rng = im._Lib(), np.random.RandomState(5)
  stream = torch.cuda.current_stream().cuda_stream

  def Check(rc, what):
    if rc != 0:
      raise RuntimeError(f"{what}: {lib.Int8MatmulErrorString(rc).decode()}")

  tiny = torch.zeros(16, device="cuda")
  floor_ms = cs._TimeMs(torch, lambda: tiny.add_(1), 50)
  print(f"floor: one 16-element add_ {floor_ms:.4f} ms", flush=True)
  for m, k in ((1, 16), (8, 2048), (264, 2048), (264, 8192)):
    x = torch.as_tensor(rng.randn(m, k).astype(np.float32)).cuda()
    kp = im.PaddedK(k)
    x8 = torch.empty((m * kp + 16,), dtype=torch.int8, device="cuda")
    xs = x8[m * kp:m * kp + 4].view(torch.float32)
    want = im._PlainQuantize(x)[0]
    for blocks in (1, 2, 4, 8, 16):
      rows = -(-m // blocks)
      if -(-m // rows) != blocks:
        continue
      cap = im.QUANT_HOLD_BYTES // (4 * k)
      for held in sorted({min(rows, cap), 0}, reverse=True):
        def Run():
          Check(lib.Int8Quantize(x.data_ptr(), x8.data_ptr(), xs.data_ptr(),
                                 m, k, kp, blocks, rows, held, 0, stream),
                "Int8Quantize")
        Run()
        torch.cuda.synchronize()
        ok = torch.equal(x8[:m * kp].view(m, kp), want)
        ms = cs._TimeMs(torch, Run, 20)
        print(f"(a) [{m}, {k}] f32: {blocks} blocks x {rows} rows, {held} "
              f"held: {ms:.4f} ms{'' if ok else ' WRONG'}", flush=True)
  for m, k, n in ((1, 16, 8), (8, 2048, 2048), (264, 2048, 2048),
                  (8, 2048, 8192), (264, 2048, 8192), (8, 8192, 2048),
                  (264, 8192, 2048), (8, 2048, 32000), (264, 2048, 32000)):
    x8, xs = im.QuantizeActivations(
        torch.as_tensor(rng.randn(m, k).astype(np.float32)).cuda())
    w = torch.as_tensor(rng.randint(-128, 128, size=(n, k)).astype(
        np.int8)).cuda()
    ws = torch.as_tensor((rng.rand(n) * 1e-3).astype(np.float32)).cuda()
    y = torch.empty((m, n), device="cuda")
    want = im._PlainGemm(x8, xs, w, ws)
    plan = im.GemmPlan(m, k, n, torch.cuda.get_device_properties(0)
                       .multi_processor_count)
    side = "swapped" if plan["swap"] else "normal"
    kblocks = plan["kblocks"]
    for cluster in range(1, 9):
      per = -(-kblocks // cluster)
      if -(-kblocks // per) != cluster:
        continue
      def Run():
        Check(lib.Int8Gemm(x8.data_ptr(), w.data_ptr(), xs.data_ptr(),
                           ws.data_ptr(), y.data_ptr(), m, k, x8.shape[1], n,
                           int(plan["swap"]), plan["nb"], cluster, per, 0, 0,
                           stream), "Int8Gemm")
      Run()
      torch.cuda.synchronize()
      ok = torch.equal(y, want)
      mark = " (the plan's)" if cluster == plan["cluster"] else ""
      ms = cs._TimeMs(torch, Run, 20)
      print(f"(b) [{m}, {k}] x [{n}, {k}] {side}: cluster {cluster} x {per} "
            f"K blocks{mark}: {ms:.4f} ms{'' if ok else ' WRONG'}",
            flush=True)

# (anchor in int8_matmul.cu, stamp slot, condition, before?): the GEMM's
# entry, its first stage in (consumer thread 0), the main loop's end, the
# tile written and shared, the block's end; then the quantize kernel's
# entry, its pass over x done, the cluster's max known, the block's end
_GEMM_STAMPS = (
    ("  // x8's and the weight's places in a stage", 0, "tid_ == 0", True),
    ("      MbarWait(&full[s], (i / C::kStages) & 1);\n", 1,
     "i == 0 && tid_ == 0", False),
    ("    WgmmaWait<0>();\n", 2, "tid_ == 0", False),
    ("  GridDepWait();   // x_scale is the previous grid's output", 3,
     "tid_ == 0", True),
    ("  if (cluster) {\n    ClusterArrive();\n    ClusterWait();   // no block "
     "leaves", 4, "tid_ == 0", True),
)
_QUANT_STAMPS = (
    ("  GridDepLaunch();   // (b) may start streaming its weight now\n", 0,
     "tid_ == 0", False),
    ("  amax = BlockMax<kQThreads>(amax, red);", 1, "tid_ == 0", False),
    ("  const float inv = __frcp_rn(scale);\n", 2, "tid_ == 0", False),
    ("  if (blocks > 1) ClusterWait();   // 2:", 3, "tid_ == 0",
     True),
)


def _TracedLib(out):
  """This checkout's int8_matmul.cu with %globaltimer stamps (thread 0 of
  each block, at the edges above, no added barrier) and a TraceRead entry,
  built with the port's nvcc flags into `out` and loaded with ctypes."""
  from lingvo_tpu_torch.ops import cuda_build
  csrc = os.path.join(REPO, "lingvo_tpu_torch", "ops", "csrc")
  src = open(os.path.join(csrc, "int8_matmul.cu")).read()
  src = src.replace('#include "hopper.cuh"',
                    f'#include "{os.path.join(csrc, "hopper.cuh")}"\n'
                    "__device__ unsigned long long g_trace[2][1 << 20];")

  def Stamp(which, slot, cond):
    return (f"  {{ const int tid_ = threadIdx.x; if ({cond}) {{ "
            "unsigned long long t_; asm volatile(\"mov.u64 %0, "
            f"%%globaltimer;\" : \"=l\"(t_)); g_trace[{which}][blockIdx.x * 8 "
            f"+ {slot}] = t_; }} }}\n")

  for which, stamps in ((0, _GEMM_STAMPS), (1, _QUANT_STAMPS)):
    for anchor, slot, cond, before in stamps:
      if src.count(anchor) != 1:
        raise RuntimeError(f"int8_matmul.cu: {anchor.strip()!r} is not one "
                           "line of the kernel")
      text = Stamp(which, slot, cond)
      src = src.replace(anchor, text + anchor if before else anchor + text)
  src += ('\nextern "C" int TraceRead(unsigned long long* dst, int which, '
          "int n) {\n  return static_cast<int>(cudaMemcpyFromSymbol(dst, "
          "g_trace, sizeof(unsigned long long) * n, sizeof(unsigned long "
          "long) * (1 << 20) * which, cudaMemcpyDeviceToHost));\n}\n")
  os.makedirs(out, exist_ok=True)
  cu = os.path.join(out, "int8_matmul_traced.cu")
  lib = os.path.join(out, "int8_matmul_traced.so")
  with open(cu, "w") as f:
    f.write(src)
  proc = subprocess.run([cuda_build._Nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib,
                         cu], capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
  return ctypes.CDLL(lib)


def _Trace(out):
  """Where a call's time goes, block by block: each kernel at the step's
  shapes (m = 264 and 8) once after an L2 flush, through the traced copy.
  Prints, over the blocks of the call, the median and 90th percentile of
  each phase in us, when the blocks started after the first, and the call's
  span from the first block's start to the last block's end."""
  sys.path.insert(0, REPO)
  import torch
  from lingvo_tpu_torch.ops import int8_matmul as im
  lib = _TracedLib(out)
  im._lib = None
  base = im._Lib()   # declares the C signatures; the traced copy takes them
  for name in ("Int8Quantize", "Int8Gemm", "Int8Matmul", "Int8GemmOccupancy",
               "Int8QuantizeMaxBlocks", "Int8MatmulErrorString"):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = getattr(base, name).argtypes, getattr(
        base, name).restype
  lib.TraceRead.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
  im._lib = lib
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  scratch = torch.empty(16 << 20, device="cuda")
  rng = np.random.RandomState(3)
  buf = np.zeros(8 << 16, dtype=np.uint64)

  def Read(which, blocks):
    rc = lib.TraceRead(buf.ctypes.data, which, blocks * 8)
    if rc != 0:
      raise RuntimeError(f"TraceRead: rc {rc}")
    return buf[:blocks * 8].reshape(blocks, 8).astype(np.int64)

  def Stats(t, names):
    t0 = t[:, 0].min()
    cols = [f"start after the first {np.median(t[:, 0] - t0) / 1e3:.2f} / "
            f"{(t[:, 0] - t0).max() / 1e3:.2f}"]
    for i, name in enumerate(names):
      d = (t[:, i + 1] - t[:, i]) / 1e3
      cols.append(f"{name} {np.median(d):.2f} / {np.percentile(d, 90):.2f}")
    span = (t[:, len(names)].max() - t0) / 1e3
    return "; ".join(cols) + f"; span {span:.2f} us"

  for m in (264, 8):
    for k, n, _ in ((2048, 2048, 0), (2048, 8192, 0), (8192, 2048, 0),
                    (2048, 32000, 0)):
      x = torch.as_tensor(rng.randn(m, k).astype(np.float32)).cuda()
      w = torch.as_tensor(rng.randint(-128, 128, size=(n, k)).astype(
          np.int8)).cuda()
      ws = torch.as_tensor((rng.rand(n) * 1e-3).astype(np.float32)).cuda()
      for _ in range(3):   # warm, then the traced call
        scratch.zero_()
        x8, xs = im.QuantizeActivations(x)
        scratch.zero_()
        im.Int8Gemm(x8, xs, w, ws)
      torch.cuda.synchronize()
      q = im.QuantizePlan(m, k, 4, im.QuantizeMaxBlocks(0))
      g = im.GemmPlan(m, k, n, sms)
      print(f"(a) [{m}, {k}], {q['blocks']} blocks (median / p90 us): "
            + Stats(Read(1, q["blocks"]), ("pass over x", "cluster max",
                                           "quantize")), flush=True)
      print(f"(b) [{m}, {k}] x [{n}, {k}], {g['blocks']} blocks, cluster "
            f"{g['cluster']}: " + Stats(Read(0, g["blocks"]), (
                "to the first stage", "main loop", "tile shared",
                "sum and store")), flush=True)


def main():
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("trees", nargs="*", default=[REPO])
  ap.add_argument("--out", default="build/int8_probe")
  ap.add_argument("--sweep", action="store_true",
                  help="time this checkout's kernels under every launch "
                  "plan at a few shapes instead")
  ap.add_argument("--trace", action="store_true",
                  help="split one call of each kernel into phases, block by "
                  "block, with %%globaltimer stamps in a copy of this "
                  "checkout's source")
  ap.add_argument("--child", help=argparse.SUPPRESS)
  args = ap.parse_args()
  if args.child:
    _Child(args.child)
    return 0
  import torch
  if not torch.cuda.is_available():
    print("torch_int8_probe: no CUDA device", file=sys.stderr)
    return 1
  if args.sweep:
    _Sweep()
    return 0
  if args.trace:
    _Trace(args.out)
    return 0
  os.makedirs(args.out, exist_ok=True)
  print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip(), flush=True)
  order = list(args.trees) + (list(reversed(args.trees))
                              if len(args.trees) > 1 else [])
  for i, tree in enumerate(order):
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", tree],
        capture_output=True, text=True)
    with open(os.path.join(args.out, f"child_{i}.log"), "w") as f:
      f.write(proc.stdout + proc.stderr)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
      sys.stderr.write(proc.stderr[-4000:])
      print(f"child {i} ({tree}) failed: rc {proc.returncode}")
      return 1
  return 0


if __name__ == "__main__":
  sys.exit(main())
