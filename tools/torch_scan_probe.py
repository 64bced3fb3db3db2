#!/usr/bin/env python3
"""Where the SSD-scan kernel's time goes: a per-block, per-phase split.

    python3 tools/torch_scan_probe.py [tree ...] [--out build/scan_probe]

For each checkout given (default: this one), writes a copy of its
`lingvo_tpu_torch/ops/csrc/ssd_scan.cu` in which thread 0 of every block
reads %globaltimer after a barrier at the phase edges, builds it with nvcc
(the port's flags) and loads it with ctypes. Then, at phase 4's mixed
serving pack, a decode-only pack (every row 1 live step of 256, the last
row idle) and the training shape ([8, 1024, 16], two segments of 512; S =
H = 64, chunk 64: `tools/torch_kernel_ab.py`'s `SCAN_CASES`, made by
`chip_smoke._ScanInputs`), it times each copy with
`chip_smoke._TimeMs` (the trees in order, then in reverse) and prints the
split of one traced call after an L2 flush: for the live and the identity
blocks, the median and 90th percentile of phase 1 (the run's loads, live
checks and U_j), the flag exchange, the carry for blocks that start it
(s0 and the send), chunk 0 before the carry (G and the intra product),
the wait for the carry, chunk 0 after it (the inter product and the
stores), chunk 1 (the same), and the block's whole time; and per cluster
rank, when the carry was in and when the block ended.

The barriers the stamps add make the traced copy a little slower than the
kernel; compare copies with each other, and the kernel's own time with
`tools/torch_kernel_ab.py`. Needs one CUDA card and imports no JAX.
"""

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS = 16   # per block: 12 stamps, then run_live, src, P and rank
# (anchor in the kernel source, slot expression, condition, before?)
STAMPS = (
    ("  ClusterArriveRelaxed();", "0", "true", True),
    ("  ClusterWait();\n  if (tid < C)", "1", "true", True),
    ("  int src = -1, next = -1, last_live = -1;", "2", "true", True),
    ("  bool carried = src < 0;", "3", "true", True),
    ("    const bool advance = live && i + 1 < P;\n", "4 + 3 * i", "i < 2",
     True),
    ("    if (!carried) {", "5 + 3 * i", "i < 2", True),
    ("      MbarWaitCluster(bar, 0);\n", "10", "true", False),
    ("    if (!cached && !ring && i + 1 < P) {", "6 + 3 * i", "i < 2", True),
)


def _Traced(tree, out):
  """The tree's kernel with the stamps, written to `out`."""
  csrc = os.path.join(os.path.abspath(tree), "lingvo_tpu_torch", "ops",
                      "csrc")
  src = open(os.path.join(csrc, "ssd_scan.cu")).read()
  src = src.replace('#include "hopper.cuh"',
                    f'#include "{os.path.join(csrc, "hopper.cuh")}"')
  slot = "g_trace[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 16 + ({})]"

  def Stamp(expr, cond):
    return (f"  if ({cond}) __syncthreads();\n"
            f"  if (threadIdx.x == 0 && ({cond})) {{ unsigned long long t_; "
            'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
            f"{slot.format(expr)} = t_; }}\n")

  src = src.replace("namespace cg = cooperative_groups;",
                    "namespace cg = cooperative_groups;\n"
                    "__device__ unsigned long long g_trace[1 << 21];\n", 1)
  for anchor, expr, cond, before in STAMPS:
    if anchor not in src:
      raise RuntimeError(f"{tree}: the kernel has no {anchor.strip()!r}")
    text = Stamp(expr, cond)
    src = src.replace(anchor, text + anchor if before else anchor + text, 1)
  end = src.index("template <int kThreads>\ncudaError_t AllowSmem")
  end = src.rindex("}", 0, end)   # the kernel's closing brace
  src = (src[:end] + Stamp("11", "true")
         + "  if (threadIdx.x == 0) { int* f = (int*)&" + slot.format(12)
         + "; f[0] = run_live; f[1] = src; f[2] = P; f[3] = k; }\n"
         + src[end:])
  src += """
extern "C" int SsdScanTrace(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_trace, 8 * (size_t)n);
}
extern "C" int SsdScanTraceClear() {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, g_trace);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(g_trace));
  return (int)err;
}
"""
  with open(out, "w") as f:
    f.write(src)


def _Module(name, path):
  spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _Load(cuda_build, cu):
  so = cu[:-3] + ".so"
  proc = subprocess.run([cuda_build._Nvcc(), *cuda_build.NVCC_FLAGS, "-o", so,
                         cu], capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(proc.stdout + proc.stderr)
  for line in (proc.stdout + proc.stderr).splitlines():
    if "registers" in line or "spill" in line:
      print(f"  {line.strip()}")
  lib = ctypes.CDLL(os.path.abspath(so))
  vp, ci = ctypes.c_void_p, ctypes.c_int
  lib.SsdScanF32.argtypes = [vp] * 7 + [ci] * 6 + [vp]
  lib.SsdScanTrace.argtypes = [vp, ci]
  lib.SsdScanTraceClear.argtypes = []
  return lib


def _Split(a):
  """Prints the per-phase split of one traced call (rows of SLOTS words)."""
  a = a[a[:, 0] > 0]
  info = a[:, 12:14].copy().view(np.int32).reshape(len(a), 4)
  ts = a[:, :12].astype(np.int64)
  rel = np.where(ts > 0, (ts - ts[:, 0].min()) / 1e3, np.nan)

  def Q(d):
    d = d[~np.isnan(d)]
    return (f"{np.median(d):.2f}/{np.percentile(d, 90):.2f}" if len(d)
            else "-")

  carried = np.fmax(rel[:, 10], rel[:, 3])
  print(f"  {len(a)} blocks, span {np.nanmax(rel[:, 11]):.1f} us; phases in "
        "us, median/p90")
  for name, m in (("live", info[:, 0] == 1), ("identity", info[:, 0] == 0)):
    if m.any():
      r = rel[m]
      print(f"  {name} ({m.sum()}): phase 1 {Q(r[:, 1] - r[:, 0])}, "
            f"exchange {Q(r[:, 2] - r[:, 1])}, s0 and send "
            f"{Q(r[:, 3] - r[:, 2])}, chunk 0 before the carry "
            f"{Q(r[:, 5] - r[:, 4])}, wait {Q(r[:, 10] - r[:, 5])}, chunk 0 "
            f"after {Q(r[:, 6] - np.fmax(r[:, 10], r[:, 5]))}, chunk 1 "
            f"{Q(r[:, 9] - r[:, 7])}, block {Q(r[:, 11] - r[:, 0])}")
  for rank in range(8):
    m = info[:, 3] == rank
    if m.any():
      print(f"  rank {rank}: carry in at {Q(carried[m] - rel[m, 0])}, end "
            f"{Q(rel[m, 11] - rel[m, 0])}")


def main():
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("trees", nargs="*", default=[REPO])
  ap.add_argument("--out", default=os.path.join(REPO, "build", "scan_probe"))
  args = ap.parse_args()
  import torch
  if not torch.cuda.is_available():
    print("torch_scan_probe: no CUDA device", file=sys.stderr)
    return 1
  sys.path.insert(0, REPO)
  from lingvo_tpu_torch.ops import cuda_build
  from lingvo_tpu_torch.ops import ssd_scan as ssd
  cs, ab = (_Module(name, path) for name, path in (
      ("chip_smoke", "chip_smoke.py"),
      ("torch_kernel_ab", os.path.join("tools", "torch_kernel_ab.py"))))
  torch.backends.cuda.matmul.allow_tf32 = False
  os.makedirs(args.out, exist_ok=True)
  print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
  libs = []
  for i, tree in enumerate(args.trees):
    print(f"tree {i}: {tree}")
    cu = os.path.join(args.out, f"ssd_scan_{i}.cu")
    _Traced(tree, cu)
    libs.append(_Load(cuda_build, cu))
  for label, t, live, resets, with_s0, seed in ab.SCAN_CASES:
    x, _ = cs._ScanInputs(torch, ssd, np.random.RandomState(seed), t, live,
                          resets, with_s0)
    dl, b, c, v = x[:4]
    s0 = x[4] if with_s0 else None
    want = ssd.SsdScan(dl, b, c, v, s0=s0, chunk_size=64, lowering="chunked")
    rows, n = dl.shape[0], dl.shape[2]
    s_dim, h = b.shape[-1], v.shape[-1]
    y = torch.empty_like(v)
    s_fin = torch.empty((rows, n, h, s_dim), device="cuda")
    shape = (rows, t, n, s_dim, h, 64)   # batch, T, N, S, H, chunk
    order = list(range(len(libs)))
    for i in order + order[::-1]:
      lib = libs[i]

      def Call():
        rc = lib.SsdScanF32(
            dl.data_ptr(), b.data_ptr(), c.data_ptr(), v.data_ptr(),
            s0.data_ptr() if s0 is not None else None, y.data_ptr(),
            s_fin.data_ptr(), *shape, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
          raise RuntimeError(f"launch failed: {rc}")

      ms = cs._TimeMs(torch, Call, 20)
      err = max(float((y - want[0]).abs().max()),
                float((s_fin - want[1]).abs().max()))
      print(f"{label}, tree {i}: traced copy {ms * 1e3:.1f} us, max abs err "
            f"against the plain version {err:.3g}", flush=True)
    for i, lib in enumerate(libs):
      if lib.SsdScanTraceClear() != 0:
        raise RuntimeError("clearing the stamps failed")
      flush = torch.empty(16 << 20, device="cuda")
      flush.zero_()
      torch.cuda.synchronize()
      lib.SsdScanF32(dl.data_ptr(), b.data_ptr(), c.data_ptr(), v.data_ptr(),
                     s0.data_ptr() if s0 is not None else None, y.data_ptr(),
                     s_fin.data_ptr(), *shape,
                     torch.cuda.current_stream().cuda_stream)
      torch.cuda.synchronize()
      words = 4096 * SLOTS
      buf = (ctypes.c_ulonglong * words)()
      if lib.SsdScanTrace(buf, words) != 0:
        raise RuntimeError("reading the stamps failed")
      print(f"{label}, tree {i}:")
      _Split(np.frombuffer(buf, dtype=np.uint64).reshape(-1, SLOTS).copy())
  return 0


if __name__ == "__main__":
  sys.exit(main())
