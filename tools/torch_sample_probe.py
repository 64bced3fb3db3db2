#!/usr/bin/env python3
"""Times the sampling kernel of two checkouts of the port against each other on one card, in one process.

    python3 tools/torch_sample_probe.py [tree ...] [--out build/sample_probe]
    python3 tools/torch_sample_probe.py --sweep

With no tree, times this checkout. Each tree's
`lingvo_tpu_torch/ops/csrc/sample_tokens.cu` is built with nvcc into a
library of its own (plain C, loaded with ctypes), so that all of them run
in this one process on the same inputs; with several trees the runs go in
the order given and then in reverse (A, B, B, A), so that a drift of the
card shows as a difference between two runs of one tree. Two C interfaces
are known, told apart by the library's symbols:

- a threshold taken outside (before the redesign): `SampleTokens(logits,
  fold, f, thr, ...)`, one block a row; its top-k threshold is
  `torch.topk` of the raw row times the reciprocal of the temperature,
  timed beside the kernel (the call the sampled step made) and in one
  lambda with it;
- the threshold inside (`SampleTokensFit` present): `SampleTokens(logits,
  rows, fold, f, ..., top_k, ..., cluster, chunk, ...)`, launched with
  this checkout's `sample_tokens.Plan` on the tree's own `SampleTokensFit`.

Shapes: [264, 32000] (the ragged step's T packed tokens before the
serving steps drew only their committed rows) and [8, 32000] (GShardDecode's
step, and the ragged step's draw since), top_k 40 and 0 (the full
vocabulary), T = 0.7, the engine's (seed, position) folds. Every run's
tokens and winning values must equal the first run's at the same shape,
bit for bit. Prints the card's name and power limit, one line a run and
shape, and one JSON line of the means by tree; the build logs go to
--out. `--sweep` times each tree's kernel (one with the threshold inside)
at every cluster size of the four shapes beside the plan's choice;
`--trace` builds a copy of the first tree's kernel with %globaltimer
stamps at its phase edges (anchored on lines of the source: it names the
one that is missing after an edit) and prints each masked call's phases. Needs one CUDA card and imports no
JAX. For the parent against this checkout:

    git archive HEAD~1 | (mkdir -p build/parent && tar -x -C build/parent)
    python3 tools/torch_sample_probe.py build/parent .
"""

import argparse
import concurrent.futures
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((264, 40), (8, 40), (8, 0), (264, 0))   # (rows, top_k), V 32000
V = 32000
TEMPERATURE = 0.7


def _ChipSmoke():
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
  cs = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(cs)
  return cs


def _Build(tree, out):
  """tree's sample_tokens.cu built into its own library under out."""
  sys.path.insert(0, REPO)
  from lingvo_tpu_torch.ops import cuda_build
  csrc = os.path.join(os.path.abspath(tree), "lingvo_tpu_torch", "ops",
                      "csrc")
  src = os.path.join(csrc, "sample_tokens.cu")
  digest = hashlib.sha256(open(src, "rb").read())
  for name in sorted(os.listdir(csrc)):
    if name.endswith(".cuh"):
      digest.update(open(os.path.join(csrc, name), "rb").read())
  lib = os.path.join(out, f"sample_tokens-{digest.hexdigest()[:16]}.so")
  proc = subprocess.run([cuda_build._Nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                         lib, src], capture_output=True, text=True)
  with open(lib + ".log", "w") as f:
    f.write(proc.stdout + proc.stderr)
  if proc.returncode != 0:
    raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
  return lib


class _Kernel:
  """One tree's sampling kernel: draw(x, fold, key, top_k) -> (tokens,
  zmax), and the parts a call makes (the kernel, and torch.topk where
  the threshold is taken outside)."""

  def __init__(self, torch, path):
    from lingvo_tpu_torch.core import jit_arith
    from lingvo_tpu_torch.ops import sample_tokens as st
    self.torch, self.st = torch, st
    self.inv_t = jit_arith.Reciprocal(TEMPERATURE)
    self.lib = lib = ctypes.CDLL(path)
    vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    self.inside = hasattr(lib, "SampleTokensFit")
    if self.inside:
      lib.SampleTokens.argtypes = [vp, vp, vp, ci, cu, cu, ctypes.c_float,
                                   ci, ci, ci, ci, ci, ci, vp, vp, vp]
      lib.SampleTokensFit.argtypes = [ci, ci, ci, ctypes.POINTER(ci),
                                      ctypes.POINTER(ci)]
    else:
      lib.SampleTokens.argtypes = [vp, vp, ci, vp, cu, cu, ctypes.c_float,
                                   ci, ci, vp, vp, vp]
    lib.SampleTokens.restype = ci
    self.sms = torch.cuda.get_device_properties(0).multi_processor_count
    self.plans = {}

  def Fit(self, masked, chunk, s):
    per_sm, fits = ctypes.c_int(0), ctypes.c_int(0)
    rc = self.lib.SampleTokensFit(int(masked), chunk, s,
                                  ctypes.byref(per_sm), ctypes.byref(fits))
    if rc != 0:
      raise RuntimeError(f"SampleTokensFit: rc {rc}")
    return per_sm.value, bool(fits.value)

  def Plan(self, r, top_k):
    key = (r, self.st.Masked(top_k, V))
    if key not in self.plans:
      self.plans[key] = self.st.Plan(r, V, top_k, self.sms, self.Fit)
    return self.plans[key]

  def Threshold(self, x, top_k):
    """The threshold the parent's sampled step took outside the kernel."""
    if not self.st.Masked(top_k, V):
      return None
    return self.torch.topk(x, top_k, dim=-1).values[..., -1] * self.inv_t

  def Launch(self, x, fold, key, top_k, thr=None, cluster=None):
    torch = self.torch
    r = x.shape[0]
    tokens = torch.empty((r,), dtype=torch.int32, device="cuda")
    zmax = torch.empty((r,), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    if self.inside:
      if cluster is None:
        cluster, chunk = self.Plan(r, top_k)
      else:
        chunk = self.st.Chunk(V, cluster)
      rc = self.lib.SampleTokens(
          x.data_ptr(), None, fold.data_ptr(), fold.shape[1], key[0], key[1],
          self.inv_t, top_k, r, V, r, cluster, chunk, tokens.data_ptr(),
          zmax.data_ptr(), stream)
    else:
      rc = self.lib.SampleTokens(
          x.data_ptr(), fold.data_ptr(), fold.shape[1],
          None if thr is None else thr.data_ptr(), key[0], key[1],
          self.inv_t, r, V, tokens.data_ptr(), zmax.data_ptr(), stream)
    if rc != 0:
      raise RuntimeError(f"SampleTokens: rc {rc}")
    return tokens, zmax

  def Draw(self, x, fold, key, top_k):
    thr = None if self.inside else self.Threshold(x, top_k)
    return self.Launch(x, fold, key, top_k, thr)


def _Inputs(torch, r):
  """[r, 32000] logits (torch.Generator("cuda") seed r) and the engine's
  folds: each of 8 requests' seed, the position."""
  gen = torch.Generator("cuda").manual_seed(r)
  x = torch.randn(r, V, generator=gen, device="cuda") * 4
  req = np.random.RandomState(r).randint(0, 8, size=r)
  seeds = np.random.RandomState(r + 1).randint(0, 2**31 - 1, size=8)
  fold = np.stack([seeds[req], np.arange(r) % 33], 1).astype(np.int32)
  return x, torch.as_tensor(fold).cuda()


def _Run(torch, cs, kernel, inputs, key):
  """One run of one tree at the four shapes: {shape: times, outputs}."""
  out = {}
  for r, top_k in SHAPES:
    x, fold = inputs[r]
    tokens, zmax = kernel.Draw(x, fold, key, top_k)
    torch.cuda.synchronize()
    res = dict(tokens=tokens.cpu(), zmax=zmax.cpu())
    if kernel.inside:
      res["ms"] = cs._TimeMs(torch, lambda: kernel.Draw(x, fold, key, top_k),
                             50)
      res["kernel_ms"], res["topk_ms"] = res["ms"], None
      res["cluster"] = kernel.Plan(r, top_k)[0]
    else:
      thr = kernel.Threshold(x, top_k)
      res["kernel_ms"] = cs._TimeMs(
          torch, lambda: kernel.Launch(x, fold, key, top_k, thr), 50)
      res["topk_ms"] = (None if thr is None else cs._TimeMs(
          torch, lambda: kernel.Threshold(x, top_k), 50))
      res["ms"] = cs._TimeMs(torch, lambda: kernel.Draw(x, fold, key, top_k),
                             50)
      res["cluster"] = None
    out[r, top_k] = res
  return out


def _Sweep(torch, cs, kernel, inputs, key):
  """This checkout's kernel at every cluster size of each shape."""
  for r, top_k in SHAPES:
    x, fold = inputs[r]
    want = kernel.Draw(x, fold, key, top_k)
    plan = kernel.Plan(r, top_k)
    masked = kernel.st.Masked(top_k, V)
    cells = []
    for s in range(1, kernel.st.MAX_CLUSTER + 1):
      chunk = kernel.st.Chunk(V, s)
      if masked and chunk * 4 > kernel.st.HOLD_BYTES:
        continue
      per_sm, fits = kernel.Fit(masked, chunk, s)
      if not fits:
        continue
      got = kernel.Launch(x, fold, key, top_k, cluster=s)
      torch.cuda.synchronize()
      if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError(f"[{r}, {V}] top_k {top_k}: cluster {s} draws "
                           "other tokens")
      ms = cs._TimeMs(torch, lambda: kernel.Launch(x, fold, key, top_k,
                                                   cluster=s), 30)
      cells.append(f"S={s}: {ms:.4f} ms ({per_sm}/SM)")
    print(f"sweep [{r}, {V}] top_k {top_k} (plan S={plan[0]}): "
          + "; ".join(cells), flush=True)


# where the masked kernel's phases end (thread 0 of each block, after the
# barrier that closes the phase): (anchor line, slot, stamp before it)
_STAMPS = (
    ("  const int n = max(0, c1 - c0);\n", "0", True, "true"),
    ("  const float4* held4 = reinterpret_cast<const float4*>(s_held);\n",
     "1", False, "true"),
    ("    const uint32_t total = s_sel[2];\n", "2", False, "pass == 0"),
    ("    // the remaining passes over the candidates, in this block alone\n",
     "3", True, "true"),
    ("  const float thr = __fmul_rn(FromOrderKey(prefix), a.inv_t);\n", "4",
     True, "true"),
    ("  ClusterArgmax(a, s_merge, best, arg, i, rank);\n}\n\n// The masked",
     "5", True, "true"),
    ("  ClusterArgmax(a, s_merge, best, arg, i, rank);\n}\n\n// The masked",
     "6", False, "true"),
)
_PHASES = ("copy in and the cluster's first barrier", "pass 0 (exchanged)",
           "gather of the candidates", "passes 1-3 over them", "draw",
           "merge")


def _TracedPath(tree, out):
  """tree's sample_tokens.cu with %globaltimer stamps (thread 0 of each
  block of SampleTopKKernel, at the edges above, no added barrier; the
  gather's stamp only where a call takes it) and a TraceRead entry, built
  into out; returns the library's path."""
  sys.path.insert(0, REPO)
  from lingvo_tpu_torch.ops import cuda_build
  csrc = os.path.join(os.path.abspath(tree), "lingvo_tpu_torch", "ops",
                      "csrc")
  src = open(os.path.join(csrc, "sample_tokens.cu")).read()
  src = src.replace('#include "hopper.cuh"',
                    f'#include "{os.path.join(csrc, "hopper.cuh")}"\n'
                    "__device__ unsigned long long g_trace[1 << 16][8];")
  for anchor, slot, before, cond in _STAMPS:
    if src.count(anchor) != 1:
      raise RuntimeError(f"sample_tokens.cu: {anchor.strip()!r} is not one "
                         "line of the kernel")
    text = (f"  if (threadIdx.x == 0 && ({cond})) {{ unsigned long long t_; "
            "asm volatile("
            "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
            f"g_trace[blockIdx.x][{slot}] = t_; }}\n")
    if "\n}" in anchor and not before:   # after the line, before the brace
      src = src.replace(anchor, anchor.replace("\n}", "\n" + text + "}", 1))
    else:
      src = src.replace(anchor, text + anchor if before else anchor + text)
  src += ('\nextern "C" int TraceRead(unsigned long long* dst, int n) {\n'
          "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_trace, "
          "sizeof(unsigned long long) * 8 * n));\n}\n")
  os.makedirs(out, exist_ok=True)
  cu = os.path.join(out, "sample_tokens_traced.cu")
  lib = os.path.join(out, "sample_tokens_traced.so")
  with open(cu, "w") as f:
    f.write(src)
  proc = subprocess.run([cuda_build._Nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib,
                         cu], capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
  return lib


def _Trace(torch, kernel, inputs, key):
  """Where a masked call's time goes, block by block: each top_k 40 shape
  once after an L2 flush (the third of three calls), at the plan's
  cluster and at 1, 4 and 16. Prints, over the call's blocks, the median
  and 90th percentile of each phase in us, when the blocks started after
  the first, and the call's span."""
  lib = kernel.lib
  lib.TraceRead.argtypes = [ctypes.c_void_p, ctypes.c_int]
  scratch = torch.empty(16 << 20, device="cuda")
  for r, top_k in SHAPES:
    if not kernel.st.Masked(top_k, V):
      continue
    x, fold = inputs[r]
    for s in sorted({kernel.Plan(r, top_k)[0], 1, 4, 16}):
      for _ in range(3):
        scratch.zero_()
        kernel.Launch(x, fold, key, top_k, cluster=s)
      torch.cuda.synchronize()
      blocks = r * s
      buf = np.zeros((blocks, 8), dtype=np.uint64)
      rc = lib.TraceRead(buf.ctypes.data, blocks)
      if rc != 0:
        raise RuntimeError(f"TraceRead: rc {rc}")
      t = buf.astype(np.int64)
      t0 = t[:, 0].min()
      cols = [f"start after the first {np.median(t[:, 0] - t0) / 1e3:.2f} / "
              f"{(t[:, 0] - t0).max() / 1e3:.2f}"]
      for j, name in enumerate(_PHASES):
        d = (t[:, j + 1] - t[:, j]) / 1e3
        cols.append(f"{name} {np.median(d):.2f} / {np.percentile(d, 90):.2f}")
      print(f"trace [{r}, {V}] top_k {top_k}, cluster of {s} (median / p90 "
            f"us): " + "; ".join(cols)
            + f"; span {(t[:, len(_PHASES)].max() - t0) / 1e3:.2f} us",
            flush=True)


def main():
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("trees", nargs="*", default=[REPO])
  ap.add_argument("--out", default="build/sample_probe")
  ap.add_argument("--sweep", action="store_true",
                  help="time each tree's kernel at every cluster size")
  ap.add_argument("--trace", action="store_true",
                  help="split one masked call of the first tree's kernel "
                  "into phases, block by block, with %%globaltimer stamps")
  args = ap.parse_args()
  sys.path.insert(0, REPO)
  import torch
  if not torch.cuda.is_available():
    print("torch_sample_probe: no CUDA device", file=sys.stderr)
    return 1
  from lingvo_tpu_torch.core import threefry
  cs = _ChipSmoke()
  os.makedirs(args.out, exist_ok=True)
  print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip(), flush=True)
  trees = [os.path.abspath(t) for t in args.trees]
  if args.trace:
    trees = trees[:1]
  build = (lambda t: _TracedPath(t, args.out)) if args.trace else (
      lambda t: _Build(t, args.out))
  with concurrent.futures.ThreadPoolExecutor(len(trees)) as pool:
    paths = list(pool.map(build, trees))
  kernels = [_Kernel(torch, p) for p in paths]
  key = [int(w) for w in threefry.PRNGKey(3).tolist()]
  inputs = {r: _Inputs(torch, r) for r in (264, 8)}
  if args.trace:
    _Trace(torch, kernels[0], inputs, key)
    return 0
  if args.sweep:
    for tree, kernel in zip(trees, kernels):
      print(f"sweep of {tree}", flush=True)
      _Sweep(torch, cs, kernel, inputs, key)
    return 0
  order = list(range(len(trees)))
  if len(trees) > 1:
    order += order[::-1]
  first, means = {}, {}
  for run, t in enumerate(order):
    res = _Run(torch, cs, kernels[t], inputs, key)
    for shape, cell in res.items():
      if shape not in first:
        first[shape] = cell
      elif not (torch.equal(cell["tokens"], first[shape]["tokens"])
                and torch.equal(cell["zmax"], first[shape]["zmax"])):
        raise RuntimeError(f"run {run} ({trees[t]}) at {shape}: the tokens "
                           "or winning values differ from run 0's")
      r, top_k = shape
      how = (f"kernel {cell['kernel_ms']:.4f} ms + torch.topk "
             f"{cell['topk_ms']} ms, both in one call {cell['ms']:.4f} ms"
             if not kernels[t].inside else
             f"one launch {cell['ms']:.4f} ms (cluster of {cell['cluster']})")
      print(f"run {run} {'AB'[t] if len(trees) == 2 else t} "
            f"{trees[t]} [{r}, {V}] top_k {top_k}: {how}; tokens equal "
            "run 0's", flush=True)
      cell_means = means.setdefault(trees[t], {}).setdefault(
          f"[{r}, {V}] top_k {top_k}", {})
      for k in ("ms", "kernel_ms", "topk_ms"):
        if cell[k] is not None:
          cell_means.setdefault(k, []).append(cell[k])
  print(json.dumps({tree: {shape: {k: float(np.mean(v)) for k, v in c.items()}
                           for shape, c in by.items()}
                    for tree, by in means.items()}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
