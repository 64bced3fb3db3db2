#!/usr/bin/env python3
"""Times the SSD scan's backward kernel, and each of its launches, on one card.

    python3 tools/torch_scan_bwd_probe.py [tree ...]

For each checkout given (default: this one), a child process imports that
tree's `lingvo_tpu_torch` (both packages have one name), builds its
backward kernel (`ops/csrc/ssd_scan_bwd.cu`) and, at the hybrid's
training shape ([8, 1024, 16], S = H = 64, chunk 64, a packed batch's
resets and a padded tail: this checkout's `chip_smoke._PackedScan`):
- times `_CudaScanBwd` with this checkout's `chip_smoke._TimeMs` (20
  calls, each after an L2 flush);
- profiles 10 calls with torch.profiler and prints each kernel's device
  time per call (the state sweeps and the chunk kernel);
- holds every gradient against the tree's `_PlainScanBwd` (max |error|
  over max |plain|) and prints the sha256 of the gradients' bytes.
With two trees the children run A, B, B, A, so that a drift of the card
shows as a difference between the two runs of one tree. Needs one CUDA
card and imports no JAX.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ChipSmoke():
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _Child(tree):
  sys.path.insert(0, os.path.abspath(tree))
  import torch
  from torch.profiler import ProfilerActivity, profile
  from lingvo_tpu_torch.core import ssm
  from lingvo_tpu_torch.ops import ssd_scan as ssd
  cs = _ChipSmoke()
  torch.backends.cuda.matmul.allow_tf32 = False
  x, moved = cs._PackedScan(torch, ssm, np.random.RandomState(27), False)
  args = (*x, 64)
  got = ssd._CudaScanBwd(*args)
  want = ssd._PlainScanBwd(*args)
  torch.cuda.synchronize()
  rel = {}
  digest = hashlib.sha256()
  for name, g, w in zip(("dl", "db", "dc", "dv"), got, want):
    rel[name] = float((g - w).abs().max()) / float(w.abs().max())
    digest.update(g.cpu().numpy().tobytes())
  ms = cs._TimeMs(torch, lambda: ssd._CudaScanBwd(*args), 20)
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(10):
      ssd._CudaScanBwd(*args)
    torch.cuda.synchronize()
  kernels = {e.key[:60]: round(cs._DevUs(e) / 1e3 / 10, 4)
             for e in prof.key_averages() if cs._DevUs(e) > 0}
  flops = cs._ScanBwdFlops(1024, 64, 64, 64) * 8 * 16
  print(json.dumps(dict(
      tree=tree, ms=ms, bound_ms=cs._Bound(moved, flops)[0],
      kernels_ms=kernels, rel=rel, sha256=digest.hexdigest()[:16],
      geometry=ssd.BwdGeometry(1024, 64, 64, 64))))


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("trees", nargs="*", default=["."])
  ap.add_argument("--child", help=argparse.SUPPRESS)
  args = ap.parse_args()
  if args.child:
    _Child(args.child)
    return 0
  card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True, check=True).stdout.strip()
  print(card)
  order = args.trees if len(args.trees) != 2 else (
      args.trees + args.trees[::-1])
  runs = []
  for tree in order:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--child", tree], capture_output=True, text=True)
    if proc.returncode != 0:
      print(proc.stdout, proc.stderr, file=sys.stderr)
      return proc.returncode
    line = proc.stdout.strip().splitlines()[-1]
    print(line)
    runs.append(json.loads(line))
  for tree in args.trees:
    mine = [r for r in runs if r["tree"] == tree]
    print(f"{tree}: {' / '.join(f'{r['ms']:.4f}' for r in mine)} ms "
          f"(bound {mine[0]['bound_ms']:.4f}); max |err| / max |plain| "
          f"{max(mine[0]['rel'].values()):.3g}; kernels "
          f"{mine[0]['kernels_ms']}")
  return 0


if __name__ == "__main__":
  sys.exit(main())
