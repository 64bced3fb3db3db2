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
(b) bitwise against their plain versions, then each kernel's device time
beside its bound, torch._int_mm and the float32 matmul. Prints the card,
each child's lines, and one JSON line per child with the step sums; child
logs go to --out. Needs one CUDA card and imports no JAX.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KEYS = ("a_ms", "b_ms", "a_plain_ms", "b_plain_ms", "a_bound", "b_bound",
         "int_mm_ms", "f32_ms")


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
  print(json.dumps(res), flush=True)


def main():
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("trees", nargs="*", default=[REPO])
  ap.add_argument("--out", default="build/int8_probe")
  ap.add_argument("--child", help=argparse.SUPPRESS)
  args = ap.parse_args()
  if args.child:
    _Child(args.child)
    return 0
  import torch
  if not torch.cuda.is_available():
    print("torch_int8_probe: no CUDA device", file=sys.stderr)
    return 1
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
