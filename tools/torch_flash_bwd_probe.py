#!/usr/bin/env python3
"""Times the bfloat16 flash-attention backward kernels of several trees.

    python3 tools/torch_flash_bwd_probe.py build/parent .

Each tree's `lingvo_tpu_torch` is imported in a child process of its own,
the trees in the given order and then in reverse, so that a drift of the
card shows as a difference between one tree's two runs. Every child times
dK/dV and dQ (`FlashDkDv`, `FlashDq`) with this checkout's
`chip_smoke._TimeMs`:

- at phase 18's shapes ([8, 1024, 16, 128], dyadic bf16 q, k, v and do
  from `chip_smoke._FlashInputs`) under three masks: phase 18's (causal,
  two segments of 512 per row), causal without segments, and neither;
- in one wave (at most 132 blocks of 128 owned rows: [1, 128, 132, 128],
  [1, 1024, 16, 128] and [1, 2048, 8, 128], neither mask), where a block
  streams 128, 1024 and 2048 rows: the slope between the last two is the
  time 64 streamed rows cost in a steady state (a dK/dV tile, half a dQ
  tile), and what the first leaves the cost of a block without them.

It also prints the sha256 of the phase-18 outputs, which the trees must
share where the kernels keep their bits. One JSON line per child; needs
one CUDA card and imports no JAX.
"""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVES = ((1, 128, 132), (1, 1024, 16), (1, 2048, 8))   # (b, t, n), h = 128


def _ChipSmoke():
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _Child(tree):
  import torch
  sys.path.insert(0, os.path.abspath(tree))
  from lingvo_tpu_torch.ops import flash_attention as fa
  cs = _ChipSmoke()
  res = {"tree": tree}
  x, _, _ = cs._FlashInputs(torch, np.random.RandomState(5))
  seg = x["seg"]
  q, k, v, do = (torch.as_tensor(cs._Dyadic(x[n].cpu().numpy(), 1 / 8))
                 .cuda().bfloat16() for n in ("q", "k", "v", "do"))
  del x
  for mask, s, causal in (("phase18", seg, True), ("causal", None, True),
                          ("full", None, False)):
    out, lse = fa.FlashForward(q, k, v, s, causal)
    delta = fa.RowDelta(do, out)
    if mask == "phase18":
      got = fa.FlashDkDv(q, k, v, s, do, lse, delta, causal) + (
          fa.FlashDq(q, k, v, s, do, lse, delta, causal),)
      res["sha256"] = hashlib.sha256(torch.cat(
          [a.float().flatten() for a in got]).cpu().numpy().tobytes()
      ).hexdigest()[:16]
    res[f"dkdv_{mask}_ms"] = cs._TimeMs(
        torch, lambda: fa.FlashDkDv(q, k, v, s, do, lse, delta, causal), 20)
    res[f"dq_{mask}_ms"] = cs._TimeMs(
        torch, lambda: fa.FlashDq(q, k, v, s, do, lse, delta, causal), 20)
  rng = np.random.RandomState(0)
  for b, t, n in WAVES:
    w = [torch.as_tensor(cs._Dyadic(rng.randn(b, t, n, 128), 1 / 8))
         .float().cuda().bfloat16() for _ in range(4)]
    out, lse = fa.FlashForward(*w[:3], None, False)
    delta = fa.RowDelta(w[3], out)
    for name, fn in (("dkdv", fa.FlashDkDv), ("dq", fa.FlashDq)):
      res[f"{name}_wave{t // 64}_ms"] = cs._TimeMs(
          torch, lambda: fn(*w[:3], None, w[3], lse, delta, False), 20)
  for name in ("dkdv", "dq"):
    rows64 = (res[f"{name}_wave32_ms"] - res[f"{name}_wave16_ms"]) / 16
    res[f"{name}_per64rows_us"] = rows64 * 1e3
    res[f"{name}_block_us"] = (res[f"{name}_wave2_ms"] - 2 * rows64) * 1e3
  print(json.dumps(res), flush=True)


def main():
  if sys.argv[1:2] == ["--child"]:
    _Child(sys.argv[2])
    return 0
  import torch
  if not torch.cuda.is_available() or len(sys.argv) < 2:
    print("torch_flash_bwd_probe: needs a CUDA card and one or more trees",
          file=sys.stderr)
    return 1
  print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip(), flush=True)
  trees = sys.argv[1:]
  for tree in trees + trees[::-1]:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--child", tree], capture_output=True, text=True)
    if proc.returncode != 0:
      print(f"{tree} failed: rc {proc.returncode}\n{proc.stderr[-3000:]}")
      return 1
    print(proc.stdout.strip().splitlines()[-1], flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
