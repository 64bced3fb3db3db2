#!/usr/bin/env python3
"""Times the bf16 flash-attention forward and the bf16 flash decode of two
checkouts of the PyTorch port on one card, interleaved, and checks that
their float32 forward and float32 flash decode give the same bits.

    python3 tools/torch_kernel_ab.py --trees build/parent . --out build/ab

Each tree's `lingvo_tpu_torch` is imported in a child process of its own
(both packages have one name), in the order A, B, B, A, so that a drift
of the card over the run shows as a difference between the two runs of
one tree. The inputs and the timer are this checkout's `chip_smoke.py`
(`_FlashInputs` on dyadic bf16 values, `_CheckFlashDecode`'s cache,
paddings and NaN poison, `_TimeMs`), at the shapes of phases 18 and 15:
the forward at [8, 1024, 16, 128], causal, two segments of 512; flash
decode on a bfloat16 cache at [8, 1152, 16, 128], page 128, t = 1151 and
700 (at t = 1151 also without paddings, and at 4 to 7 splits). SDPA on the
same bf16 inputs is timed in every child as the library's yardstick. Prints one JSON line per child and a summary; needs
one CUDA card and imports no JAX.
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


def _Child(tree, save):
  """One tree's times (JSON on stdout) and its float32 outputs (to
  `save`, for the bitwise comparison)."""
  import torch
  sys.path.insert(0, os.path.abspath(tree))
  from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
  from lingvo_tpu_torch.ops import flash_attention as fa
  from lingvo_tpu_torch.ops import flash_decode as fd
  cs = _ChipSmoke()
  torch.backends.cuda.matmul.allow_tf32 = False
  sdpa = torch.nn.functional.scaled_dot_product_attention
  res, f32 = {"tree": tree}, {}

  x, keep, _ = cs._FlashInputs(torch, np.random.RandomState(5))
  seg = x["seg"]
  out, lse = fa.FlashForward(x["q"], x["k"], x["v"], seg, True)
  f32["fwd_out"], f32["fwd_lse"] = out.cpu(), lse.cpu()
  q, k, v = (torch.round(x[n] * 8) / 8 for n in ("q", "k", "v"))
  q, k, v = (a.bfloat16().contiguous() for a in (q, k, v))
  del x, out, lse
  res["fwd_bf16_ms"] = cs._TimeMs(
      torch, lambda: fa.FlashForward(q, k, v, seg, True), 20)
  qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
  res["fwd_sdpa_ms"] = cs._TimeMs(
      torch, lambda: sdpa(qt, kt, vt, attn_mask=keep[:, None]), 20,
      waits_as="SDPA bf16 forward")
  del q, k, v, qt, kt, vt, keep

  b, s, n, h, page, p_len = 8, 1152, 16, 128, 128, 1024
  prompt_lens, _ = cs._Requests(spi.DenseLm1B())
  rng = np.random.RandomState(11)
  slot = np.arange(s)
  pad = (slot[None] < (p_len - np.asarray(prompt_lens))[:, None]).astype(
      np.float32)
  qd = (rng.randn(b, 1, n, h) / np.sqrt(h)).astype(np.float32)
  kd = rng.randn(b, s, n, h).astype(np.float32)
  vd = rng.randn(b, s, n, h).astype(np.float32)
  q16, k16 = cs._Dyadic(qd, 1 / 64), cs._Dyadic(kd, 1 / 8)
  padc = torch.as_tensor(pad).cuda()
  for t in (1151, 700):
    dead = (pad > 0.5)[:, :, None, None] | (slot > t)[None, :, None, None]
    kt32 = torch.as_tensor(np.where(dead, np.nan, kd)).cuda()
    vt32 = torch.as_tensor(np.where(dead, np.nan, vd)).cuda()
    f32[f"decode_{t}"] = fd.FlashDecode(
        torch.as_tensor(qd).cuda(), kt32, vt32, t, page_size=page,
        cache_paddings=padc).cpu()
    kc = torch.as_tensor(np.where(dead, np.nan, k16)).cuda().bfloat16()
    vc = vt32.bfloat16()
    qc = torch.as_tensor(q16).cuda()
    res[f"decode_bf16_{t}_ms"] = cs._TimeMs(
        torch, lambda: fd.FlashDecode(qc, kc, vc, t, page_size=page,
                                      cache_paddings=padc), 50)
    if t == 1151:   # the same call without paddings, and at 4 splits
      res["decode_bf16_1151_nopad_ms"] = cs._TimeMs(
          torch, lambda: fd.FlashDecode(qc, kc, vc, t, page_size=page), 50)
      rule = fd.NumSplits
      for forced in (4, 5, 6, 7):
        fd.NumSplits = lambda *a: forced
        res[f"decode_bf16_1151_splits{forced}_ms"] = cs._TimeMs(
            torch, lambda: fd.FlashDecode(qc, kc, vc, t, page_size=page,
                                          cache_paddings=padc), 50)
      fd.NumSplits = rule
    live = torch.as_tensor((slot[None] <= t) & (pad < 0.5)).cuda()
    qs, ks, vs = (a.transpose(1, 2) for a in (qc.bfloat16(), kc, vc))
    res[f"decode_sdpa_{t}_ms"] = cs._TimeMs(
        torch, lambda: sdpa(qs, ks, vs, attn_mask=live[:, None, None, :],
                            scale=1.0), 50, waits_as="SDPA decode")
    del kt32, vt32, kc, vc
  with open(save, "w") as f:   # digests of the float32 outputs' bytes
    json.dump({key: hashlib.sha256(x.numpy().tobytes()).hexdigest()
               for key, x in f32.items()}, f)
  print(json.dumps(res), flush=True)


def main():
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
  ap.add_argument("--out", default="build/ab")
  ap.add_argument("--child", help=argparse.SUPPRESS)
  ap.add_argument("--save", help=argparse.SUPPRESS)
  args = ap.parse_args()
  if args.child:
    _Child(args.child, args.save)
    return 0
  import torch
  if not torch.cuda.is_available():
    print("torch_kernel_ab: no CUDA device", file=sys.stderr)
    return 1
  os.makedirs(args.out, exist_ok=True)
  card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True).stdout.strip()
  print(card, flush=True)
  a, b = args.trees
  runs = []
  for i, tree in enumerate((a, b, b, a)):
    save = os.path.join(args.out, f"f32_{i}.json")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", tree,
         "--save", save], capture_output=True, text=True)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
      print(f"child {i} ({tree}) failed: rc {proc.returncode}")
      return 1
    line = proc.stdout.strip().splitlines()[-1]
    print(line, flush=True)
    with open(save) as f:
      runs.append((json.loads(line), json.load(f)))
  same = all(r[1] == runs[0][1] for r in runs[1:])
  print(f"float32 forward (out, lse) and float32 flash decode (t = 1151, "
        f"700): {'bitwise equal' if same else 'DIFFER'} across the four "
        f"runs of {a} and {b}")
  for key in runs[0][0]:
    if key != "tree":
      print(f"{key}: {a} {runs[0][0][key]:.4f} / {runs[3][0][key]:.4f}, "
            f"{b} {runs[1][0][key]:.4f} / {runs[2][0][key]:.4f}")
  return 0 if same else 1


if __name__ == "__main__":
  sys.exit(main())
