#!/usr/bin/env python3
"""Times the flash kernels of two checkouts of the port on one card.

Parent and change are interleaved, and the kernels not being compared
must give the same bits in both.

    python3 tools/torch_kernel_ab.py --trees build/parent . --out build/ab

Each tree's `lingvo_tpu_torch` is imported in a child process of its own
(both packages have one name), in the order A, B, B, A, so that a drift
of the card over the run shows as a difference between the two runs of
one tree. The inputs and the timer are this checkout's `chip_smoke.py`
(`_FlashInputs`, `_CheckFlashDecode`'s cache, paddings and NaN poison,
`_TimeMs`). Every child times:

- the float32 dK/dV and dQ kernels at phase 7's shapes
  ([8, 1024, 16, 128], causal, two segments of 512), and SDPA's float32
  backward (dq, dk and dv at once) on the same inputs in every child;
- the bf16 forward at phase 18's shapes (dyadic q, k, v) and the
  bf16 flash decode at phase 15's ([8, 1152, 16, 128], page 128, t = 1151
  and 700; at t = 1151 also without paddings and at 4 to 7 splits), with
  SDPA on the same bf16 inputs.

Every child also digests (sha256 of the bytes) the outputs of every
flash kernel at those shapes: the float32 forward (out, lse), the bf16
forward, dK/dV and dQ, and the float32 and bf16 flash decode at t = 1151
and 700, which must be equal in all four runs; the float32 dK/dV and dQ,
which a change may redesign, are reported apart. Prints one JSON line
per child and a summary; needs one CUDA card and imports no JAX.
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
REDESIGNED = ("f32_dk", "f32_dv", "f32_dq")   # digests reported apart


def _ChipSmoke():
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _Flash(torch, fa, cs, res, outs):
  """The flash kernels at phase 7 / 18's shapes: float32 forward and
  backward, then bf16 forward and backward on dyadic inputs."""
  sdpa = torch.nn.functional.scaled_dot_product_attention
  x, keep, _ = cs._FlashInputs(torch, np.random.RandomState(5))
  q, k, v, do, seg = x["q"], x["k"], x["v"], x["do"], x["seg"]
  out, lse = fa.FlashForward(q, k, v, seg, True)
  delta = fa.RowDelta(do, out)
  outs["f32_fwd_out"], outs["f32_fwd_lse"] = out, lse
  outs["f32_dk"], outs["f32_dv"] = fa.FlashDkDv(q, k, v, seg, do, lse,
                                                delta, True)
  outs["f32_dq"] = fa.FlashDq(q, k, v, seg, do, lse, delta, True)
  qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
  res["dkdv_f32_ms"] = cs._TimeMs(
      torch, lambda: fa.FlashDkDv(q, k, v, seg, do, lse, delta, True), 20)
  res["dq_f32_ms"] = cs._TimeMs(
      torch, lambda: fa.FlashDq(q, k, v, seg, do, lse, delta, True), 20)
  leaves = [a.detach().requires_grad_(True) for a in (qt, kt, vt)]
  with torch.enable_grad():
    ref = sdpa(*leaves, attn_mask=keep[:, None])
  dot = do.transpose(1, 2)
  res["bwd_sdpa_f32_ms"] = cs._TimeMs(
      torch, lambda: torch.autograd.grad(ref, leaves, dot,
                                         retain_graph=True), 20,
      waits_as="SDPA float32 backward")
  del leaves, ref, dot
  q, k, v, do = (cs._Dyadic(a.cpu().numpy(), 1 / 8) for a in (q, k, v, do))
  q, k, v, do = (torch.as_tensor(a).cuda().bfloat16() for a in (q, k, v, do))
  del x, out, lse, delta, qt, kt, vt
  out, lse = fa.FlashForward(q, k, v, seg, True)
  delta = fa.RowDelta(do, out)
  outs["bf16_fwd_out"], outs["bf16_fwd_lse"] = out, lse
  outs["bf16_dk"], outs["bf16_dv"] = fa.FlashDkDv(q, k, v, seg, do, lse,
                                                  delta, True)
  outs["bf16_dq"] = fa.FlashDq(q, k, v, seg, do, lse, delta, True)
  res["fwd_bf16_ms"] = cs._TimeMs(
      torch, lambda: fa.FlashForward(q, k, v, seg, True), 20)
  qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
  res["fwd_sdpa_ms"] = cs._TimeMs(
      torch, lambda: sdpa(qt, kt, vt, attn_mask=keep[:, None]), 20,
      waits_as="SDPA bf16 forward")


def _Decode(torch, fd, cs, spi, res, outs):
  """Flash decode at phase 11 / 15's shapes, on float32 and bf16 caches."""
  sdpa = torch.nn.functional.scaled_dot_product_attention
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
    outs[f"f32_decode_{t}"] = fd.FlashDecode(
        torch.as_tensor(qd).cuda(), kt32, vt32, t, page_size=page,
        cache_paddings=padc)
    kc = torch.as_tensor(np.where(dead, np.nan, k16)).cuda().bfloat16()
    vc = vt32.bfloat16()
    qc = torch.as_tensor(q16).cuda()
    call = lambda: fd.FlashDecode(qc, kc, vc, t, page_size=page,
                                  cache_paddings=padc)
    outs[f"bf16_decode_{t}"] = call()
    res[f"decode_bf16_{t}_ms"] = cs._TimeMs(torch, call, 50)
    if t == 1151:   # the same call without paddings, and at 4 to 7 splits
      res["decode_bf16_1151_nopad_ms"] = cs._TimeMs(
          torch, lambda: fd.FlashDecode(qc, kc, vc, t, page_size=page), 50)
      rule = fd.NumSplits
      for forced in (4, 5, 6, 7):
        fd.NumSplits = lambda *a: forced
        res[f"decode_bf16_1151_splits{forced}_ms"] = cs._TimeMs(
            torch, call, 50)
      fd.NumSplits = rule
    live = torch.as_tensor((slot[None] <= t) & (pad < 0.5)).cuda()
    qs, ks, vs = (a.transpose(1, 2) for a in (qc.bfloat16(), kc, vc))
    res[f"decode_sdpa_{t}_ms"] = cs._TimeMs(
        torch, lambda: sdpa(qs, ks, vs, attn_mask=live[:, None, None, :],
                            scale=1.0), 50, waits_as="SDPA decode")


def _Child(tree, save):
  """One tree's times (JSON on stdout) and the digests of its kernels'
  outputs (to `save`, for the bitwise comparison)."""
  import torch
  sys.path.insert(0, os.path.abspath(tree))
  from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
  from lingvo_tpu_torch.ops import flash_attention as fa
  from lingvo_tpu_torch.ops import flash_decode as fd
  cs = _ChipSmoke()
  torch.backends.cuda.matmul.allow_tf32 = False
  res, outs = {"tree": tree}, {}
  _Flash(torch, fa, cs, res, outs)
  _Decode(torch, fd, cs, spi, res, outs)
  torch.cuda.synchronize()
  with open(save, "w") as f:
    json.dump({key: hashlib.sha256(x.float().cpu().numpy().tobytes())
               .hexdigest() for key, x in outs.items()}, f)
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
    save = os.path.join(args.out, f"digests_{i}.json")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", tree,
         "--save", save], capture_output=True,
        text=True)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
      print(f"child {i} ({tree}) failed: rc {proc.returncode}")
      return 1
    line = proc.stdout.strip().splitlines()[-1]
    print(line, flush=True)
    with open(save) as f:
      runs.append((json.loads(line), json.load(f)))
  kept = [k for k in runs[0][1] if k not in REDESIGNED]
  same = all(r[1][k] == runs[0][1][k] for r in runs[1:] for k in kept)
  print(f"{', '.join(kept)}: {'bitwise equal' if same else 'DIFFER'} "
        f"across the four runs of {a} and {b}")
  for key in REDESIGNED:
    d = [r[1][key] for r in runs]
    print(f"{key}: {a} {'repeats' if d[0] == d[3] else 'VARIES'}, {b} "
          f"{'repeats' if d[1] == d[2] else 'VARIES'}, the trees "
          f"{'agree' if d[0] == d[1] else 'differ'} bitwise")
  for key in runs[0][0]:
    if key != "tree":
      print(f"{key}: {a} {runs[0][0][key]:.4f} / {runs[3][0][key]:.4f}, "
            f"{b} {runs[1][0][key]:.4f} / {runs[2][0][key]:.4f}")
  for i, tree in enumerate((a, b, b, a)):
    r = runs[i][0]
    pair = r["dkdv_f32_ms"] + r["dq_f32_ms"]
    print(f"run {i} ({tree}): float32 dK/dV + dQ {pair:.4f} ms, SDPA "
          f"float32 backward {r['bwd_sdpa_f32_ms']:.4f} ms "
          f"({r['bwd_sdpa_f32_ms'] / pair:.2f}x)")
  return 0 if same else 1


if __name__ == "__main__":
  sys.exit(main())
