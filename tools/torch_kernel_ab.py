#!/usr/bin/env python3
"""Times the redesigned kernels of two checkouts of the port on one card.

Parent and change are interleaved, and the kernels not being compared
must give the same bits in both.

    python3 tools/torch_kernel_ab.py --trees build/parent . --out build/ab

Each tree's `lingvo_tpu_torch` is imported in a child process of its own
(both packages have one name), in the order A, B, B, A, so that a drift
of the card over the run shows as a difference between the two runs of
one tree. The inputs and the timer are this checkout's `chip_smoke.py`
(`_KvStorage`, `_DecodePool`, `_DecodeOnlyLens`, `_AttendPack`,
`_ScanInputs`, `_FlashInputs`, `_Requests`, `_TimeMs`). Every child times
the bfloat16 flash-attention backward kernels, dK/dV and dQ, at phase
18's shapes ([8, 1024, 16, 128], causal, two segments of 512 per row,
dyadic q, k, v and do), and SDPA's bfloat16 backward on the same inputs
with the boolean causal-and-segment mask (the yardstick; the port never
calls it).

Every child also digests (sha256 of the bytes) the outputs of the
kernels that were not redesigned, which must be equal in all four runs:
the flash-attention forward in both dtypes and the float32 dK/dV and dQ
(phase 7 / 18's shapes), flash decode (float32 and bf16 at t = 1151 and
700), block decode in its three dtypes (phase 10's pool and the
decode-only pack), the scan (phase 4's serving shape), the fused xent in
both dtypes (phase 8 / 19's shapes) and the ragged kernel (float32, int8,
bf16 at phase 3's pack and the decode-only pack); the redesigned
kernels' outputs (bf16 dk, dv and dq) are reported apart. Prints one
JSON line per child and a summary; needs one CUDA card and imports no
JAX.
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
# digests reported apart: the redesigned kernels
REDESIGNED = ("bf16_dk", "bf16_dv", "bf16_dq")


def _ChipSmoke():
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _Flash(torch, fa, cs, res, outs):
  """The flash kernels at phase 7 / 18's shapes: float32 forward and
  backward, then bf16 forward and backward on dyadic inputs; the bf16
  backward pair timed beside SDPA's bf16 backward."""
  x, keep, _ = cs._FlashInputs(torch, np.random.RandomState(5))
  q, k, v, do, seg = x["q"], x["k"], x["v"], x["do"], x["seg"]
  for dtype in ("f32", "bf16"):
    if dtype == "bf16":
      q, k, v, do = (torch.as_tensor(cs._Dyadic(a.cpu().numpy(), 1 / 8))
                     .cuda().bfloat16() for a in (q, k, v, do))
    out, lse = fa.FlashForward(q, k, v, seg, True)
    delta = fa.RowDelta(do, out)
    outs[f"{dtype}_fwd_out"], outs[f"{dtype}_fwd_lse"] = out, lse
    outs[f"{dtype}_dk"], outs[f"{dtype}_dv"] = fa.FlashDkDv(
        q, k, v, seg, do, lse, delta, True)
    outs[f"{dtype}_dq"] = fa.FlashDq(q, k, v, seg, do, lse, delta, True)
  res["bf16_dkdv_ms"] = cs._TimeMs(
      torch, lambda: fa.FlashDkDv(q, k, v, seg, do, lse, delta, True), 20)
  res["bf16_dq_ms"] = cs._TimeMs(
      torch, lambda: fa.FlashDq(q, k, v, seg, do, lse, delta, True), 20)
  sdpa = torch.nn.functional.scaled_dot_product_attention
  leaves = [a.transpose(1, 2).detach().requires_grad_(True)
            for a in (q, k, v)]
  with torch.enable_grad():
    ref = sdpa(*leaves, attn_mask=keep[:, None])
  dot = do.transpose(1, 2)
  res["sdpa_bf16_backward_ms"] = cs._TimeMs(
      torch, lambda: torch.autograd.grad(ref, leaves, dot,
                                         retain_graph=True), 20,
      waits_as="SDPA bf16 backward")


def _Decode(torch, fd, cs, spi, outs):
  """Flash decode at phase 11 / 15's shapes, on float32 and bf16 caches."""
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
    outs[f"bf16_decode_{t}"] = fd.FlashDecode(
        torch.as_tensor(q16).cuda(), kc, vt32.bfloat16(), t, page_size=page,
        cache_paddings=padc)


def _BlockDecode(torch, bd, cs, outs):
  """Block decode in its three dtypes at phase 10's page-16 pool and at
  the decode-only pack (dyadic q and K)."""
  for pack, lens in (("main", None), ("decode_only", cs._DecodeOnlyLens())):
    x, _, _, extra = cs._DecodePool(torch, 16, np.random.RandomState(10),
                                    dyadic=True, lens=lens)
    rest = (x["tables"], x["lens"])
    for dtype in ("float32", "int8", "bfloat16"):
      if dtype == "float32":
        k, v, sc = x["k_pool"], x["v_pool"], {}
      else:
        k, v, sc, _ = cs._KvStorage(torch, extra["clean"], extra["dead"],
                                    dtype)
      got = bd.BlockDecode(x["q"], k, v, *rest, page_size=16, **sc)
      key = f"block_decode_{dtype}"
      outs[key] = (got if pack == "main"
                   else torch.cat([outs[key].flatten(), got.flatten()]))


def _Scan(torch, ssd, cs, outs):
  """The scan at phase 4's serving shape."""
  xs, _ = cs._ScanInputs(torch, ssd, np.random.RandomState(8), 256,
                         [1, 256, 1, 200, 1, 37, 1, 0], [(5, 20)], True)
  outs["scan_y"], outs["scan_state"] = ssd.SsdScan(*xs[:4], s0=xs[4],
                                                   chunk_size=64)


def _Xent(torch, fx, outs):
  """Fused xent at phase 8 / 19's shapes, float32 and bf16."""
  rng = np.random.RandomState(6)
  m, d, vocab = 8192, 2048, 32000
  x = torch.as_tensor(rng.randn(m, d).astype(np.float32)).cuda()
  w = torch.as_tensor((rng.randn(vocab, d) / np.sqrt(d)).astype(
      np.float32)).cuda()
  bias = torch.zeros(vocab, device="cuda")
  labels = torch.as_tensor(rng.randint(0, vocab, m).astype(np.int32)).cuda()
  cfg = fx._Cfg(block_size=1280, vocab=vocab, vd=True, soft_cap=30.0,
                label_smoothing=0.0)
  for name, args in (("xent_f32", (x, w, bias)),
                     ("xent_bf16", (x.bfloat16(), w.bfloat16(),
                                    bias.bfloat16()))):
    outs[name] = torch.cat([
        a.float() for a in fx.FusedXentStats(*args, labels, cfg)
        if a is not None])


def _Ragged(torch, rba, ragged, cs, outs):
  """The ragged kernel's three instantiations at phase 3's pack and the
  decode-only pack (page 16, H = 128, dyadic q and K), digested."""
  got = []
  for pack in ("main", "decode_only"):
    x, _, _, _, extra = cs._AttendPack(torch, ragged, 16, 128,
                                       np.random.RandomState(14),
                                       dyadic=True, pack=pack)
    ints = (x["tables"], x["row_of"], x["q_end"])
    tree = dict(q_start=x["q_start"], anc_lo=x["anc_lo"], anc_hi=x["anc_hi"])
    for dtype in ("float32", "int8", "bfloat16"):
      if dtype == "float32":
        k, v, sc = x["k_pool"], x["v_pool"], {}
      else:
        k, v, sc, _ = cs._KvStorage(torch, extra["clean"], extra["dead"],
                                    dtype)
      got.append(rba.RaggedAttend(x["q"], k, v, *ints, page_size=16, **sc,
                                  **tree))
  outs["ragged"] = torch.cat([a.flatten() for a in got])


def _Child(tree, save):
  """One tree's times (JSON on stdout) and the digests of its kernels'
  outputs (to `save`, for the bitwise comparison)."""
  import torch
  sys.path.insert(0, os.path.abspath(tree))
  from lingvo_tpu_torch.core import ragged
  from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
  from lingvo_tpu_torch.ops import block_decode as bd
  from lingvo_tpu_torch.ops import flash_attention as fa
  from lingvo_tpu_torch.ops import flash_decode as fd
  from lingvo_tpu_torch.ops import fused_xent as fx
  from lingvo_tpu_torch.ops import ragged_block_attend as rba
  from lingvo_tpu_torch.ops import ssd_scan as ssd
  cs = _ChipSmoke()
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  res, outs = {"tree": tree}, {}
  _Flash(torch, fa, cs, res, outs)
  _Decode(torch, fd, cs, spi, outs)
  _BlockDecode(torch, bd, cs, outs)
  _Scan(torch, ssd, cs, outs)
  _Xent(torch, fx, outs)
  _Ragged(torch, rba, ragged, cs, outs)
  torch.cuda.synchronize()
  digests = {key: hashlib.sha256(x.float().cpu().numpy().tobytes())
             .hexdigest() for key, x in outs.items()}
  with open(save, "w") as f:
    json.dump(digests, f)
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
         "--save", save], capture_output=True, text=True)
    with open(os.path.join(args.out, f"child_{i}.log"), "w") as f:
      f.write(proc.stdout + proc.stderr)
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
    pair = r["bf16_dkdv_ms"] + r["bf16_dq_ms"]
    print(f"run {i} ({tree}): bf16 dK/dV + dQ {pair:.4f} ms, SDPA bf16 "
          f"backward {r['sdpa_bf16_backward_ms']:.4f} ms "
          f"({r['sdpa_bf16_backward_ms'] / pair:.2f}x)")
  return 0 if same else 1


if __name__ == "__main__":
  sys.exit(main())
