"""Seeded sampling of one token per row: scaled, top-k-masked logits plus threefry Gumbel noise, argmax.

The draw of the reference's `SampleFromLogits` at temperature > 0
(lingvo_tpu/core/sampling.py:34): `jax.random.categorical` over the
transformed logits, which XLA runs as threefry2x32 bits, a uniform,
-log(-log(u)), an add and an argmax. It replaces no `pallas_call`: the
reference has no Pallas kernel here. No PyTorch call draws JAX's
threefry noise, so the card runs a hand kernel,
`ops/csrc/sample_tokens.cu`, one launch a call.

`SampleTokens(logits, key, fold, inv_t, thr)`:

- logits [R, V] float32; key a CPU int64 tensor [2] (uint32 words,
  `core/threefry`); fold [R, F] int32, F = 1 or 2: row r's key is the
  base key folded with fold[r, 0], then fold[r, 1] (the engine passes
  (request seed, output position), `GShardDecode` the row index against
  its step key), and its noise counters are (0, c) for columns c in
  0..V-1;
- inv_t: the float32 reciprocal of the temperature, a Python float that
  is exactly a float32 (`core/jit_arith.Reciprocal`): the reference
  divides by the temperature inside its jitted step programs, where XLA
  makes the division a product with the reciprocal;
- thr: None, or [R] float32, the k-th largest scaled logit of each row
  (top-k: values below it are masked to -inf; ties at it stay live). The
  caller may take it from `torch.topk` of the raw logits times inv_t: a
  product by a positive float is monotone under rounding, so that is the
  k-th largest scaled value bit for bit. The threshold is this library
  call because the kernel ports no Pallas kernel; the draw is the kernel.

Returns tokens [R] int32, and with `return_z` the winning perturbed value
[R] float32 too.

The plain version, `_PlainSample`, is the same arithmetic in PyTorch
(`core/threefry`): the CPU path, and the kernel's yardstick on the card.
The bits and uniforms of the two are equal; the logarithms are each
framework's (libdevice `logf` on the card, PyTorch's on the CPU), which
may differ by an ulp, so the two agree on every token except where two
perturbed values of a row are that close. A wrapper takes the plain
version only for CPU tensors; a CUDA tensor launches the kernel or
raises. Each launch counts one in `SampleTokens.launches`.

What bounds the kernel (R = 264 packed tokens of a DenseLm1B serving
step, V = 32000): its integer work, about `INT_OPS_PER_ELEMENT` int32
operations of threefry per element against 4 bytes of logits. Of those,
`ALU_OPS_PER_ELEMENT` (the rotates, xors, the shift and the or) run only
on the SM's integer ALU pipe, at 64 lanes a clock; the adds may also
issue as IMAD on the FMA pipe. Every instruction of an element, the
float work of the two logarithms included, is issued at 128 lanes a
clock.
"""

from __future__ import annotations

import ctypes

import torch

from lingvo_tpu_torch.core import threefry
from lingvo_tpu_torch.ops import cuda_build

MAX_FOLDS = 2
# int32 operations of one element, counted from the algorithm: 20 rounds
# of (add, rotate, xor), 12 adds of the counter and the key words, and
# the xor, shift and or that make the uniform's mantissa
INT_OPS_PER_ELEMENT = 20 * 3 + 12 + 3
# those of them that only the ALU pipe runs: every rotate (a funnel shift)
# and xor of the rounds, and the uniform's xor, shift and or
ALU_OPS_PER_ELEMENT = 20 * 2 + 3


def _Fold(key, fold):
  """Row keys [R, 2]: the base key folded with each column of fold."""
  keys = key.to(fold.device).expand(fold.shape[0], 2)
  for j in range(fold.shape[1]):
    keys = threefry.FoldIn(keys, fold[:, j].to(torch.int64))
  return keys


def _PlainSample(logits, key, fold, inv_t, thr):
  """(tokens [R] int32, winning z [R] float32), the kernel's arithmetic."""
  z = logits * inv_t
  if thr is not None:
    z = torch.where(z < thr[:, None], float("-inf"), z)
  z = threefry.Gumbel(_Fold(key, fold), (logits.shape[1],)) + z
  tokens = torch.argmax(z, dim=-1)
  return tokens.to(torch.int32), z.gather(1, tokens[:, None])[:, 0]


_lib = None   # the loaded kernel library, with its C signatures declared


def _Lib():
  global _lib
  if _lib is None:
    lib = cuda_build.Load("sample_tokens")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.SampleTokens.argtypes = [vp, vp, ci, vp, ctypes.c_uint,
                                 ctypes.c_uint, ctypes.c_float, ci, ci, vp,
                                 vp, vp]
    lib.SampleTokens.restype = ci
    lib.SampleTokensErrorString.argtypes = [ci]
    lib.SampleTokensErrorString.restype = ctypes.c_char_p
    _lib = lib
  return _lib


def _CudaSample(logits, key, fold, inv_t, thr):
  r, v = logits.shape
  tokens = torch.empty((r,), dtype=torch.int32, device=logits.device)
  zmax = torch.empty((r,), dtype=torch.float32, device=logits.device)
  k0, k1 = (int(w) for w in key.tolist())
  lib = _Lib()
  rc = lib.SampleTokens(
      logits.data_ptr(), fold.data_ptr(), fold.shape[1],
      None if thr is None else thr.data_ptr(), k0, k1, inv_t, r, v,
      tokens.data_ptr(), zmax.data_ptr(),
      torch.cuda.current_stream(logits.device).cuda_stream)
  if rc != 0:
    raise RuntimeError("SampleTokens kernel launch failed: "
                       + lib.SampleTokensErrorString(rc).decode())
  SampleTokens.launches += 1
  return tokens, zmax


def SampleTokens(logits, key, fold, inv_t: float, thr=None,
                 return_z: bool = False):
  """One seeded draw per row (see the module docstring). CPU tensors run
  the plain version; CUDA tensors launch the kernel or raise."""
  if logits.ndim != 2 or logits.dtype != torch.float32:
    raise TypeError(f"SampleTokens takes float32 logits [R, V], got "
                    f"{logits.dtype} {tuple(logits.shape)}")
  r, v = logits.shape
  if r == 0 or v == 0:
    raise ValueError(f"SampleTokens takes R, V >= 1, got {r}, {v}")
  if (fold.dtype != torch.int32 or fold.ndim != 2 or fold.shape[0] != r
      or not 1 <= fold.shape[1] <= MAX_FOLDS):
    raise ValueError(f"fold must be int32 [R = {r}, F in 1..{MAX_FOLDS}], "
                     f"got {fold.dtype} {tuple(fold.shape)}")
  key = torch.as_tensor(key)
  if key.device.type != "cpu" or tuple(key.shape) != (2,):
    raise ValueError(f"key must be a CPU tensor [2] of uint32 words, got "
                     f"{tuple(key.shape)} on {key.device}")
  if thr is not None and (thr.dtype != torch.float32
                          or tuple(thr.shape) != (r,)):
    raise ValueError(f"thr must be float32 [{r}], got {thr.dtype} "
                     f"{tuple(thr.shape)}")
  dev = logits.device
  for name, x in (("fold", fold), ("thr", thr)):
    if x is not None and x.device != dev:
      raise ValueError(f"SampleTokens: {name} on {x.device}, logits on {dev}")
  if dev.type == "cpu":
    tokens, zmax = _PlainSample(logits, key, fold, inv_t, thr)
  elif dev.type == "cuda":
    tokens, zmax = _CudaSample(logits.contiguous(), key, fold.contiguous(),
                               inv_t, None if thr is None
                               else thr.contiguous())
  else:
    raise ValueError(f"SampleTokens runs on cpu or cuda, not {dev}")
  return (tokens, zmax) if return_z else tokens


SampleTokens.launches = 0
