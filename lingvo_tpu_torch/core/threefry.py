"""Counter-based random bits with JAX's numbers: threefry2x32 (the port's copy of what lingvo_tpu/core/sampling.py takes from jax.random).

The reference draws its samples with `jax.random` under
`jax_threefry_partitionable=True`. A request's token is a pure function
of its keys, so the port reproduces the reference's streams only with
the same generator. This module is that generator, written from the
algorithm (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
SC 2011; Threefry-2x32 with 20 rounds), as plain PyTorch:

- a key is a pair of uint32 words, held as an int64 tensor [..., 2] with
  values in [0, 2^32); every sum is masked back to 32 bits;
- `Threefry2x32(k0, k1, x0, x1)`: rotations 13, 15, 26, 6 and 17, 29,
  16, 24, key words k0, k1 and k0 ^ k1 ^ 0x1BD11BDA injected after each
  group of four rounds, five groups;
- `PRNGKey(seed)` = [seed >> 32, seed & 0xFFFFFFFF];
- `FoldIn(key, d)` = Threefry2x32(key, (0, d));
- `Split(key, n)[i]` = Threefry2x32(key, (0, i)), the partitionable
  ("foldlike") split;
- `Bits32(key, shape)` = b0 ^ b1 of Threefry2x32(key, (hi, lo)) over the
  flat index of each element, split into its high and low 32 bits;
- `Uniform`: the mantissa (bits >> 9) | 0x3f800000 as a float32, minus 1,
  then times (1 - tiny) (1.0 in float32), plus tiny, floored at tiny;
- `Gumbel` in JAX's default mode ("low"): -log(-log(u));
- `Uniform01`: `jax.random.uniform(key, shape)` on [0, 1), the same
  mantissa minus 1 with no floor (dropout and the sampled softmax's
  negatives draw these);
- `Bernoulli`: `jax.random.bernoulli(key, p, shape)`, Uniform01 < float32(p).

The bits, uniforms and Bernoulli masks equal JAX's bit for bit. `log` is the framework's:
PyTorch's and XLA's float32 logarithms differ by one ulp on some
elements, so a Gumbel value may differ by about 1e-6 and a token only
where two perturbed logits are that close.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32's smallest normal number: the floor of the uniforms
TINY = float(np.finfo(np.float32).tiny)


def _Rotl(x, r: int):
  return ((x << r) | (x >> (32 - r))) & MASK32


def Threefry2x32(k0, k1, x0, x1):
  """Threefry-2x32, 20 rounds, on broadcastable int64 tensors (or Python
  ints) that hold uint32 values -> (y0, y1) int64 tensors."""
  ks = (k0, k1, k0 ^ k1 ^ _PARITY)
  x0 = (x0 + ks[0]) & MASK32
  x1 = (x1 + ks[1]) & MASK32
  for group in range(5):
    for r in ROTATIONS[group % 2]:
      x0 = (x0 + x1) & MASK32
      x1 = _Rotl(x1, r) ^ x0
    x0 = (x0 + ks[(group + 1) % 3]) & MASK32
    x1 = (x1 + ks[(group + 2) % 3] + group + 1) & MASK32
  return x0, x1


def _AsKey(key):
  key = torch.as_tensor(key, dtype=torch.int64)
  if key.shape[-1:] != (2,):
    raise ValueError(
        f"a key is [..., 2] uint32 words, got {tuple(key.shape)}")
  return key


def PRNGKey(seed: int):
  """jax.random.PRNGKey(seed): the key [seed >> 32, seed & 0xFFFFFFFF]
  (a CPU int64 tensor [2])."""
  seed = int(seed) & 0xFFFFFFFFFFFFFFFF
  return torch.tensor([seed >> 32, seed & MASK32], dtype=torch.int64)


def FoldIn(key, data):
  """jax.random.fold_in: Threefry2x32(key, (0, data)). key [..., 2];
  data an int or an integer tensor broadcastable against key[..., 0],
  taken as uint32 (its low 32 bits). -> [..., 2]."""
  key = _AsKey(key)
  d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
  y0, y1 = Threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
  return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def Split(key, num: int = 2):
  """jax.random.split under jax_threefry_partitionable: key i is
  Threefry2x32(key, (0, i)). key [2] -> [num, 2]."""
  key = _AsKey(key)
  return FoldIn(key, torch.arange(num, dtype=torch.int64, device=key.device))


def _Counters(shape, device):
  """The flat index of every element of `shape`, as its (high, low) 32-bit
  words."""
  n = int(np.prod(shape, dtype=np.int64))
  idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
  return idx >> 32, idx & MASK32


def Bits32(key, shape, device=None):
  """jax.random.bits(key, shape, uint32): b0 ^ b1 over flat-index counters.
  key [..., 2] draws one array of `shape` per leading index: -> [...,
  *shape] int64 holding uint32 values, on `device` (default the key's).
  A single key on the CPU enters as two Python ints, the kernels' scalar
  arguments, so a draw on a card copies nothing to it and never waits
  for its stream."""
  key = _AsKey(key)
  device = key.device if device is None else torch.device(device)
  hi, lo = _Counters(tuple(shape), device)
  if key.dim() == 1 and key.device.type == "cpu":
    k0, k1 = key.tolist()
  else:
    lead = key.shape[:-1]
    key = key.to(device)
    k0 = key[..., 0].reshape(lead + (1,) * len(shape))
    k1 = key[..., 1].reshape(lead + (1,) * len(shape))
  y0, y1 = Threefry2x32(k0, k1, hi, lo)
  return y0 ^ y1


def UniformFromBits(bits):
  """uint32 bits -> float32 uniforms in [tiny, 1): JAX's mantissa trick,
  then `* (1 - tiny) + tiny` (the product by 1.0 is exact) and the floor
  at tiny."""
  mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
  return torch.clamp_min((mant - 1.0) + TINY, TINY)


def Uniform(key, shape):
  """jax.random.uniform(key, shape, float32, minval=tiny, maxval=1), the
  uniforms Gumbel draws."""
  return UniformFromBits(Bits32(key, shape))


def Gumbel(key, shape):
  """jax.random.gumbel(key, shape, float32), mode "low"."""
  return -torch.log(-torch.log(Uniform(key, shape)))



def Uniform01(key, shape, device=None):
  """jax.random.uniform(key, shape, float32) on [0, 1), on `device`: the
  mantissa trick minus 1 (the product by maxval - minval = 1 and the sum
  with minval = 0 are exact, and so is the floor at 0)."""
  mant = ((Bits32(key, shape, device) >> 9) | 0x3F800000).to(
      torch.int32).view(torch.float32)
  return mant - 1.0


def Bernoulli(key, p: float, shape, device=None):
  """jax.random.bernoulli(key, p, shape), mode "low": a bool tensor on
  `device`, Uniform01(key, shape) < float32(p)."""
  return Uniform01(key, shape, device) < float(np.float32(p))
