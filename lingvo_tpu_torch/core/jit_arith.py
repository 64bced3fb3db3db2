"""Divisions by a constant, rounded as the reference's programs round them.

The port follows the reference's arithmetic as the reference program
runs it. Where the reference computes `x / c` for a Python float `c`
inside a jitted program, XLA compiles the division to a product with the
float32 reciprocal of `c`, and that product is what its users' tokens
come from; the port multiplies by `Reciprocal(c)`. Where the reference
divides eagerly, the port divides.

`Reciprocal(c)` is a Python float that is exactly a float32, so
`x * Reciprocal(c)` is that float32 product on every device, with no
tensor and no launch. (PyTorch divides a float32 tensor by a Python
scalar exactly on the CPU, and as a product with the scalar's reciprocal
on CUDA; a tensor divisor takes the true division on both.)

The sites: the int8 scales of K/V rows (`quant/kv.QuantizeKv`) and of
activations (`ops/int8_matmul`'s kernel (a) and its plain version),
`ScaleFromAmax`; the sampling temperature (`core/sampling`); and, eager
in the reference, the scale of an int8 weight, `WeightScale`.
"""

from __future__ import annotations

import numpy as np
import torch


def Reciprocal(c: float) -> float:
  """float32(1) / float32(c), rounded once in float32: the factor XLA
  multiplies by where a jitted program of the reference divides by c."""
  return float(np.float32(1.0) / np.float32(c))


# float32(1 / 127), the int8 scale's factor
INV_127 = Reciprocal(127.0)


def ScaleFromAmax(amax):
  """max(amax * float32(1 / 127), 1e-8): the symmetric int8 scale of a
  tensor the reference quantizes inside a jitted program (K/V rows,
  activations in `Int8Einsum`), where XLA makes `amax / 127.0` a product
  with the constant's float32 reciprocal."""
  return torch.clamp(amax * INV_127, min=1e-8)


def WeightScale(amax):
  """max(amax / 127, 1e-8) with a true division on every device: the
  scale of a weight, which the reference quantizes eagerly
  (`Int8ServingTheta` from the engine's constructor and `DecodeOnce`)."""
  return torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)
