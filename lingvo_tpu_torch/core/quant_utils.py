"""Int8 weight serving: quantize a weight once, run its matmuls as int8 x int8 -> int32 (port of part of lingvo_tpu/core/quant_utils.py).

The int8-serving half of the reference module: `Int8QuantizeWeight`,
`Int8Einsum` and the `Int8Weight` theta leaf, with the reference's
arithmetic in the reference's order:

- a weight's scale is max(amax(|w|) / 127, 1e-8) over its contraction
  axes (per output channel) or over the whole weight (per tensor), and
  w8 = clip(round(w / scale), -128, 127), a true division and round half
  to even (the reference quantizes weights eagerly: true divisions);
- `Int8Einsum` quantizes the activations per call with ONE scale over the
  whole x, x_scale = max(amax(|x|) * float32(1 / 127), 1e-8) (the
  reference's `/ 127.0` inside its jitted step programs, which XLA makes
  a reciprocal product), takes the int32 product,
  then float32(acc) * x_scale, then * w_scale[n] as a second multiply, and
  casts to x's dtype.

The product is `ops/int8_matmul.Int8Matmul`: the plain version for CPU
tensors, the two CUDA kernels for CUDA tensors (or a raise). The QAT
domains of the reference module (`QDomain`, `SymmetricQDomain`, ...,
`ScheduledClipQDomain`) are not ported.

`Int8Weight` keeps its integer values in one copy only, K-major ([N, K]:
each output channel's contraction values contiguous, the layout the
tensor cores take): a 'dv' leaf ([in..., out...]) is transposed once when
the leaf is made, never per call. `w_int8` is the reference's layout as a
view of that copy.
"""

from __future__ import annotations

import math

import torch

from lingvo_tpu_torch.core import jit_arith
from lingvo_tpu_torch.ops import int8_matmul


def _ContractAxes(ndim: int, layout: str, contract_ndim: int | None):
  """Which weight axes are contracted for a given layout.

  'dv': the contraction axes LEAD (w [in..., out...]): per-channel scales
  live on the trailing output axes. 'vd': the contraction axes TRAIL (w
  [out..., in...]): scales live on the leading output axes.
  contract_ndim=None keeps the legacy 'dv' default of all-but-last.
  Returns (contraction axes, contract_ndim)."""
  assert layout in ("dv", "vd"), layout
  if contract_ndim is None:
    contract_ndim = ndim - 1 if layout == "dv" else 1
  assert 0 < contract_ndim < ndim, (contract_ndim, ndim)
  if layout == "dv":
    return tuple(range(contract_ndim)), contract_ndim
  return tuple(range(ndim - contract_ndim, ndim)), contract_ndim


def Int8QuantizeWeight(w, per_channel: bool = True, layout: str = "dv",
                       contract_ndim: int | None = None):
  """float weight -> (int8 weight, float32 scale) for serving.

  Per-channel scales reduce over the contraction axes only (one scale per
  output channel), keepdims so the scale broadcasts against w:

    layout='dv'  w [in..., out...]  -> scale [1..., out...]
    layout='vd'  w [out..., in...]  -> scale [out..., 1...]

  per_channel=False: one scale over the whole weight, a 0-d tensor."""
  w32 = w.float()
  if per_channel:
    reduce_axes, _ = _ContractAxes(w.ndim, layout, contract_ndim)
    amax = torch.amax(torch.abs(w32), dim=reduce_axes, keepdim=True)
  else:
    amax = torch.amax(torch.abs(w32))
  scale = jit_arith.WeightScale(amax)
  w_int8 = torch.clamp(torch.round(w32 / scale), -128, 127).to(torch.int8)
  return w_int8, scale


def _Dims(shape, layout: str, contract_ndim: int | None):
  """(in_dims, out_dims) of a weight of `shape` under the layout."""
  _, k = _ContractAxes(len(shape), layout, contract_ndim)
  shape = tuple(shape)
  if layout == "dv":
    return shape[:k], shape[k:]
  return shape[len(shape) - k:], shape[:len(shape) - k]


def _KMajor(w_int8, layout: str, contract_ndim: int | None):
  """The [N, K] K-major matrix of a weight in the reference layout (a
  copy for 'dv', a view of a contiguous 'vd' weight)."""
  in_dims, out_dims = _Dims(w_int8.shape, layout, contract_ndim)
  kk, nn = math.prod(in_dims), math.prod(out_dims)
  if layout == "dv":
    return w_int8.reshape(kk, nn).t().contiguous()
  return w_int8.reshape(nn, kk).contiguous()


def _ScaleVector(scale, n: int):
  """[N] float32 per-channel scales; a single scale repeated (the same
  bits as multiplying by the scalar)."""
  vec = scale.float().reshape(-1)
  if vec.numel() == 1:
    vec = vec.expand(n)
  return vec.contiguous()


def _Product(x, w_nk, scale_vec, in_dims, out_dims):
  """x [..., in...] through the int8 matmul against w_nk [N, K] ->
  [..., out...] in x's dtype. A float32 or bfloat16 x goes to the matmul
  as it is (its bfloat16 kernels widen x on load and round y, the
  reference's x.astype(float32) ... .astype(x.dtype)); another float
  dtype is widened first."""
  k = len(in_dims)
  assert tuple(x.shape[x.ndim - k:]) == tuple(in_dims), (x.shape, in_dims)
  batch_shape = tuple(x.shape[:x.ndim - k])
  xk = x if x.dtype in int8_matmul.ACT_DTYPES else x.float()
  x2 = xk.reshape(-1, math.prod(in_dims)).contiguous()
  y = int8_matmul.Int8Matmul(x2, w_nk, scale_vec)
  return y.reshape(batch_shape + tuple(out_dims)).to(x.dtype)


def Int8Einsum(x, w_int8, w_scale, layout: str = "dv",
               contract_ndim: int | None = None):
  """y = x . dequant(w) computed as int8 x int8 -> int32.

  Activations are quantized per call, per tensor, symmetric. x's trailing
  contract_ndim axes contract against the weight's contraction axes
  (leading for 'dv', trailing for 'vd'); w_scale is the matching
  per-channel scale (or a scalar). Returns x.dtype with shape [...,
  out...]. A 'dv' weight given here is made K-major per call; the layers
  call `Int8Weight.Einsum`, whose weight already is."""
  in_dims, out_dims = _Dims(w_int8.shape, layout, contract_ndim)
  w_nk = _KMajor(w_int8, layout, contract_ndim)
  return _Product(x, w_nk, _ScaleVector(w_scale, w_nk.shape[0]), in_dims,
                  out_dims)


class Int8Weight:
  """A theta leaf served as int8: integer values + per-channel float32
  scales.

  Layers whose matmuls understand this leaf (ProjectionLayer, the
  attention projections, SharedEmbeddingSoftmaxLayer) route it through
  the int8 matmul; the weight never re-materializes in float.
  layout/contract_ndim describe which axes the consuming einsum
  contracts (see `Int8QuantizeWeight`). The integer values are stored
  once, K-major, as `w_nk` [N, K]; `w_int8` is the reference layout as a
  view of it."""

  def __init__(self, w_int8, scale, layout: str = "dv",
               contract_ndim: int | None = None):
    self.layout = layout
    self.contract_ndim = contract_ndim
    self._shape = tuple(w_int8.shape)
    self._in_dims, self._out_dims = _Dims(self._shape, layout, contract_ndim)
    self.w_nk = _KMajor(w_int8, layout, contract_ndim)
    self.scale = scale
    self._scale_vec = _ScaleVector(scale, self.w_nk.shape[0])

  @property
  def w_int8(self):
    """The integer values in the reference layout (a view of w_nk)."""
    if self.layout == "dv":
      return self.w_nk.t().reshape(self._shape)
    return self.w_nk.reshape(self._shape)

  @property
  def shape(self):
    return self._shape

  def Dequant(self):
    """The exact float grid: w_int8 * scale, float32."""
    return self.w_int8.float() * self.scale.float()

  def Einsum(self, x):
    """x [..., in...] -> [..., out...] via the integer matmul."""
    return _Product(x, self.w_nk, self._scale_vec, self._in_dims,
                    self._out_dims)

  def WithScale(self, scale) -> "Int8Weight":
    """The same integer values (shared, not copied) with another scale
    tensor of the same shape: the cast of a leaf whose float scale follows
    the activation dtype."""
    out = object.__new__(Int8Weight)
    out.__dict__.update(self.__dict__)
    out.scale = scale
    out._scale_vec = _ScaleVector(scale, self.w_nk.shape[0])
    return out

  @classmethod
  def Quantize(cls, w, layout: str = "dv", contract_ndim: int | None = None):
    w_int8, scale = Int8QuantizeWeight(w, per_channel=True, layout=layout,
                                       contract_ndim=contract_ndim)
    return cls(w_int8, scale, layout=layout, contract_ndim=contract_ndim)

  def __repr__(self):
    return (f"Int8Weight(shape={self._shape}, layout={self.layout!r}, "
            f"contract_ndim={self.contract_ndim})")
