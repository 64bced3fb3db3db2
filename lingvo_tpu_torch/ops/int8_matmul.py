"""The int8-serving matmul: per-tensor quantized activations times an int8 weight, with the two-scale epilogue.

The integer product of `core/quant_utils.Int8Einsum`, which the
reference runs as an XLA dot_general with preferred_element_type=int32
(lingvo_tpu/core/quant_utils.py:265). It replaces no `pallas_call`: the
reference has no Pallas kernel here. On CUDA no PyTorch call computes it
(torch.matmul has no integer kernel there, torch._int_mm refuses M <= 16
and applies no scale), so the card runs two hand kernels,
`ops/csrc/int8_matmul.cu`:

- `QuantizeActivations` (kernel (a)): x [M, K] float32 -> (x8 [M, Kp]
  int8, x_scale [1] float32). x_scale = max(amax(|x|) * float32(1 / 127),
  1e-8) over the whole x of the call (the reference's `amax / 127.0` as
  its jitted programs compute it, `core/jit_arith.ScaleFromAmax`); x8 =
  clip(round(x / x_scale), -128, 127) with a true division and round
  half to even; rows zero-padded to Kp, K rounded up to 16 bytes.
- `Int8Gemm` (kernel (b)): (x8, x_scale, w [N, K] int8, w_scale [N]
  float32) -> y [M, N] float32 = (float(x8 . w^T) * x_scale) * w_scale,
  two separate multiplies in the reference's order. The product is
  int32 and exact; K is split over blocks at small M (`GemmGeometry`),
  which changes no bit.

`Int8Matmul` is the two in a row, launched from one C call over one
scratch allocation: the serving path, where the host time per
projection is what a host-bound step waits on. Each has a plain PyTorch
version in
this module (`_PlainQuantize`, `_PlainGemm`) with the reference's op
order: the CPU path, and the kernels' yardstick on the card, where the
plain product is a float64 matmul cast back to int32, exact because
every partial sum is an integer below 2^31 < 2^53. A wrapper takes the
plain version only for CPU tensors; a CUDA tensor launches its kernel or
raises. Each wrapper counts its launches.

Under fprop_dtype=bfloat16 x and y are bfloat16: the reference quantizes
`x.astype(float32)` and returns `y.astype(x.dtype)`. Both kernels have a
bfloat16 instantiation (kernel (a) widens x on load, kernel (b) rounds y
to bfloat16 after its two float32 multiplies), so their bits are those of
the float32 kernels on the widened x, rounded; the weight scales stay
float32 tensors (the bfloat16-rounded scales widened exactly, once).

What bounds the kernels at the serving shapes (M = 8 decode rows, M =
264 packed tokens): the weight's bytes, 1 per element; the operations,
2 M K N, sit far under the int8 tensor cores' rate.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from lingvo_tpu_torch.core import jit_arith
from lingvo_tpu_torch.ops import cuda_build
from lingvo_tpu_torch.ops.ragged_block_attend import CheckAligned
from lingvo_tpu_torch.quant import kv as kv_quant

K_ALIGN = 16      # x8 rows are padded to a multiple of 16 bytes
TILE_K = 64       # K bytes of one kernel stage
TILE_N = 128      # output columns of a block
MAX_N_TILES = 65535   # the GEMM grid's y extent
# the dtypes of x and y the kernels take
ACT_DTYPES = (torch.float32, torch.bfloat16)


def _Bf16(dtype) -> int:
  """The kernels' flag for x's (or y's) dtype: 1 for bfloat16."""
  return int(dtype == torch.bfloat16)


def PaddedK(k: int) -> int:
  """The row length of the quantized activations: K rounded up to 16."""
  return -(-k // K_ALIGN) * K_ALIGN


def GemmGeometry(m: int, k: int, n: int, sms: int) -> dict:
  """The GEMM kernel's launch for an [m, k] x [n, k]^T product on a card
  of `sms` SMs: rows a block (16 for m <= 16, else 64), the tile grid,
  and the K split. K is split only while the tiles alone would leave
  blocks for fewer than 2 x sms, in whole 64-byte chunks, no split empty."""
  bm = 16 if m <= 16 else 64
  m_tiles, n_tiles = -(-m // bm), -(-n // TILE_N)
  chunks = -(-k // TILE_K)
  splits = max(1, min(chunks, -(-2 * sms // (m_tiles * n_tiles))))
  per_split = -(-chunks // splits)
  splits = -(-chunks // per_split)
  return dict(bm=bm, m_tiles=m_tiles, n_tiles=n_tiles, splits=splits,
              chunks_per_split=per_split)


def KernelLimitError(m: int, k: int, n: int) -> str | None:
  """Why the kernels cannot take an [m, k] x [n, k]^T product, or None."""
  if m < 1 or k < 1 or n < 1:
    return f"Int8Matmul kernels take m, k, n >= 1, got {m}, {k}, {n}"
  if -(-n // TILE_N) > MAX_N_TILES:
    return f"n = {n} exceeds the GEMM kernel's {MAX_N_TILES} column tiles"
  return None


# -- plain versions ------------------------------------------------------------


def _PlainQuantize(x):
  """x [M, K] -> (x8 [M, Kp] int8, x_scale [1] float32), the reference's
  ops as its jitted step runs them: a max over the whole tensor, the
  product by float32(1 / 127) (`core/jit_arith.ScaleFromAmax`), a true
  division by the scale, round half to even, clip, cast."""
  x32 = x.float()
  x_scale = jit_arith.ScaleFromAmax(torch.amax(torch.abs(x32)))
  x8 = torch.clamp(torch.round(x32 / x_scale), -128, 127).to(torch.int8)
  kp = PaddedK(x.shape[1])
  if kp != x.shape[1]:
    x8 = F.pad(x8, (0, kp - x.shape[1]))
  return x8, x_scale.reshape(1)


def _PlainGemm(x8, x_scale, w, w_scale):
  """The int32 product x8[:, :K] . w^T (an int32 matmul on the CPU, a
  float64 one cast back on the card: exact either way), then float32
  times x_scale, then times w_scale[n]."""
  a = x8[:, :w.shape[1]]
  if a.device.type == "cpu":
    acc = torch.matmul(a.to(torch.int32), w.to(torch.int32).t())
  else:
    acc = torch.matmul(a.double(), w.double().t()).to(torch.int32)
  y = acc.float() * x_scale
  return y * w_scale


# -- the CUDA kernels ----------------------------------------------------------


_lib = None   # the loaded kernel library, with its C signatures declared


def _Lib():
  global _lib
  if _lib is None:
    lib = cuda_build.Load("int8_matmul")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.Int8QuantizeGrid.argtypes = [ci, ci, vp]
    lib.Int8QuantizeGrid.restype = ci
    lib.Int8Quantize.argtypes = [vp] * 4 + [ci] * 5 + [vp]
    lib.Int8Quantize.restype = ci
    lib.Int8Gemm.argtypes = [vp] * 7 + [ci] * 8 + [vp]
    lib.Int8Gemm.restype = ci
    lib.Int8MatmulScratch.argtypes = [ci] * 6 + [vp]
    lib.Int8MatmulScratch.restype = ctypes.c_longlong
    lib.Int8Matmul.argtypes = [vp] * 5 + [ci] * 9 + [vp]
    lib.Int8Matmul.restype = ci
    lib.Int8MatmulErrorString.argtypes = [ci]
    lib.Int8MatmulErrorString.restype = ctypes.c_char_p
    _lib = lib
  return _lib


def _Raise(what, rc):
  raise RuntimeError(f"{what} failed: "
                     + _Lib().Int8MatmulErrorString(rc).decode())


@functools.lru_cache(maxsize=None)
def _Plan(m: int, k: int, n: int, index: int) -> dict:
  """`GemmGeometry` on device `index`, once per shape: the serving step
  repeats a few shapes, and its host time is what a step waits on."""
  return GemmGeometry(
      m, k, n, torch.cuda.get_device_properties(index).multi_processor_count)


@functools.lru_cache(maxsize=None)
def _QuantizeGrid(m: int, kp: int, index: int) -> int:
  """Kernel (a)'s cooperative grid on device `index` (the current one when
  first asked), once per shape."""
  grid = ctypes.c_int(0)
  rc = _Lib().Int8QuantizeGrid(m, kp, ctypes.addressof(grid))
  if rc != 0:
    _Raise("Int8QuantizeGrid", rc)
  return grid.value


@functools.lru_cache(maxsize=None)
def _MatmulPlan(m: int, k: int, n: int, index: int) -> tuple:
  """(kp, (a)'s grid, (b)'s rows a block, splits, chunks a split, scratch
  bytes) of an [m, k] x [n, k]^T product on device `index`, once per
  shape. Raises for a shape the kernels refuse."""
  reason = KernelLimitError(m, k, n)
  if reason is not None:
    raise ValueError(reason)
  kp = PaddedK(k)
  grid = _QuantizeGrid(m, kp, index)
  geo = _Plan(m, k, n, index)
  at = (ctypes.c_longlong * 5)()
  nbytes = _Lib().Int8MatmulScratch(m, kp, n, grid, geo["bm"],
                                    geo["splits"], at)
  return (kp, grid, geo["bm"], geo["splits"], geo["chunks_per_split"],
          nbytes)


def _CudaMatmul(x, w, w_scale):
  """Kernels (a) and (b) in one call over one scratch allocation: the
  serving step's path, whose host time per projection a step waits on."""
  m, k = x.shape
  n = w.shape[0]
  kp, grid, bm, splits, per_split, nbytes = _MatmulPlan(m, k, n,
                                                        x.device.index)
  y = torch.empty((m, n), dtype=x.dtype, device=x.device)
  scratch = torch.empty((nbytes,), dtype=torch.int8, device=x.device)
  rc = _Lib().Int8Matmul(
      x.data_ptr(), w.data_ptr(), w_scale.data_ptr(), y.data_ptr(),
      scratch.data_ptr(), m, k, kp, n, grid, bm, splits, per_split,
      _Bf16(x.dtype), torch.cuda.current_stream(x.device).cuda_stream)
  if rc != 0:
    _Raise("Int8Matmul kernel launches", rc)
  _Count(QuantizeActivations, x.dtype)
  _Count(Int8Gemm, x.dtype)
  return y


def _CudaQuantize(x):
  m, k = x.shape
  reason = KernelLimitError(m, k, 1)
  if reason is not None:
    raise ValueError(reason)
  CheckAligned("Int8Quantize", [x])
  kp = PaddedK(k)
  grid = _QuantizeGrid(m, kp, x.device.index)
  # one allocation: x8's m * kp bytes (a multiple of 16), the scale, then
  # the blocks' maxima (scratch)
  at = m * kp
  buf = torch.empty((at + 16 + 4 * grid,), dtype=torch.int8,
                    device=x.device)
  x8 = buf[:at].view(m, kp)
  x_scale = buf[at:at + 4].view(torch.float32)
  stream = torch.cuda.current_stream(x.device).cuda_stream
  rc = _Lib().Int8Quantize(x.data_ptr(), x8.data_ptr(), x_scale.data_ptr(),
                           x_scale.data_ptr() + 16, m, k, kp, grid,
                           _Bf16(x.dtype), stream)
  if rc != 0:
    _Raise("Int8Quantize kernel launch", rc)
  _Count(QuantizeActivations, x.dtype)
  return x8, x_scale


def _CudaGemm(x8, x_scale, w, w_scale, out_dtype):
  m, kp = x8.shape
  n, k = w.shape
  reason = KernelLimitError(m, k, n)
  if reason is not None:
    raise ValueError(reason)
  CheckAligned("Int8Gemm", [x8, w, w_scale])
  if x_scale.data_ptr() % 4:
    raise ValueError("Int8Gemm takes a 4-byte aligned x_scale")
  geo = _Plan(m, k, n, x8.device.index)
  y = torch.empty((m, n), dtype=out_dtype, device=x8.device)
  ws = counters = None
  if geo["splits"] > 1:
    # one allocation: the tiles' counters (padded to 16 bytes), then the
    # splits' [splits, m, n] int32 partials
    tiles = -(-geo["m_tiles"] * geo["n_tiles"] // 4) * 4
    scratch = torch.empty((tiles + geo["splits"] * m * n,),
                          dtype=torch.int32, device=x8.device)
    counters, ws = scratch[:tiles], scratch[tiles:]
  lib = _Lib()
  stream = torch.cuda.current_stream(x8.device).cuda_stream
  rc = lib.Int8Gemm(
      x8.data_ptr(), w.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
      y.data_ptr(), None if ws is None else ws.data_ptr(),
      None if counters is None else counters.data_ptr(), m, k, kp, n,
      geo["bm"], geo["splits"], geo["chunks_per_split"], _Bf16(out_dtype),
      stream)
  if rc != 0:
    _Raise("Int8Gemm kernel launch", rc)
  _Count(Int8Gemm, out_dtype)
  return y


# -- public entries ------------------------------------------------------------


def _Count(wrapper, dtype):
  wrapper.launches += 1
  wrapper.launches_by_dtype[kv_quant.DtypeName(dtype)] += 1


def _CheckDevice(name, tensors):
  dev = tensors[0].device
  if dev.type not in ("cpu", "cuda"):
    raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
  for x in tensors:
    if x.device != dev:
      raise ValueError(f"{name}: tensor on {x.device}, another on {dev}")
  return dev


def QuantizeActivations(x):
  """x [M, K] float32 or bfloat16 -> (x8 [M, Kp] int8, x_scale [1]
  float32), the per-tensor symmetric quantization of the whole x, widened
  (see the module docstring). CPU tensors run the plain version; CUDA
  tensors launch kernel (a) (one count in `QuantizeActivations.launches`
  and in `.launches_by_dtype` by x's dtype) or raise."""
  if x.ndim != 2 or x.dtype not in ACT_DTYPES:
    raise TypeError(f"QuantizeActivations takes float32 or bfloat16 [M, K], "
                    f"got {x.dtype} {tuple(x.shape)}")
  if _CheckDevice("QuantizeActivations", [x]).type == "cpu":
    return _PlainQuantize(x)
  return _CudaQuantize(x)


def Int8Gemm(x8, x_scale, w, w_scale, out_dtype=torch.float32):
  """(x8 [M, Kp] int8, x_scale [1] float32, w [N, K] int8 K-major, w_scale
  [N] float32) -> y [M, N] = (float(x8[:, :K] . w^T) * x_scale) * w_scale
  in float32, then in out_dtype (float32 or bfloat16, rounded once). CPU
  tensors run the plain version; CUDA tensors launch kernel (b) (one
  count in `Int8Gemm.launches` and in `.launches_by_dtype` by out_dtype)
  or raise."""
  if out_dtype not in ACT_DTYPES:
    raise TypeError(f"Int8Gemm writes float32 or bfloat16, not {out_dtype}")
  if x8.dtype != torch.int8 or w.dtype != torch.int8:
    raise TypeError(f"Int8Gemm takes int8 operands, got {x8.dtype}, "
                    f"{w.dtype}")
  if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
    raise TypeError("Int8Gemm takes float32 scales")
  if (x8.ndim != 2 or w.ndim != 2 or x8.shape[1] != PaddedK(w.shape[1])
      or tuple(x_scale.shape) != (1,) or tuple(w_scale.shape) != (
          w.shape[0],)):
    raise ValueError(
        f"Int8Gemm shapes: x8 {tuple(x8.shape)}, x_scale "
        f"{tuple(x_scale.shape)}, w {tuple(w.shape)}, w_scale "
        f"{tuple(w_scale.shape)}")
  dev = _CheckDevice("Int8Gemm", [x8, x_scale, w, w_scale])
  if x8.shape[0] == 0:
    return torch.zeros((0, w.shape[0]), dtype=out_dtype, device=dev)
  if dev.type == "cpu":
    return _PlainGemm(x8, x_scale, w, w_scale).to(out_dtype)
  return _CudaGemm(x8, x_scale, w, w_scale, out_dtype)


def Int8Matmul(x, w, w_scale):
  """x [M, K] float32 or bfloat16, w [N, K] int8 (K-major), w_scale [N]
  float32 -> [M, N] in x's dtype: `QuantizeActivations` then `Int8Gemm`.
  CUDA tensors launch kernels (a) and (b) from one call (one count in
  each wrapper's `launches` and `launches_by_dtype`) or raise."""
  if (x.ndim != 2 or w.ndim != 2 or x.dtype not in ACT_DTYPES
      or w.dtype != torch.int8 or w_scale.dtype != torch.float32
      or x.shape[1] != w.shape[1] or tuple(w_scale.shape) != (w.shape[0],)):
    raise ValueError(
        f"Int8Matmul takes x [M, K] float32 or bfloat16, w [N, K] int8, "
        f"w_scale [N] float32; got {x.dtype} {tuple(x.shape)}, {w.dtype} "
        f"{tuple(w.shape)}, {w_scale.dtype} {tuple(w_scale.shape)}")
  dev = _CheckDevice("Int8Matmul", [x, w, w_scale])
  if x.shape[0] == 0:
    return torch.zeros((0, w.shape[0]), dtype=x.dtype, device=dev)
  if dev.type == "cpu":
    return _PlainGemm(*_PlainQuantize(x), w, w_scale).to(x.dtype)
  CheckAligned("Int8Matmul", [x, w, w_scale])
  return _CudaMatmul(x, w, w_scale)


# kernel launches, in all and by x's (y's) dtype (the plain versions count
# none)
QuantizeActivations.launches = 0
QuantizeActivations.launches_by_dtype = {
    kv_quant.DtypeName(d): 0 for d in ACT_DTYPES}
Int8Gemm.launches = 0
Int8Gemm.launches_by_dtype = {kv_quant.DtypeName(d): 0 for d in ACT_DTYPES}
