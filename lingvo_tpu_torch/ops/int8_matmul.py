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
  half to even; rows zero-padded to Kp, K rounded up to 16 bytes. One
  block or one thread-block cluster, sized to x (`QuantizePlan`).
- `Int8Gemm` (kernel (b)): (x8, x_scale, w [N, K] int8, w_scale [N]
  float32) -> y [M, N] float32 = (float(x8 . w^T) * x_scale) * w_scale,
  two separate multiplies in the reference's order. wgmma int8 on
  TMA-fed tiles; the operands swap for M <= 64, and K is split over the
  blocks of a cluster where the tiles alone leave the card idle
  (`GemmPlan`). The product is int32 and exact, so no plan changes a bit.

`Int8Matmul` is the two in a row, launched from one C call over one
scratch allocation (x8 and the scale), (b) as a programmatic dependent
of (a) so that its weight stream overlaps (a): the serving path, where
the host time per projection is what a host-bound step waits on. Each
has a plain PyTorch version in this module (`_PlainQuantize`,
`_PlainGemm`) with the reference's op order: the CPU path, and the
kernels' yardstick on the card, where the plain product is a float64
matmul cast back to int32, exact because every partial sum is an integer
below 2^31 < 2^53. A wrapper takes the plain version only for CPU
tensors; a CUDA tensor launches its kernel or raises. Each wrapper counts
its launches.

Under fprop_dtype=bfloat16 x and y are bfloat16: the reference quantizes
`x.astype(float32)` and returns `y.astype(x.dtype)`. Both kernels have a
bfloat16 instantiation (kernel (a) widens x on load, kernel (b) rounds y
to bfloat16 after its two float32 multiplies), so their bits are those of
the float32 kernels on the widened x, rounded; the weight scales stay
float32 tensors (the bfloat16-rounded scales widened exactly, once).

What bounds the kernels at the serving shapes (M = 8 decode rows, M =
264 packed tokens): the weight's bytes, 1 per element, for (b), whose 2 M
K N operations sit far under the int8 tensor cores' rate; latency for
(a), which moves kilobytes to megabytes.
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
K_BLOCK = 128     # K bytes of a GEMM stage (one 128-byte swizzled row)
SWAP_MAX_M = 64   # rows up to which the GEMM swaps its operands
SWAP_N = (8, 16, 32, 64)   # the swapped B operand's widths (x8 rows)
MAX_CLUSTER = 8   # blocks of a cluster (the portable limit)
# a block's fixed cost (first loads, cluster reduce, epilogue) in units of
# one K block's stream, and the blocks an SM streams for at full rate: the
# K split's cost model, fitted to the split sweeps of
# `tools/torch_int8_probe.py --sweep` (PERF.md)
GEMM_OVERHEAD_KBLOCKS = 8
GEMM_STREAMS_PER_SM = 2
SMEM_PER_SM = 233472   # bytes of shared memory an H100 SM gives its blocks
QUANT_MIN_BYTES = 8 << 10   # the least x a block of (a)'s cluster takes
QUANT_HOLD_BYTES = 224 << 10   # x a block of (a) holds in shared memory
# the dtypes of x and y the kernels take
ACT_DTYPES = (torch.float32, torch.bfloat16)


def _Bf16(dtype) -> int:
  """The kernels' flag for x's (or y's) dtype: 1 for bfloat16."""
  return int(dtype == torch.bfloat16)


def PaddedK(k: int) -> int:
  """The row length of the quantized activations: K rounded up to 16."""
  return -(-k // K_ALIGN) * K_ALIGN


def QuantizePlan(m: int, k: int, itemsize: int,
                 max_blocks: int = MAX_CLUSTER) -> dict:
  """Kernel (a)'s launch for x [m, k] of `itemsize` bytes a value: one
  cluster of `blocks` blocks (at most max_blocks, what the card places:
  MAX_CLUSTER or 16, `QuantizeMaxBlocks`; at least QUANT_MIN_BYTES of x each
  where x has that much), `rows` whole rows a block (the last one fewer,
  none empty), `held` of them held in the block's shared memory: all
  where they fit, else none (every row read twice: measured faster than
  holding a part, PERF.md)."""
  row = k * itemsize
  blocks = max(1, min(max_blocks, m, -(-m * row // QUANT_MIN_BYTES)))
  rows = -(-m // blocks)
  blocks = -(-m // rows)
  return dict(blocks=blocks, rows=rows,
              held=rows if rows * row <= QUANT_HOLD_BYTES else 0)


def _GemmConfig(swap: bool, nb: int) -> dict:
  """Kernel (b)'s block for an orientation and B width, as
  `int8_matmul.cu` `GemmCfg` builds it: warpgroups, stages, threads,
  dynamic shared memory, and how many blocks an SM holds."""
  wg = 1 if swap else 2
  stages = 6 if swap else 3
  threads = 128 * wg + 32
  smem = 1024 + stages * (64 * wg + nb) * K_BLOCK + 16 * stages
  # the SM keeps 1 KB of its shared memory for each resident block
  per_sm = min(SMEM_PER_SM // (smem + 1024), 2048 // threads)
  return dict(wg=wg, stages=stages, threads=threads, smem=smem,
              per_sm=per_sm)


def GemmPlan(m: int, k: int, n: int, sms: int) -> dict:
  """Kernel (b)'s launch for an [m, k] x [n, k]^T product on a card of
  `sms` SMs. m <= SWAP_MAX_M swaps the operands: the weight's rows are the
  64-row A operand, x8's m rows (rounded up to a width of SWAP_N, `nb`)
  the B operand, a tile 64 columns of y wide; else 128 rows of x8 times
  128 of the weight. `cluster` blocks (a power of two: clusters of 3, 5,
  6 or 7 placed worse on the card) split a tile's K into runs of
  `kb_per_split` 128-byte blocks, none empty: the split that minimises
  waves x (K blocks a split + GEMM_OVERHEAD_KBLOCKS), a wave being
  min(per_sm, GEMM_STREAMS_PER_SM) blocks an SM, the fewest splits on a
  tie."""
  swap = m <= SWAP_MAX_M
  nb = next(w for w in SWAP_N if w >= m) if swap else 128
  tile_m, tile_n = (nb, 64) if swap else (128, 128)
  cfg = _GemmConfig(swap, nb)
  m_tiles, n_tiles = -(-m // tile_m), -(-n // tile_n)
  kblocks = -(-k // K_BLOCK)
  tiles = m_tiles * n_tiles
  slots = min(cfg["per_sm"], GEMM_STREAMS_PER_SM) * sms
  best = None
  for cluster in (1, 2, 4, 8):
    per = -(-kblocks // cluster)
    if -(-kblocks // per) != cluster:
      continue   # a split would be empty
    cost = -(-tiles * cluster // slots) * (per + GEMM_OVERHEAD_KBLOCKS)
    if best is None or cost < best[0]:
      best = (cost, cluster, per)
  return dict(swap=swap, nb=nb, tile_m=tile_m, tile_n=tile_n,
              m_tiles=m_tiles, n_tiles=n_tiles, kblocks=kblocks,
              cluster=best[1], kb_per_split=best[2],
              blocks=tiles * best[1], **cfg)


def KernelLimitError(m: int, k: int, n: int) -> str | None:
  """Why the kernels cannot take an [m, k] x [n, k]^T product, or None."""
  if m < 1 or k < 1 or n < 1:
    return f"Int8Matmul kernels take m, k, n >= 1, got {m}, {k}, {n}"
  if -(-m // 64) * -(-n // 64) * MAX_CLUSTER > 2**31 - 1:
    return f"[{m}, {n}] exceeds the GEMM kernel's grid"
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
    lib.Int8Quantize.argtypes = [vp] * 3 + [ci] * 7 + [vp]
    lib.Int8Quantize.restype = ci
    lib.Int8Gemm.argtypes = [vp] * 5 + [ci] * 10 + [vp]
    lib.Int8Gemm.restype = ci
    lib.Int8Matmul.argtypes = [vp] * 5 + [ci] * 12 + [vp]
    lib.Int8Matmul.restype = ci
    lib.Int8QuantizeMaxBlocks.argtypes = [vp]
    lib.Int8QuantizeMaxBlocks.restype = ci
    lib.Int8GemmOccupancy.argtypes = [ci, ci, vp]
    lib.Int8GemmOccupancy.restype = ci
    lib.Int8MatmulErrorString.argtypes = [ci]
    lib.Int8MatmulErrorString.restype = ctypes.c_char_p
    _lib = lib
  return _lib


def _Raise(what, rc):
  raise RuntimeError(f"{what} failed: "
                     + _Lib().Int8MatmulErrorString(rc).decode())


def GemmOccupancy(swap: bool, nb: int) -> int:
  """Blocks of kernel (b)'s configuration (swap, nb) an SM of the current
  device holds, as the built kernel reports it (`GemmPlan` assumes
  `_GemmConfig`'s count)."""
  per_sm = ctypes.c_int(0)
  rc = _Lib().Int8GemmOccupancy(int(swap), nb, ctypes.addressof(per_sm))
  if rc != 0:
    _Raise("Int8GemmOccupancy", rc)
  return per_sm.value


@functools.lru_cache(maxsize=None)
def _Plan(m: int, k: int, n: int, index: int) -> dict:
  """`GemmPlan` on device `index`, once per shape: the serving step
  repeats a few shapes, and its host time is what a step waits on.
  Raises for a shape the kernels refuse."""
  reason = KernelLimitError(m, k, n)
  if reason is not None:
    raise ValueError(reason)
  return GemmPlan(
      m, k, n, torch.cuda.get_device_properties(index).multi_processor_count)


def _GemmArgs(plan: dict) -> tuple:
  return (int(plan["swap"]), plan["nb"], plan["cluster"],
          plan["kb_per_split"])


@functools.lru_cache(maxsize=None)
def QuantizeMaxBlocks(index: int) -> int:
  """The most blocks kernel (a)'s cluster takes on device `index` (the
  current one when first asked): 16 where the card places such a
  cluster (a non-portable size), else MAX_CLUSTER."""
  blocks = ctypes.c_int(0)
  rc = _Lib().Int8QuantizeMaxBlocks(ctypes.addressof(blocks))
  if rc != 0:
    _Raise("Int8QuantizeMaxBlocks", rc)
  return blocks.value


@functools.lru_cache(maxsize=None)
def _QuantizeArgs(m: int, k: int, itemsize: int, index: int) -> tuple:
  q = QuantizePlan(m, k, itemsize, QuantizeMaxBlocks(index))
  return q["blocks"], q["rows"], q["held"]


@functools.lru_cache(maxsize=None)
def _MatmulArgs(m: int, k: int, n: int, itemsize: int, index: int) -> tuple:
  """(kp, (a)'s three and (b)'s four plan arguments) of an [m, k] x [n,
  k]^T product on device `index`, once per shape."""
  return (PaddedK(k), *_QuantizeArgs(m, k, itemsize, index),
          *_GemmArgs(_Plan(m, k, n, index)))


def _CudaMatmul(x, w, w_scale):
  """Kernels (a) and (b) in one call over one scratch allocation: the
  serving step's path, whose host time per projection a step waits on."""
  m, k = x.shape
  n = w.shape[0]
  args = _MatmulArgs(m, k, n, x.element_size(), x.device.index)
  kp = args[0]
  y = torch.empty((m, n), dtype=x.dtype, device=x.device)
  # x8 [m, kp] (a multiple of 16 bytes), then the scale
  scratch = torch.empty((m * kp + 16,), dtype=torch.int8, device=x.device)
  rc = _Lib().Int8Matmul(
      x.data_ptr(), w.data_ptr(), w_scale.data_ptr(), y.data_ptr(),
      scratch.data_ptr(), m, k, kp, n, *args[1:], _Bf16(x.dtype),
      torch.cuda.current_stream(x.device).cuda_stream)
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
  buf = torch.empty((m * kp + 16,), dtype=torch.int8, device=x.device)
  x8 = buf[:m * kp].view(m, kp)
  x_scale = buf[m * kp:m * kp + 4].view(torch.float32)
  rc = _Lib().Int8Quantize(
      x.data_ptr(), x8.data_ptr(), x_scale.data_ptr(), m, k, kp,
      *_QuantizeArgs(m, k, x.element_size(), x.device.index),
      _Bf16(x.dtype),
      torch.cuda.current_stream(x.device).cuda_stream)
  if rc != 0:
    _Raise("Int8Quantize kernel launch", rc)
  _Count(QuantizeActivations, x.dtype)
  return x8, x_scale


def _CudaGemm(x8, x_scale, w, w_scale, out_dtype):
  m, kp = x8.shape
  n, k = w.shape
  CheckAligned("Int8Gemm", [x8, w, w_scale])
  if x_scale.data_ptr() % 4:
    raise ValueError("Int8Gemm takes a 4-byte aligned x_scale")
  plan = _Plan(m, k, n, x8.device.index)
  y = torch.empty((m, n), dtype=out_dtype, device=x8.device)
  # no programmatic dependence here: the stream's previous kernel may have
  # written w (Int8Matmul's (b) depends on its own (a))
  rc = _Lib().Int8Gemm(
      x8.data_ptr(), w.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
      y.data_ptr(), m, k, kp, n, *_GemmArgs(plan), _Bf16(out_dtype), 0,
      torch.cuda.current_stream(x8.device).cuda_stream)
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
