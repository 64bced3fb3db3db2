"""Seeded sampling of one token per row: scaled, top-k-masked logits plus threefry Gumbel noise, argmax.

The draw of the reference's `SampleFromLogits` at temperature > 0
(lingvo_tpu/core/sampling.py:34): a top-k threshold (`lax.top_k` of the
scaled row), then `jax.random.categorical` over the masked logits, which
XLA runs as threefry2x32 bits, a uniform, -log(-log(u)), an add and an
argmax. It replaces no `pallas_call`: the reference has no Pallas kernel
here. No PyTorch call draws JAX's threefry noise, so the card runs a
hand kernel, `ops/csrc/sample_tokens.cu`, one launch a call, the top-k
threshold selected inside it.

`SampleTokens(logits, key, fold, inv_t, top_k=0, rows=None)`:

- logits [R, V] float32; key a CPU int64 tensor [2] (uint32 words,
  `core/threefry`);
- rows: None (every row is drawn, R' = R), or int32 [R'] on the logits'
  device, the rows of logits to draw (each in [0, R)), read in place:
  drawn row i is logits[rows[i]]. The serving steps draw only the rows
  they commit. The CPU path raises on an index out of [0, R); the card
  does not read rows back, and draws token -1 (winning value NaN) there;
- fold [R', F] int32, F = 1 or 2: drawn row i's key is the base key
  folded with fold[i, 0], then fold[i, 1] (the engine passes (request
  seed, output position), `GShardDecode` the row index against its step
  key), and its noise counters are (0, c) for columns c in 0..V-1;
- inv_t: the float32 reciprocal of the temperature, a Python float that
  is exactly a float32 (`core/jit_arith.Reciprocal`): the reference
  divides by the temperature inside its jitted step programs, where XLA
  makes the division a product with the reciprocal;
- top_k: 0 < top_k < V keeps the top_k largest scaled values of each row
  (ties at the k-th value stay live) and masks the rest to -inf; 0, or
  top_k >= V, keeps every value.

Returns tokens [R'] int32, and with `return_z` the winning perturbed value
[R'] float32 too.

The plain version, `_PlainSample`, is the reference's arithmetic in
PyTorch, op for op (the scale, `torch.topk` of the scaled row, the mask,
`core/threefry`'s noise, the argmax): the CPU path, and the kernel's
yardstick on the card. The bits and uniforms of the two are equal; the
logarithms are each framework's (libdevice `logf` on the card, PyTorch's
on the CPU), which may differ by an ulp, so the two agree on every token
except where two perturbed values of a row are that close. A wrapper
takes the plain version only for CPU tensors; a CUDA tensor launches the
kernel or raises. Each launch counts one in `SampleTokens.launches`;
every call, on either path, adds its R' to `SampleTokens.rows_drawn` and
raises `SampleTokens.widest` to it.

The kernel's launch (`Plan`): each drawn row is split over a cluster of S
blocks, the largest S whose R' S blocks the card holds at once, else the
smallest with `MIN_BLOCKS_PER_SM` blocks resident on an SM; the masked
kernel holds each block's slice of the row in shared memory (at most
`HOLD_BYTES`).

What bounds the kernel. Masked (top_k 40 of V = 32000): the bytes of the
drawn rows' logits, read once; only the ~top_k live columns pay for
threefry and the logarithms. Full vocabulary: the integer work, about
`INT_OPS_PER_ELEMENT` int32 operations of threefry per element against 4
bytes of logits; of those, `ALU_OPS_PER_ELEMENT` (the rotates, xors, the
shift and the or) run only on the SM's integer ALU pipe, at 64 lanes a
clock; every instruction of an element, the float work of the two
logarithms included, is issued at 128 lanes a clock.
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
# the kernel's geometry (csrc/sample_tokens.cu, checked against its
# SampleTokensLimits when the library loads)
THREADS = 256
MAX_CLUSTER = 16          # the non-portable cluster size
HOLD_BYTES = 176 * 1024   # the largest slice the masked kernel holds
# past one wave, the plan keeps at least this many blocks (of 8 warps)
# resident on an SM
MIN_BLOCKS_PER_SM = 3


def Masked(top_k: int, v: int) -> bool:
  """Whether top_k masks a row of v values."""
  return 0 < top_k < v


def _KthLargest(z, top_k: int):
  """[R, V] -> the top_k-th largest value of each row [R, 1], ties
  counted (`torch.topk`, as the reference's `lax.top_k`)."""
  return torch.topk(z, top_k, dim=-1).values[..., -1:]


def MaskTopK(z, top_k: int):
  """z [R, V] with values below each row's top_k-th largest set to -inf
  (ties at it stay live); z itself when top_k masks nothing."""
  if not Masked(top_k, z.shape[-1]):
    return z
  return torch.where(z < _KthLargest(z, top_k), float("-inf"), z)


def _Fold(key, fold):
  """Row keys [R, 2]: the base key folded with each column of fold."""
  keys = key.to(fold.device).expand(fold.shape[0], 2)
  for j in range(fold.shape[1]):
    keys = threefry.FoldIn(keys, fold[:, j].to(torch.int64))
  return keys


def _PlainSample(logits, key, fold, inv_t, top_k=0, rows=None):
  """(tokens [R'] int32, winning z [R'] float32), the reference's
  arithmetic op for op."""
  if rows is not None:
    logits = logits[rows.long()]
  z = MaskTopK(logits * inv_t, top_k)
  z = threefry.Gumbel(_Fold(key, fold), (logits.shape[1],)) + z
  tokens = torch.argmax(z, dim=-1)
  return tokens.to(torch.int32), z.gather(1, tokens[:, None])[:, 0]


def Chunk(v: int, cluster: int) -> int:
  """Columns a block owns when a row of v is split over `cluster` blocks:
  ceil(v / cluster), rounded up to a multiple of 4 (16-byte slices)."""
  per = -(-v // cluster)
  return -(-per // 4) * 4


def Plan(n: int, v: int, top_k: int, sms: int, fit) -> tuple[int, int]:
  """(cluster S, chunk) of a draw of n rows of v: the largest S whose n S
  blocks the card holds at once (one wave); else the smallest S with at
  least MIN_BLOCKS_PER_SM blocks resident on an SM; else the largest S
  that fits. fit(masked, chunk, S) -> (resident blocks an SM, whether the
  card can place an S-block cluster) (`_Fit` on the card). S stays at most
  MAX_CLUSTER and at most v / THREADS (a thread a column at least), and the
  masked kernel's slice at most HOLD_BYTES. The rule follows
  `tools/torch_sample_probe.py --sweep`: in one wave a larger cluster
  shortens every block; past one wave, a masked block's time is mostly its
  exchanges' latency, which more resident blocks hide."""
  masked = Masked(top_k, v)
  cap = max(1, min(MAX_CLUSTER, v // THREADS))
  feasible = []
  for s in range(1, cap + 1):
    chunk = Chunk(v, s)
    if masked and chunk * 4 > HOLD_BYTES:
      continue
    per_sm, fits = fit(masked, chunk, s)
    if fits and per_sm >= 1:
      feasible.append((s, chunk, per_sm))
  if not feasible:
    raise ValueError(
        f"SampleTokens: a row of {v} values does not fit the kernel (the "
        f"masked kernel holds at most {HOLD_BYTES // 4} values a block, "
        f"{MAX_CLUSTER} blocks a row)")
  one_wave = [(s, chunk) for s, chunk, per_sm in feasible
              if n * s <= sms * per_sm]
  if one_wave:
    return one_wave[-1]
  for s, chunk, per_sm in feasible:
    if per_sm >= MIN_BLOCKS_PER_SM:
      return s, chunk
  return feasible[-1][:2]


_lib = None   # the loaded kernel library, with its C signatures declared
_fits: dict = {}
_plans: dict = {}


def _Lib():
  global _lib
  if _lib is None:
    lib = cuda_build.Load("sample_tokens")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.SampleTokens.argtypes = [vp, vp, vp, ci, ctypes.c_uint,
                                 ctypes.c_uint, ctypes.c_float, ci, ci, ci,
                                 ci, ci, ci, vp, vp, vp]
    lib.SampleTokens.restype = ci
    lib.SampleTokensFit.argtypes = [ci, ci, ci, ctypes.POINTER(ci),
                                    ctypes.POINTER(ci)]
    lib.SampleTokensFit.restype = ci
    lib.SampleTokensErrorString.argtypes = [ci]
    lib.SampleTokensErrorString.restype = ctypes.c_char_p
    lib.SampleTokensLimits.argtypes = [ctypes.POINTER(ci)] * 3
    lib.SampleTokensLimits.restype = None
    limits = [ctypes.c_int(0) for _ in range(3)]
    lib.SampleTokensLimits(*(ctypes.byref(x) for x in limits))
    built = tuple(x.value for x in limits)
    if built != (THREADS, MAX_CLUSTER, HOLD_BYTES):
      raise RuntimeError(
          f"sample_tokens.cu's (threads, max cluster, hold bytes) {built} "
          f"differ from the planner's {(THREADS, MAX_CLUSTER, HOLD_BYTES)}")
    _lib = lib
  return _lib


def _Fit(device):
  """fit(masked, chunk, S) for `Plan` on the card `device`, cached."""

  def Fit(masked, chunk, s):
    key = (device, masked, chunk, s)
    if key not in _fits:
      lib = _Lib()
      per_sm, fits = ctypes.c_int(0), ctypes.c_int(0)
      with torch.cuda.device(device):
        rc = lib.SampleTokensFit(int(masked), chunk, s, ctypes.byref(per_sm),
                                 ctypes.byref(fits))
      if rc != 0:
        raise RuntimeError("SampleTokensFit failed: "
                           + lib.SampleTokensErrorString(rc).decode())
      _fits[key] = (per_sm.value, bool(fits.value))
    return _fits[key]

  return Fit


def LaunchPlan(n: int, v: int, top_k: int, device) -> tuple[int, int]:
  """`Plan` on the card `device` (cached by shape): (cluster S, chunk)."""
  device = torch.device(device)
  key = (device, n, v, Masked(top_k, v))
  if key not in _plans:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    _plans[key] = Plan(n, v, top_k, sms, _Fit(device))
  return _plans[key]


def _CudaSample(logits, key, fold, inv_t, top_k, rows, cluster=None):
  """The kernel's draw; cluster: S (None: `LaunchPlan`'s)."""
  r, v = logits.shape
  n = fold.shape[0]
  if cluster is None:
    cluster, chunk = LaunchPlan(n, v, top_k, logits.device)
  else:
    chunk = Chunk(v, cluster)
  tokens = torch.empty((n,), dtype=torch.int32, device=logits.device)
  zmax = torch.empty((n,), dtype=torch.float32, device=logits.device)
  k0, k1 = (int(w) for w in key.tolist())
  lib = _Lib()
  rc = lib.SampleTokens(
      logits.data_ptr(), None if rows is None else rows.data_ptr(),
      fold.data_ptr(), fold.shape[1], k0, k1, inv_t, top_k, r, v, n,
      cluster, chunk, tokens.data_ptr(), zmax.data_ptr(),
      torch.cuda.current_stream(logits.device).cuda_stream)
  if rc != 0:
    raise RuntimeError("SampleTokens kernel launch failed: "
                       + lib.SampleTokensErrorString(rc).decode())
  SampleTokens.launches += 1
  return tokens, zmax


def SampleTokens(logits, key, fold, inv_t: float, top_k: int = 0,
                 rows=None, return_z: bool = False):
  """One seeded draw per drawn row (see the module docstring). CPU
  tensors run the plain version; CUDA tensors launch the kernel or
  raise."""
  if logits.ndim != 2 or logits.dtype != torch.float32:
    raise TypeError(f"SampleTokens takes float32 logits [R, V], got "
                    f"{logits.dtype} {tuple(logits.shape)}")
  r, v = logits.shape
  if r == 0 or v == 0:
    raise ValueError(f"SampleTokens takes R, V >= 1, got {r}, {v}")
  if isinstance(top_k, bool) or not isinstance(top_k, int) or top_k < 0:
    raise ValueError(f"top_k must be an int >= 0, got {top_k!r}")
  if rows is not None and (rows.dtype != torch.int32 or rows.ndim != 1
                           or rows.shape[0] == 0):
    raise ValueError(f"rows must be int32 [R' >= 1], got {rows.dtype} "
                     f"{tuple(rows.shape)}")
  n = r if rows is None else rows.shape[0]
  if (fold.dtype != torch.int32 or fold.ndim != 2 or fold.shape[0] != n
      or not 1 <= fold.shape[1] <= MAX_FOLDS):
    raise ValueError(f"fold must be int32 [R' = {n}, F in 1..{MAX_FOLDS}], "
                     f"got {fold.dtype} {tuple(fold.shape)}")
  key = torch.as_tensor(key)
  if key.device.type != "cpu" or tuple(key.shape) != (2,):
    raise ValueError(f"key must be a CPU tensor [2] of uint32 words, got "
                     f"{tuple(key.shape)} on {key.device}")
  dev = logits.device
  for name, x in (("fold", fold), ("rows", rows)):
    if x is not None and x.device != dev:
      raise ValueError(f"SampleTokens: {name} on {x.device}, logits on {dev}")
  if dev.type == "cpu":
    if rows is not None and not ((rows >= 0) & (rows < r)).all():
      raise ValueError(f"rows must lie in [0, {r}), got {rows.tolist()}")
    tokens, zmax = _PlainSample(logits, key, fold, inv_t, top_k, rows)
  elif dev.type == "cuda":
    tokens, zmax = _CudaSample(logits.contiguous(), key, fold.contiguous(),
                               inv_t, top_k,
                               None if rows is None else rows.contiguous())
  else:
    raise ValueError(f"SampleTokens runs on cpu or cuda, not {dev}")
  SampleTokens.rows_drawn += n
  SampleTokens.widest = max(SampleTokens.widest, n)
  return (tokens, zmax) if return_z else tokens


SampleTokens.launches = 0
SampleTokens.rows_drawn = 0   # R' summed over calls, either path
SampleTokens.widest = 0       # the largest R' of one call
