"""Chunked gated linear-recurrence scan, SSD form (port of lingvo_tpu/ops/ssd_scan.py).

Per (batch, head) row, a matrix-valued linear recurrence over time with a
scalar input-dependent decay:

    S_t = a_t * S_{t-1} + v_t outer b_t        # S: [H, S] state matrix
    y_t = S_t @ c_t                            # readout after the update

with `a_t = exp(decay_log_t)`, `decay_log_t <= 0`. Unrolled, y_t =
sum_{t' <= t} exp(cum_t - cum_t') (c_t . b_t') v_t': causal linear
attention with a multiplicative decay mask, which the chunked form
exploits.

Lowerings of the same recurrence:

- `sequential`: a Python loop over single tokens through `SequentialStep`
  (the decode step; `_SequentialScan` is the tests' reference).
- `chunked`: `_ChunkedPlain`, the reference's XLA chunked path in the
  same op order: T cut into chunks of Q steps, the quadratic intra-chunk
  form of `_ChunkBody` plus the [H, S] state carried across chunks.
- `pallas` / `auto`: the CUDA kernel `ops/csrc/ssd_scan.cu` for CUDA
  tensors (one thread-block cluster per row: its blocks take runs of
  chunks in parallel and pass the [H, S] carry from run to run through
  distributed shared memory; chunks with no live step are skipped; it
  computes what `_ChunkBody` under the chunk loop computes, with float32
  sums in other orders), `_ChunkedPlain` for CPU tensors. A CUDA tensor
  launches the kernel or raises. `ChunkRuns` is the host's split of a
  row's chunks over its cluster (CPU-tested); `KernelGeometry` reads the
  built kernel's whole launch.
- `associative` is a test-only reference in the JAX package; it raises
  here.

The port's `auto` does not apply the reference's TPU tiling gate
`SupportedOnTpu` (S and H multiples of 128, Q of 8). That gate is a Mosaic
layout constraint, not part of the semantics: `DenseLmSsmHybrid` has
S = H = 64, so on a TPU it takes the XLA chunked path, and on the card the
kernel computes the same function.

Numerical contract: all scan math is float32; outputs are float32.

Masking contract (the caller, `core/ssm.py`, prepares the inputs):
- a padded step has decay_log = 0 and v = 0, and leaves the state exactly
  unchanged;
- a segment reset is decay_log = RESET_LOG (-60): exp(-60) ~ 9e-27, so any
  leaked history underflows against O(1) activations, while cumsums inside
  a chunk stay O(100), so within-segment decay differences are not absorbed
  as they would be by a -1e30 sentinel.

The backward. The reference binds its Pallas forward to a
`jax.custom_vjp` whose backward `_PallasScanBwd` is the VJP of the XLA
chunked path, recomputed from the saved inputs. Here:
- a CPU call is differentiable by autograd through the plain versions;
  `_PlainScanBwd` is that VJP taken from saved inputs, the reference's
  `_PallasScanBwd` op for op, and the backward kernel's yardstick on the
  card;
- a CUDA call under grad mode whose inputs require grad goes through
  `_ScanFn`, a `torch.autograd.Function`: its forward is the forward
  kernel, it saves (decay_log, b_in, c_in, v, s0), and its backward
  launches the hand backward kernel `ops/csrc/ssd_scan_bwd.cu` (a state
  sweep each way, then every (row, chunk) at once), counted in
  `SsdScan.bwd_launches`. It takes the cotangents of y and s_final (a
  missing one counts as zeros) and returns the gradients of decay_log,
  b_in, c_in, v and, when given, s0. It launches or raises: it never
  takes the plain path. Without grad a CUDA call launches the forward
  kernel alone.
"""

from __future__ import annotations

import ctypes

import torch

from lingvo_tpu_torch.ops import cuda_build

# Segment-boundary decay: see the masking contract in the module docstring.
RESET_LOG = -60.0
# Mask value for "never attend" inside a chunk (exp(_MASK_LOG) == 0.0 in f32).
_MASK_LOG = -1.0e30
MAX_DIM = 128   # kernel limit on the chunk Q, the state width S and head dim H
MAX_CLUSTER = 8   # blocks per row: the portable cluster size

_LOWERINGS = ("auto", "chunked", "pallas", "associative", "sequential")


# -- plain PyTorch versions (the CPU path and the kernel's yardstick) --------


def SequentialStep(s, decay_log, b_t, c_t, v_t):
  """One recurrence step (the decode step).

  s: [..., H, S] state, decay_log: [...], b_t/c_t: [..., S], v_t: [..., H].
  Returns (s_new [..., H, S], y [..., H]), both float32."""
  s = s.float()
  a = torch.exp(decay_log.float())[..., None, None]
  u = v_t.float()[..., :, None] * b_t.float()[..., None, :]
  s_new = a * s + u
  y = torch.einsum("...s,...hs->...h", c_t.float(), s_new)
  return s_new, y


def _SequentialScan(decay_log, b_in, c_in, v, s0):
  """A loop over single tokens. Flat inputs: decay_log [R, T], b_in/c_in
  [R, T, S], v [R, T, H], s0 [R, H, S]. Returns (y [R, T, H], s_fin)."""
  s, ys = s0, []
  for t in range(decay_log.shape[1]):
    s, y = SequentialStep(s, decay_log[:, t], b_in[:, t], c_in[:, t], v[:, t])
    ys.append(y)
  return torch.stack(ys, dim=1), s


def _ChunkBody(s_in, dl2, b_c, c_c, v_c):
  """One chunk of the recurrence for every row at once (the reference
  vmaps its `_ChunkBody` over rows; the op order per row is its own).

  s_in: [R, H, S] incoming state, dl2: [R, Q, 1] log-decay, b_c/c_c
  [R, Q, S], v_c [R, Q, H]. Returns (y [R, Q, H], s_out [R, H, S])."""
  cum = torch.cumsum(dl2, dim=1)                              # [R, Q, 1]
  # inter-chunk: position t sees s_in through decay exp(cum_t)
  y_inter = torch.matmul(c_c * torch.exp(cum), s_in.transpose(1, 2))
  # intra-chunk quadratic form: exp(cum_t - cum_t') (c_t . b_t'), t' <= t
  scores = torch.matmul(c_c, b_c.transpose(1, 2))             # [R, Q, P]
  dmat = cum - cum.transpose(1, 2)                            # [R, Q, P]
  q = dl2.shape[1]
  causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=dl2.device))
  decay = torch.exp(torch.where(causal, dmat, _MASK_LOG))
  y_intra = torch.matmul(scores * decay, v_c)                 # [R, Q, H]
  # state out: decay the incoming state across the whole chunk, add each
  # token's outer product decayed from its position to the chunk's end
  tot = cum[:, -1:]                                           # [R, 1, 1]
  w_tail = torch.exp(tot - cum)                               # [R, Q, 1]
  s_out = (torch.exp(tot) * s_in
           + torch.matmul((v_c * w_tail).transpose(1, 2), b_c))
  return y_inter + y_intra, s_out


def _PadChunks(decay_log, b_in, c_in, v, chunk_size):
  """Right-pads T to a chunk multiple with identity steps (dl = 0, u = 0)."""
  t = decay_log.shape[1]
  t_pad = -(-t // chunk_size) * chunk_size
  if t_pad == t:
    return decay_log, b_in, c_in, v, t_pad
  pad = t_pad - t
  pad3 = (0, 0, 0, pad)
  return (torch.nn.functional.pad(decay_log, (0, pad)),
          torch.nn.functional.pad(b_in, pad3),
          torch.nn.functional.pad(c_in, pad3),
          torch.nn.functional.pad(v, pad3), t_pad)


def _ChunkedPlain(decay_log, b_in, c_in, v, s0, chunk_size):
  """The reference's `_ChunkedXla`: a loop over chunks of `_ChunkBody`.
  Same flat [R, T, ...] contract as `_SequentialScan`."""
  r, t = decay_log.shape
  s_dim, h = b_in.shape[-1], v.shape[-1]
  decay_log, b_in, c_in, v, t_pad = _PadChunks(decay_log, b_in, c_in, v,
                                               chunk_size)
  nc = t_pad // chunk_size
  dl = decay_log.reshape(r, nc, chunk_size, 1)
  bb = b_in.reshape(r, nc, chunk_size, s_dim)
  cc = c_in.reshape(r, nc, chunk_size, s_dim)
  vv = v.reshape(r, nc, chunk_size, h)
  s, ys = s0, []
  for j in range(nc):
    y, s = _ChunkBody(s, dl[:, j], bb[:, j], cc[:, j], vv[:, j])
    ys.append(y)
  y = torch.stack(ys, dim=1).reshape(r, t_pad, h)[:, :t]
  return y, s


# -- the CUDA kernel ---------------------------------------------------------


def ChunkRuns(t: int, chunk_size: int) -> dict:
  """How the kernel splits a row of T = t steps (the host's `MakePlan` in
  `csrc/ssd_scan.cu`): `chunks` of Q = min(chunk_size, t) steps over a
  cluster of `cluster` = C = min(8, ceil(chunks / 2)) blocks, block k
  owning the chunks `runs[k]` = [k chunks / C, (k + 1) chunks / C), at
  most `per_block` of them."""
  q = t if 0 < t < chunk_size else chunk_size
  nc = -(-t // q) if t > 0 else 0
  cluster = max(1, min(MAX_CLUSTER, -(-nc // 2)))   # >= 2 chunks a block
  return dict(cluster=cluster, chunks=nc, per_block=-(-nc // cluster),
              runs=[(k * nc // cluster, (k + 1) * nc // cluster)
                    for k in range(cluster)])


_lib = None   # the loaded kernel library, with its C signature declared


def _Lib():
  global _lib
  if _lib is None:
    lib = cuda_build.Load("ssd_scan")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.SsdScanF32.argtypes = [vp] * 7 + [ci] * 6 + [vp]
    lib.SsdScanF32.restype = ci
    lib.SsdScanErrorString.argtypes = [ci]
    lib.SsdScanErrorString.restype = ctypes.c_char_p
    lib.SsdScanGeometry.argtypes = [ci] * 4 + [ctypes.POINTER(ci)]
    lib.SsdScanGeometry.restype = ci
    _lib = lib
  return _lib


def KernelGeometry(t: int, s_dim: int, h: int, chunk_size: int) -> dict:
  """The built kernel's launch at T = t, as the library computes it:
  `ChunkRuns`'s cluster, chunks and per_block; threads; dynamic shared
  bytes (`smem`); ring `stages`; `h_groups` (clusters per row, each over
  at most 64 columns of H); the instantiation's registers and local
  (spill) bytes per thread; resident blocks per SM and resident clusters
  on the current card."""
  lib = _Lib()
  geo = (ctypes.c_int * 11)()
  rc = lib.SsdScanGeometry(t, s_dim, h, chunk_size, geo)
  if rc != 0:
    raise RuntimeError("SsdScanGeometry failed: "
                       + lib.SsdScanErrorString(rc).decode())
  keys = ("cluster", "chunks", "per_block", "threads", "smem", "stages",
          "h_groups", "regs", "local", "per_sm", "clusters")
  return dict(zip(keys, geo))


def _CudaScan(decay_log, b_in, c_in, v, s0, chunk_size):
  """The kernel on [B, T, N, ...] tensors as they are (no transposes)."""
  b, t, n = decay_log.shape
  s_dim, h = b_in.shape[-1], v.shape[-1]
  tensors = dict(decay_log=decay_log, b_in=b_in, c_in=c_in, v=v)
  if s0 is not None:
    tensors["s0"] = s0
  for name, x in tensors.items():
    if x.dtype != torch.float32:
      raise TypeError(f"SsdScan kernel takes float32 inputs, {name} is "
                      f"{x.dtype}")
    if x.device != decay_log.device:
      raise ValueError(f"SsdScan: {name} on {x.device}, decay_log on "
                       f"{decay_log.device}")
    if not x.is_contiguous():
      raise ValueError(f"SsdScan kernel takes contiguous tensors ({name})")
  for label, d in (("chunk_size", chunk_size), ("state dim", s_dim),
                   ("head dim", h)):
    if not 1 <= d <= MAX_DIM:
      raise ValueError(f"SsdScan kernel takes a {label} in [1, {MAX_DIM}], "
                       f"got {d}")
  y = torch.empty((b, t, n, h), dtype=torch.float32, device=decay_log.device)
  s_fin = torch.empty((b, n, h, s_dim), dtype=torch.float32,
                      device=decay_log.device)
  if b * n == 0:
    return y, s_fin
  lib = _Lib()
  stream = torch.cuda.current_stream(decay_log.device).cuda_stream
  rc = lib.SsdScanF32(
      decay_log.data_ptr(), b_in.data_ptr(), c_in.data_ptr(), v.data_ptr(),
      s0.data_ptr() if s0 is not None else None, y.data_ptr(),
      s_fin.data_ptr(), b, t, n, s_dim, h, chunk_size, stream)
  if rc != 0:
    raise RuntimeError("SsdScan kernel launch failed: "
                       + lib.SsdScanErrorString(rc).decode())
  SsdScan.launches += 1
  return y, s_fin


# -- the gradient ------------------------------------------------------------


def _PlainScanBwd(decay_log, b_in, c_in, v, s0, dy, ds_fin, chunk_size):
  """The reference's `_PallasScanBwd` op for op: the VJP of the plain
  chunked path, recomputed from the saved inputs by autograd. Tensors as
  `SsdScan` takes them; dy [B, T, N, H] and ds_fin [B, N, H, S] the
  cotangents of y and s_final (ds_fin None: zeros). Returns (d decay_log,
  d b_in, d c_in, d v, d s0 or None when s0 is None)."""
  with torch.enable_grad():
    leaves = [x.detach().requires_grad_(True)
              for x in (decay_log, b_in, c_in, v)
              + ((s0,) if s0 is not None else ())]
    y, s_fin = SsdScan(*leaves[:4], s0=leaves[4] if s0 is not None else None,
                       chunk_size=chunk_size, lowering="chunked")
    outs, cots = [y], [dy]
    if ds_fin is not None:
      outs.append(s_fin)
      cots.append(ds_fin)
    grads = torch.autograd.grad(outs, leaves, cots)
  return tuple(grads) + ((None,) if s0 is None else ())


_bwd_lib = None   # the backward kernel's library


def _BwdLib():
  global _bwd_lib
  if _bwd_lib is None:
    lib = cuda_build.Load("ssd_scan_bwd")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.SsdScanBwdF32.argtypes = [vp] * 14 + [ci] * 6 + [vp]
    lib.SsdScanBwdF32.restype = ci
    lib.SsdScanBwdErrorString.argtypes = [ci]
    lib.SsdScanBwdErrorString.restype = ctypes.c_char_p
    lib.SsdScanBwdGeometry.argtypes = [ci] * 4 + [ctypes.POINTER(ci)]
    lib.SsdScanBwdGeometry.restype = ci
    _bwd_lib = lib
  return _bwd_lib


def BwdChunks(t: int, chunk_size: int) -> tuple[int, int]:
  """(Q, chunks) of the backward kernel at T = t: the forward's chunk
  length (T itself when 0 < T < chunk_size) and the chunk count."""
  q = t if 0 < t < chunk_size else chunk_size
  return q, (-(-t // q) if t > 0 else 0)


def BwdGeometry(t: int, s_dim: int, h: int, chunk_size: int) -> dict:
  """The built backward kernel's launch at T = t: chunk length `q`,
  `chunks`, the sweep's and the chunk kernel's dynamic shared bytes,
  whether the chunk kernel stages every tile (`full`), each kernel's
  registers and local (spill) bytes per thread, and the chunk kernel's
  resident blocks per SM."""
  lib = _BwdLib()
  geo = (ctypes.c_int * 10)()
  rc = lib.SsdScanBwdGeometry(t, s_dim, h, chunk_size, geo)
  if rc != 0:
    raise RuntimeError("SsdScanBwdGeometry failed: "
                       + lib.SsdScanBwdErrorString(rc).decode())
  keys = ("q", "chunks", "sweep_smem", "chunk_smem", "full", "sweep_regs",
          "sweep_local", "chunk_regs", "chunk_local", "per_sm")
  return dict(zip(keys, geo))


def _CudaScanBwd(decay_log, b_in, c_in, v, s0, dy, ds_fin, chunk_size):
  """The backward kernel on [B, T, N, ...] tensors as they are: the
  gradients `_PlainScanBwd` returns. Two state scratches of [B N, chunks,
  H, S] float32 live for the call."""
  b, t, n = decay_log.shape
  s_dim, h = b_in.shape[-1], v.shape[-1]
  tensors = dict(decay_log=decay_log, b_in=b_in, c_in=c_in, v=v, dy=dy)
  for name, x in (("s0", s0), ("ds_fin", ds_fin)):
    if x is not None:
      tensors[name] = x
  for name, x in tensors.items():
    if x.dtype != torch.float32:
      raise TypeError(f"SsdScan backward kernel takes float32 tensors, "
                      f"{name} is {x.dtype}")
    if x.device != decay_log.device:
      raise ValueError(f"SsdScan backward: {name} on {x.device}, decay_log "
                       f"on {decay_log.device}")
    if not x.is_contiguous():
      raise ValueError(f"SsdScan backward kernel takes contiguous tensors "
                       f"({name})")
  for label, d in (("chunk_size", chunk_size), ("state dim", s_dim),
                   ("head dim", h)):
    if not 1 <= d <= MAX_DIM:
      raise ValueError(f"SsdScan backward kernel takes a {label} in [1, "
                       f"{MAX_DIM}], got {d}")
  dev = decay_log.device
  grads = [torch.empty_like(x) for x in (decay_log, b_in, c_in, v)]
  ds0 = torch.empty_like(s0) if s0 is not None else None
  if b * n == 0:
    return (*grads, ds0)
  _, nc = BwdChunks(t, chunk_size)
  scratch = torch.empty((2, b * n, nc, h, s_dim), dtype=torch.float32,
                        device=dev)
  lib = _BwdLib()
  ptr = lambda x: x.data_ptr() if x is not None else None
  rc = lib.SsdScanBwdF32(
      decay_log.data_ptr(), b_in.data_ptr(), c_in.data_ptr(), v.data_ptr(),
      ptr(s0), dy.data_ptr(), ptr(ds_fin), *(g.data_ptr() for g in grads),
      ptr(ds0), scratch[0].data_ptr(), scratch[1].data_ptr(), b, t, n, s_dim,
      h, chunk_size, torch.cuda.current_stream(dev).cuda_stream)
  if rc != 0:
    raise RuntimeError("SsdScan backward kernel launch failed: "
                       + lib.SsdScanBwdErrorString(rc).decode())
  SsdScan.bwd_launches += 1
  return (*grads, ds0)


class _ScanFn(torch.autograd.Function):
  """The kernel scan with its hand backward (the reference's
  `_PallasScan` custom_vjp pair): forward `_CudaScan`, saving (decay_log,
  b_in, c_in, v, s0) as `_PallasScanFwd` does; backward `_CudaScanBwd`."""

  @staticmethod
  def forward(ctx, decay_log, b_in, c_in, v, s0, chunk_size):
    y, s_fin = _CudaScan(decay_log, b_in, c_in, v, s0, chunk_size)
    ctx.save_for_backward(decay_log, b_in, c_in, v, s0)
    ctx.chunk_size = chunk_size
    ctx.set_materialize_grads(False)
    return y, s_fin

  @staticmethod
  def backward(ctx, dy, ds_fin):
    decay_log, b_in, c_in, v, s0 = ctx.saved_tensors
    if dy is None:   # only s_final was used: y's cotangent is zeros
      b, t, n = decay_log.shape
      dy = torch.zeros((b, t, n, v.shape[-1]), dtype=torch.float32,
                       device=decay_log.device)
    grads = _CudaScanBwd(
        decay_log, b_in, c_in, v, s0, dy.contiguous(),
        None if ds_fin is None else ds_fin.contiguous(), ctx.chunk_size)
    return (*grads, None)


# -- public entry ------------------------------------------------------------


def SsdScan(decay_log, b_in, c_in, v, s0=None, *, chunk_size: int = 64,
            lowering: str = "auto"):
  """Gated linear-recurrence scan over a batch of sequences.

  decay_log: [B, T, N] log-decay per (step, head), <= 0; the caller encodes
    padding (0 with zeroed v) and segment resets (RESET_LOG) here.
  b_in: [B, T, N, S] write keys. c_in: [B, T, N, S] read keys.
  v: [B, T, N, H] values. s0: optional [B, N, H, S] initial state (zeros
    when None).
  lowering: 'auto' or 'pallas' (the kernel for CUDA tensors, the plain
    chunked version for CPU tensors), 'chunked' or 'sequential' (the plain
    versions on any device); 'associative' raises.
  Returns (y [B, T, N, H] float32, s_final [B, N, H, S] float32). Each
  forward kernel launch counts one in `SsdScan.launches`, each backward
  kernel call (through `_ScanFn`) one in `SsdScan.bwd_launches`."""
  if lowering not in _LOWERINGS:
    raise ValueError(f"lowering must be one of {_LOWERINGS}, got "
                     f"{lowering!r}")
  if lowering == "associative":
    raise NotImplementedError(
        "the associative-scan lowering is a test-only reference of the JAX "
        "package and is not ported; use 'chunked' or 'sequential'")
  dev = decay_log.device
  if lowering in ("auto", "pallas") and dev.type != "cpu":
    if dev.type != "cuda":
      raise ValueError(f"SsdScan runs on cpu or cuda, not {dev}")
    args = (decay_log, b_in, c_in, v) + ((s0,) if s0 is not None else ())
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
      return _ScanFn.apply(decay_log, b_in, c_in, v, s0, chunk_size)
    return _CudaScan(decay_log, b_in, c_in, v, s0, chunk_size)
  b, t, n = decay_log.shape
  s_dim, h = b_in.shape[-1], v.shape[-1]
  # flatten (B, N) into one row axis: every lowering is per (batch, head)
  dl = decay_log.float().permute(0, 2, 1).reshape(b * n, t)
  bb = b_in.float().permute(0, 2, 1, 3).reshape(b * n, t, s_dim)
  cc = c_in.float().permute(0, 2, 1, 3).reshape(b * n, t, s_dim)
  vv = v.float().permute(0, 2, 1, 3).reshape(b * n, t, h)
  if s0 is None:
    s0f = torch.zeros((b * n, h, s_dim), dtype=torch.float32, device=dev)
  else:
    s0f = s0.float().reshape(b * n, h, s_dim)
  if lowering == "sequential":
    y, s_fin = _SequentialScan(dl, bb, cc, vv, s0f)
  else:
    y, s_fin = _ChunkedPlain(dl, bb, cc, vv, s0f, chunk_size)
  y = y.reshape(b, n, t, h).permute(0, 2, 1, 3)
  return y, s_fin.reshape(b, n, h, s_dim)


SsdScan.launches = 0   # forward kernel launches (the plain versions count none)
SsdScan.bwd_launches = 0   # backward kernel calls (`_CudaScanBwd`)
