"""The gradient of lingvo_tpu_torch SsdScan against the JAX reference.

- The port's CPU gradients (autograd through the plain chunked scan,
  which `_PlainScanBwd` computes from saved inputs) against `jax.vjp` of
  the reference's `SsdScan`, run as the Pallas kernel in interpret mode
  (whose custom_vjp backward is `_PallasScanBwd`) and as the XLA chunked
  path, at B, T, N, H, S = 2, 13, 3, 8, 4 and chunk 4 and 8 (T ragged
  against both), with and without the masking contract, with no s0 and a
  cotangent of y only, and with a nonzero s0 and a cotangent of s_final
  as well. d b_in, d c_in, d v and d s0 within atol 2e-5 x max(1,
  max|want|); d decay_log checked on its own, within 5e-5 x max(1,
  max|want|): it is a difference of row and column sums over each chunk,
  reverse-summed, where float32 differences of the other gradients add.
- `_KernelBwdModel`, a plain mirror of the backward kernel's arithmetic
  (`ops/csrc/ssd_scan_bwd.cu`): the forward state sweep that stores each
  chunk's incoming state, the reverse sweep that carries dS from the
  cotangent of s_final, and each (row, chunk)'s explicit formulas, the
  ragged last chunk cut at its last step. It is held against the same JAX
  VJP, at the forward kernel model's shapes and packs (identity chunks,
  a decode-only pack, T < Q, Q = 24, odd S and H), at the same bars. This
  is where the kernel's math is tested on the CPU.
- The CUDA backward kernel against `_PlainScanBwd` on the card in the
  `cuda`-marked cases, which skip here: the forward kernel cases' shapes
  (ragged tails, T < Q, Q = 24, odd S and H, T = 1100, a decode-only pack,
  S = H = Q = 128, where the chunk kernel reads its tiles from device
  memory) and the hybrid's training shape with packed resets and a padded
  tail; two calls bitwise equal; `SsdScan` under grad on CUDA tensors
  launches the forward kernel and the backward kernel once each. The
  module imports JAX only inside `_Jax`, so on a machine with a card and
  no JAX the kernel cases run alone:

    python -m pytest tests/test_torch_ssd_scan_bwd.py -m cuda
"""

import numpy as np
import pytest
import torch

from lingvo_tpu_torch.ops import ssd_scan

ATOL = 2e-5
ATOL_DL = 5e-5
# the card: kernel against the plain version, both float32 on the card,
# each gradient's max |error| over max(1, max |plain|)
CARD_TOL = 1e-4
B, T, N, H, S = 2, 13, 3, 8, 4


def _Jax():
  """(jax, jax.numpy, the reference ssd_scan module)."""
  import jax
  import jax.numpy as jnp
  from lingvo_tpu.ops import ssd_scan as jax_scan
  return jax, jnp, jax_scan


def _Inputs(seed=0, b=B, t=T, n=N, h=H, s=S, masked=False, kind=None):
  """decay_log, b_in, c_in, v, s0 and the cotangents dy, ds_fin as numpy
  float32. masked: steps 5..7 of row 0 and the last 3 steps of every row
  are padding (dl = 0, v = 0) and step 9 of the last row starts a segment
  (dl = RESET_LOG). kind 'decode': every row live at step 0 only, the
  last row idle; 'hole': steps 64..127 identity steps."""
  rng = np.random.RandomState(seed)
  dl = -np.logaddexp(rng.randn(b, t, n), 0.0)
  b_in, c_in = (0.5 * rng.randn(b, t, n, s) for _ in range(2))
  v = 0.5 * rng.randn(b, t, n, h)
  s0 = 0.2 * rng.randn(b, n, h, s)
  dy = rng.randn(b, t, n, h)
  ds_fin = 0.5 * rng.randn(b, n, h, s)
  if masked:
    pad = np.zeros((b, t), bool)
    pad[0, 5:8] = True
    pad[:, -3:] = True
    if t > 9:
      dl[-1, 9] = ssd_scan.RESET_LOG
    dl = np.where(pad[..., None], 0.0, dl)
    v = np.where(pad[..., None, None], 0.0, v)
  if kind == "decode":
    dl[:, 1:] = 0.0
    v[:, 1:] = 0.0
    dl[-1] = 0.0
    v[-1] = 0.0
  elif kind == "hole":
    dl[:, 64:128] = 0.0
    v[:, 64:128] = 0.0
  return [x.astype(np.float32) for x in (dl, b_in, c_in, v, s0, dy, ds_fin)]


def _JaxVjp(arrays, chunk, lowering, with_s0):
  """The reference's gradients: jax.vjp of its SsdScan, as numpy."""
  jax, jnp, jax_scan = _Jax()
  dl, b_in, c_in, v, s0, dy, ds_fin = map(jnp.asarray, arrays)
  kw = dict(interpret=True) if lowering == "pallas" else {}

  def _Fn(*args):
    return jax_scan.SsdScan(*args[:4], s0=args[4] if with_s0 else None,
                            chunk_size=chunk, lowering=lowering, **kw)

  primals = (dl, b_in, c_in, v) + ((s0,) if with_s0 else ())
  (y, s_fin), vjp = jax.vjp(_Fn, *primals)
  cots = (dy, ds_fin if with_s0 else jnp.zeros_like(s_fin))
  grads = [np.asarray(g) for g in vjp(cots)]
  return grads + ([] if with_s0 else [None])


def _Close(got, want, names=("dl", "b", "c", "v", "s0")):
  for name, g, w in zip(names, got, want):
    if w is None:
      assert g is None, name
      continue
    g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
    assert np.isfinite(g).all(), name
    tol = (ATOL_DL if name == "dl" else ATOL) * max(1.0, float(np.abs(w).max()))
    np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)


def _TorchGrads(arrays, chunk, with_s0):
  """Autograd through the port's SsdScan on CPU tensors (the plain
  chunked path): the gradients of <y, dy> + <s_fin, ds_fin>."""
  leaves = [torch.as_tensor(x).requires_grad_(True) for x in arrays[:5]]
  y, s_fin = ssd_scan.SsdScan(*leaves[:4],
                              s0=leaves[4] if with_s0 else None,
                              chunk_size=chunk)
  loss = (y * torch.as_tensor(arrays[5])).sum()
  if with_s0:
    loss = loss + (s_fin * torch.as_tensor(arrays[6])).sum()
  loss.backward()
  return [x.grad for x in leaves[:4]] + [leaves[4].grad if with_s0 else None]


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("jax_lowering", ["pallas", "chunked"])
def test_plain_grads_match_jax(jax_lowering, chunk, masked, with_s0):
  arrays = _Inputs(masked=masked)
  want = _JaxVjp(arrays, chunk, jax_lowering, with_s0)
  before = (ssd_scan.SsdScan.launches, ssd_scan.SsdScan.bwd_launches)
  _Close(_TorchGrads(arrays, chunk, with_s0), want)
  t = [torch.as_tensor(x) for x in arrays]
  plain = ssd_scan._PlainScanBwd(*t[:4], t[4] if with_s0 else None, t[5],
                                 t[6] if with_s0 else None, chunk)
  _Close(plain, want)
  # CPU tensors launch nothing
  assert (ssd_scan.SsdScan.launches, ssd_scan.SsdScan.bwd_launches) == before


def test_plain_bwd_is_autograd_of_the_cpu_path():
  """`_PlainScanBwd` from saved inputs equals autograd through the CPU
  path's forward bit for bit (the same ops)."""
  arrays = _Inputs(seed=3, masked=True)
  t = [torch.as_tensor(x) for x in arrays]
  got = ssd_scan._PlainScanBwd(*t[:5], t[5], t[6], 8)
  want = _TorchGrads(arrays, 8, True)
  for g, w in zip(got, want):
    assert torch.equal(g, w)


def _KernelBwdModel(dl, b_in, c_in, v, s0, dy, ds_fin, chunk):
  """The backward kernel's arithmetic in plain float32 PyTorch, on flat
  [R, T, ...] tensors (`_SequentialScan`'s contract; dy [R, T, H], ds_fin
  [R, H, S]). Chunks of q steps (`BwdChunks`), the last cut at T. Pass 1:
  the forward sweep stores each chunk's S_in (S_j = exp(tot) S_{j-1} +
  (v o w)^T b) and the reverse sweep each chunk's dS_out (dS_in =
  exp(tot) dS_out + (c o E)^T dy); ds0 is the reverse sweep's last
  state. Pass 2, per chunk: the module docstring's formulas of
  `csrc/ssd_scan_bwd.cu`."""
  r, t = dl.shape
  q, nc = ssd_scan.BwdChunks(t, chunk)
  ddl, db, dc, dv = (torch.zeros_like(x) for x in (dl, b_in, c_in, v))

  def _Chunk(j):
    sl = slice(j * q, min(t, (j + 1) * q))
    cum = torch.cumsum(dl[:, sl], 1)                       # [R, qv]
    return sl, cum, cum[:, -1:]

  s_in, ds_out = [None] * nc, [None] * nc
  st = s0.clone()
  for j in range(nc):                                      # forward sweep
    s_in[j] = st
    sl, cum, tot = _Chunk(j)
    x = v[:, sl] * torch.exp(tot - cum)[..., None]         # [R, qv, H]
    st = torch.exp(tot)[..., None] * st + x.transpose(1, 2) @ b_in[:, sl]
  st = ds_fin.clone()
  for j in reversed(range(nc)):                            # reverse sweep
    ds_out[j] = st
    sl, cum, tot = _Chunk(j)
    y = c_in[:, sl] * torch.exp(cum)[..., None]            # [R, qv, S]
    st = (torch.exp(tot)[..., None] * st
          + dy[:, sl].transpose(1, 2) @ y)
  ds0 = st
  for j in range(nc):                                      # every chunk
    sl, cum, tot = _Chunk(j)
    qv = cum.shape[1]
    bb, cc, vv, gy = b_in[:, sl], c_in[:, sl], v[:, sl], dy[:, sl]
    si, dso = s_in[j], ds_out[j]
    low = torch.tril(torch.ones((qv, qv), dtype=torch.bool))
    ell = torch.where(low, torch.exp(torch.where(
        low, cum[:, :, None] - cum[:, None, :], torch.tensor(0.0))),
                      torch.tensor(0.0))                   # [R, t, p]
    al = (cc @ bb.transpose(1, 2)) * ell                   # scores o L
    g = torch.where(low, gy @ vv.transpose(1, 2), torch.tensor(0.0))
    m = g * al
    row, col = m.sum(2), m.sum(1)
    gl = g * ell
    e, w = torch.exp(cum), torch.exp(tot - cum)
    x = gy @ si                                            # dy S_in
    dc[:, sl] = x * e[..., None] + gl @ bb
    ci = (x * cc).sum(2) * e
    d = bb @ dso.transpose(1, 2)                           # b dS_out^T
    vd = (d * vv).sum(2) * w
    dv[:, sl] = d * w[..., None] + al.transpose(1, 2) @ gy
    db[:, sl] = (vv @ dso) * w[..., None] + gl.transpose(1, 2) @ cc
    dtot = vd.sum(1) + torch.exp(tot[:, 0]) * (dso * si).sum((1, 2))
    dcum = row - col + ci - vd
    dcum[:, -1] += dtot
    ddl[:, sl] = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
  return ddl, db, dc, dv, ds0


def _Flat(arrays):
  dl, b_in, c_in, v, s0, dy, ds_fin = (torch.as_tensor(x) for x in arrays)
  b, t, n = dl.shape
  s_dim, h = b_in.shape[-1], v.shape[-1]
  seq = lambda x, w: x.permute(0, 2, 1, 3).reshape(b * n, t, w)
  return (dl.permute(0, 2, 1).reshape(b * n, t), seq(b_in, s_dim),
          seq(c_in, s_dim), seq(v, h), s0.reshape(b * n, h, s_dim),
          seq(dy, h), ds_fin.reshape(b * n, h, s_dim))


def _Unflat(grads, b, n):
  ddl, db, dc, dv, ds0 = grads
  t = ddl.shape[1]
  seq = lambda x: x.reshape(b, n, t, x.shape[-1]).permute(0, 2, 1, 3)
  return (ddl.reshape(b, n, t).permute(0, 2, 1), seq(db), seq(dc), seq(dv),
          ds0.reshape(b, n, *ds0.shape[1:]))


@pytest.mark.parametrize("masked, kind, shape, chunk", [
    (True, None, (2, 13, 3, 8, 4), 4),       # a ragged tail, resets, padding
    (False, None, (1, 40, 2, 8, 4), 4),      # 10 chunks
    (True, None, (1, 100, 2, 8, 4), 8),      # 13 chunks, a ragged tail
    (False, "decode", (3, 256, 1, 8, 4), 64),  # 1 live step a row, 1 idle row
    (False, "hole", (2, 256, 1, 8, 4), 64),  # an identity chunk between live
    (False, None, (2, 20, 1, 8, 4), 64),     # T < Q
    (True, None, (1, 200, 1, 7, 5), 24),     # Q = 24, odd S and H
])
def test_kernel_model_matches_jax(masked, kind, shape, chunk):
  b, t, n, h, s = shape
  arrays = _Inputs(seed=9, b=b, t=t, n=n, h=h, s=s, masked=masked, kind=kind)
  want = _JaxVjp(arrays, chunk, "chunked", True)
  got = _Unflat(_KernelBwdModel(*_Flat(arrays), chunk), b, n)
  _Close(got, want)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: the scan's backward kernel is CUDA C++ "
                "with no CPU mode")


def _CardGrads(arrays, chunk, with_s0=True):
  """(kernel gradients, plain gradients) of one call on the card."""
  t = [torch.as_tensor(x).cuda() for x in arrays]
  s0 = t[4] if with_s0 else None
  ds_fin = t[6] if with_s0 else None
  got = ssd_scan._CudaScanBwd(*t[:4], s0, t[5], ds_fin, chunk)
  want = ssd_scan._PlainScanBwd(*t[:4], s0, t[5], ds_fin, chunk)
  return got, want


def _AgreeOnCard(got, want):
  for name, g, w in zip(("dl", "b", "c", "v", "s0"), got, want):
    if w is None:
      assert g is None, name
      continue
    assert bool(torch.isfinite(g).all()), name
    err = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
    assert err <= CARD_TOL, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("masked, kind, shape, chunk", [
    (True, None, (2, 13, 3, 8, 4), 4),        # the CPU cases' shapes
    (False, None, (2, 13, 3, 8, 8), 8),
    (True, "hole", (2, 256, 3, 64, 64), 64),  # an identity chunk mid-row
    (True, None, (1, 1100, 2, 64, 64), 64),   # 18 chunks, a ragged tail
    (False, None, (2, 20, 3, 64, 64), 64),    # T < Q
    (True, None, (2, 200, 2, 40, 24), 24),    # Q = 24
    (True, None, (1, 77, 2, 7, 5), 16),       # odd S and H
    (False, "decode", (4, 256, 4, 64, 64), 64),   # decode-only pack
    (False, None, (1, 300, 1, 128, 128), 128),    # tiles from device memory
    (True, None, (1, 70, 2, 24, 40), 32),     # S > H
])
@pytest.mark.parametrize("with_s0", [False, True])
def test_bwd_kernel_matches_plain_on_card(cuda, masked, kind, shape, chunk,
                                          with_s0):
  torch.backends.cuda.matmul.allow_tf32 = False
  b, t, n, h, s = shape
  arrays = _Inputs(seed=5, b=b, t=t, n=n, h=h, s=s, masked=masked, kind=kind)
  before = ssd_scan.SsdScan.bwd_launches
  got, want = _CardGrads(arrays, chunk, with_s0)
  again, _ = _CardGrads(arrays, chunk, with_s0)
  torch.cuda.synchronize()
  assert ssd_scan.SsdScan.bwd_launches == before + 2
  _AgreeOnCard(got, want)
  assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)


def _Packed(seed=21, b=8, t=1024, n=16, h=64, s=64, tail=100):
  """The hybrid's training shape as `GatedSSMLayer` builds it: each row
  packs segments (starts at 0, 300 and 700; the third ends `tail` steps
  early, which are padding), masked by `_MaskScanInputs`."""
  from lingvo_tpu_torch.core import ssm
  arrays = _Inputs(seed=seed, b=b, t=t, n=n, h=h, s=s)
  seg = np.ones((b, t), np.int32)
  seg[:, 300:] = 2
  seg[:, 700:] = 3
  pad = np.zeros((b, t), np.float32)
  pad[:, t - tail:] = 1.0
  seg[:, t - tail:] = 0
  dl, v = ssm.GatedSSMLayer._MaskScanInputs(
      torch.as_tensor(arrays[0]), torch.as_tensor(arrays[3]),
      torch.as_tensor(pad), torch.as_tensor(seg))
  arrays[0], arrays[3] = dl.numpy(), v.numpy()
  return arrays


@pytest.mark.cuda
def test_bwd_kernel_training_shape_on_card(cuda):
  torch.backends.cuda.matmul.allow_tf32 = False
  got, want = _CardGrads(_Packed(), 64, with_s0=False)
  torch.cuda.synchronize()
  _AgreeOnCard(got, want)


@pytest.mark.cuda
def test_scan_under_grad_launches_both_kernels(cuda):
  """SsdScan on CUDA tensors that need grad runs the forward kernel and,
  in backward, the backward kernel once: no plain path."""
  torch.backends.cuda.matmul.allow_tf32 = False
  arrays = _Inputs(seed=7, masked=True)
  leaves = [torch.as_tensor(x).cuda().requires_grad_(True)
            for x in arrays[:5]]
  dy, ds_fin = (torch.as_tensor(x).cuda() for x in arrays[5:])
  before = (ssd_scan.SsdScan.launches, ssd_scan.SsdScan.bwd_launches)
  y, s_fin = ssd_scan.SsdScan(*leaves[:4], s0=leaves[4], chunk_size=4)
  ((y * dy).sum() + (s_fin * ds_fin).sum()).backward()
  torch.cuda.synchronize()
  assert (ssd_scan.SsdScan.launches, ssd_scan.SsdScan.bwd_launches) == (
      before[0] + 1, before[1] + 1)
  want = ssd_scan._PlainScanBwd(*(x.detach() for x in leaves), dy, ds_fin, 4)
  _AgreeOnCard([x.grad for x in leaves], want)


@pytest.mark.cuda
def test_bwd_geometry(cuda):
  geo = ssd_scan.BwdGeometry(1024, 64, 64, 64)
  assert (geo["q"], geo["chunks"], geo["full"]) == (64, 16, 1)
  assert geo["chunk_smem"] <= 232448 and geo["per_sm"] >= 1
  big = ssd_scan.BwdGeometry(300, 128, 128, 128)
  assert (big["q"], big["chunks"], big["full"]) == (128, 3, 0)
  assert big["chunk_smem"] <= 232448 and big["per_sm"] >= 1
  assert ssd_scan.BwdGeometry(20, 64, 64, 64)["q"] == 20
