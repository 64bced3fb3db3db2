"""lingvo_tpu_torch SsdScan against the JAX reference on the CPU.

- The plain chunked scan (`_ChunkedPlain`, the CPU path of 'auto' and
  'pallas') against the JAX `SsdScan` run as the Pallas kernel in
  interpret mode and as the XLA chunked path, at B, T, N, H, S = 2, 13, 3,
  8, 4 and chunk 4 and 8 (T ragged against both), from a nonzero initial
  state, with and without the masking contract (a padded tail, a padded
  run inside a chunk, a segment reset). y and s_final agree within atol
  2e-5: float32, the two frameworks sum the chunk products in different
  orders, and the state carries those differences across chunks.
- `SequentialStep` against the JAX one, and the plain chunked scan against
  the plain sequential one.
- The masking contract on the port itself: padded steps leave the state
  exactly unchanged, a reset isolates the tail.
- The CUDA kernel against `_ChunkedPlain` on the card, in the `cuda`-marked
  cases, which skip here. The module imports JAX only inside `_Jax`, so on
  a machine with a card and no JAX the kernel cases run alone:

    python -m pytest tests/test_torch_ssd_scan.py -m cuda
"""

import numpy as np
import pytest
import torch

from lingvo_tpu_torch.ops import ssd_scan

ATOL = 2e-5
B, T, N, H, S = 2, 13, 3, 8, 4


def _Jax():
  """(jax.numpy, the reference ssd_scan module)."""
  import jax.numpy as jnp
  from lingvo_tpu.ops import ssd_scan as jax_scan
  return jnp, jax_scan


def _Inputs(seed=0, b=B, t=T, n=N, h=H, s=S, masked=False):
  """decay_log, b_in, c_in, v, s0 as numpy float32. masked: steps 5..7 of
  row 0 and the last 3 steps of every row are padding (dl = 0, v = 0), and
  step 9 of the last row starts a new segment (dl = RESET_LOG)."""
  rng = np.random.RandomState(seed)
  dl = -np.logaddexp(rng.randn(b, t, n), 0.0)
  b_in, c_in = (0.5 * rng.randn(b, t, n, s) for _ in range(2))
  v = 0.5 * rng.randn(b, t, n, h)
  s0 = 0.2 * rng.randn(b, n, h, s)
  if masked:
    pad = np.zeros((b, t), bool)
    pad[0, 5:8] = True
    pad[:, -3:] = True
    dl[-1, 9] = ssd_scan.RESET_LOG
    dl = np.where(pad[..., None], 0.0, dl)
    v = np.where(pad[..., None, None], 0.0, v)
  return [x.astype(np.float32) for x in (dl, b_in, c_in, v, s0)]


def _Torch(arrays, device="cpu"):
  return [torch.as_tensor(x).to(device) for x in arrays]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("jax_lowering", ["pallas", "chunked"])
def test_plain_chunked_matches_jax(jax_lowering, chunk, masked):
  jnp, jax_scan = _Jax()
  args = _Inputs(masked=masked)
  kw = dict(interpret=True) if jax_lowering == "pallas" else {}
  y_j, s_j = jax_scan.SsdScan(*map(jnp.asarray, args[:4]),
                              s0=jnp.asarray(args[4]), chunk_size=chunk,
                              lowering=jax_lowering, **kw)
  before = ssd_scan.SsdScan.launches
  for lowering in ("auto", "pallas", "chunked"):
    y, s_fin = ssd_scan.SsdScan(*_Torch(args[:4]),
                                s0=torch.as_tensor(args[4]),
                                chunk_size=chunk, lowering=lowering)
    assert y.shape == (B, T, N, H) and s_fin.shape == (B, N, H, S)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=ATOL)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(s_j), atol=ATOL)
  assert ssd_scan.SsdScan.launches == before   # CPU tensors launch nothing


def test_sequential_step_matches_jax():
  jnp, jax_scan = _Jax()
  dl, b_in, c_in, v, s0 = _Inputs(seed=1)
  args = (s0, dl[:, 0], b_in[:, 0], c_in[:, 0], v[:, 0])
  s_j, y_j = jax_scan.SequentialStep(*map(jnp.asarray, args))
  s_t, y_t = ssd_scan.SequentialStep(*_Torch(args))
  np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=ATOL)
  np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL)


@pytest.mark.parametrize("chunk", [4, 8, 64])
def test_chunked_matches_sequential(chunk):
  args = _Torch(_Inputs(seed=2, masked=True))
  y_c, s_c = ssd_scan.SsdScan(*args[:4], s0=args[4], chunk_size=chunk,
                              lowering="chunked")
  y_s, s_s = ssd_scan.SsdScan(*args[:4], s0=args[4], lowering="sequential")
  np.testing.assert_allclose(y_c.numpy(), y_s.numpy(), atol=ATOL)
  np.testing.assert_allclose(s_c.numpy(), s_s.numpy(), atol=ATOL)


def test_padded_steps_leave_the_state_unchanged():
  """decay_log = 0 and v = 0: the state passes through bitwise."""
  dl, b_in, c_in, v, s0 = _Torch(_Inputs(seed=3))
  dl[:, 5:9] = 0.0
  v[:, 5:9] = 0.0
  _, s_with = ssd_scan.SsdScan(dl[:, :9], b_in[:, :9], c_in[:, :9], v[:, :9],
                               s0=s0, lowering="sequential")
  _, s_without = ssd_scan.SsdScan(dl[:, :5], b_in[:, :5], c_in[:, :5],
                                  v[:, :5], s0=s0, lowering="sequential")
  assert torch.equal(s_with, s_without)


def test_segment_reset_isolates_the_tail():
  dl, b_in, c_in, v, s0 = _Torch(_Inputs(seed=4))
  t0 = 6
  dl[:, t0] = ssd_scan.RESET_LOG
  y_packed, s_packed = ssd_scan.SsdScan(dl, b_in, c_in, v, s0=s0,
                                        chunk_size=4)
  y_fresh, s_fresh = ssd_scan.SsdScan(dl[:, t0:], b_in[:, t0:], c_in[:, t0:],
                                      v[:, t0:], chunk_size=4)
  np.testing.assert_allclose(y_packed[:, t0:].numpy(), y_fresh.numpy(),
                             atol=ATOL)
  np.testing.assert_allclose(s_packed.numpy(), s_fresh.numpy(), atol=ATOL)


def test_unported_and_bad_lowerings_raise():
  args = _Torch(_Inputs())[:4]
  with pytest.raises(NotImplementedError, match="associative"):
    ssd_scan.SsdScan(*args, lowering="associative")
  with pytest.raises(ValueError, match="lowering must be one of"):
    ssd_scan.SsdScan(*args, lowering="xla")
  with pytest.raises(ValueError, match="runs on cpu or cuda"):
    ssd_scan.SsdScan(*(x.to("meta") for x in args))


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: the scan kernel is CUDA C++ with no "
                "CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("shape, chunk", [
    ((2, 13, 3, 8, 4), 4),        # the CPU cases' shapes, ragged tail
    ((2, 13, 3, 8, 8), 8),
    ((1, 40, 2, 128, 128), 128),  # the kernel's limits: b read from memory
    ((1, 70, 2, 24, 40), 32),     # S > H, a ragged tail
])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_plain_on_card(cuda, shape, chunk, masked):
  b, t, n, h, s = shape
  torch.backends.cuda.matmul.allow_tf32 = False
  args = _Torch(_Inputs(seed=5, b=b, t=t, n=n, h=h, s=s, masked=masked),
                "cuda")
  before = ssd_scan.SsdScan.launches
  y, s_fin = ssd_scan.SsdScan(*args[:4], s0=args[4], chunk_size=chunk)
  y0, s_fin0 = ssd_scan.SsdScan(*args[:4], chunk_size=chunk)   # s0 = zeros
  y_p, s_p = ssd_scan.SsdScan(*args[:4], s0=args[4], chunk_size=chunk,
                              lowering="chunked")
  y0_p, s0_p = ssd_scan.SsdScan(*args[:4], chunk_size=chunk,
                                lowering="chunked")
  torch.cuda.synchronize()
  assert ssd_scan.SsdScan.launches == before + 2
  for got, want in ((y, y_p), (s_fin, s_p), (y0, y0_p), (s_fin0, s0_p)):
    assert bool(torch.isfinite(got).all())
    tol = ATOL * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
def test_kernel_wrapper_raises(cuda):
  args = _Torch(_Inputs(), "cuda")
  with pytest.raises(ValueError, match="chunk_size in"):
    ssd_scan.SsdScan(*args[:4], chunk_size=256)
  leaf = args[3].clone().requires_grad_(True)
  with pytest.raises(NotImplementedError, match="hybrid training slice"):
    ssd_scan.SsdScan(*args[:3], leaf)
  with torch.no_grad():
    ssd_scan.SsdScan(*args[:3], leaf)
  with pytest.raises(ValueError, match="contiguous"):
    ssd_scan.SsdScan(args[0], args[1].transpose(0, 1).contiguous()
                     .transpose(0, 1), args[2], args[3])
