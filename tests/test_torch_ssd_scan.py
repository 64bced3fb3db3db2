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
- The identity the kernel's chunk skip rests on: over a tail of whole
  identity chunks (dl = 0, v = 0), the JAX `SsdScan` (chunked, and the
  Pallas kernel interpreted) and the port's plain scan give y_t = c_t .
  s_fin^T, and s_fin is the state after the last live step.
- `_KernelModel`, a plain mirror of the kernel's three phases (runs of
  chunks per cluster block from `ChunkRuns`, local states from zero, the
  carry D S_in + L passed between live runs, identity chunks skipped, live
  chunks cut at their last nonzero v), against the JAX chunked scan at
  ATOL: the regrouped carry and the skips change only float32 rounding.
- The CUDA kernel against `_ChunkedPlain` on the card, in the `cuda`-marked
  cases, which skip here: the shapes above, a decode-only pack (every row
  1 live step of 256, one row idle; the dead steps' y equal c_t . s_fin^T;
  two calls bitwise equal), an identity chunk between live chunks, T =
  1100 (18 chunks: runs of 2 and 3, the two-pass reload), T < Q, Q = 24,
  odd S and H, two h groups, and the built kernel's launch (`ChunkRuns`'
  split, threads, shared memory, ring stages, h groups). The module
  imports JAX only inside `_Jax`, so on
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


def _IdentityTail(seed=6, b=B, n=N, h=H, s=S, chunk=4, live=6, t=16):
  """Inputs whose steps from `live` on are identity steps (dl = 0, v = 0)
  filling whole chunks from `live` (a multiple of `chunk`) to t."""
  dl, b_in, c_in, v, s0 = _Inputs(seed=seed, b=b, t=t, n=n, h=h, s=s)
  dl[:, live:] = 0.0
  v[:, live:] = 0.0
  return dl, b_in, c_in, v, s0


@pytest.mark.parametrize("lowering", ["jax_chunked", "jax_pallas", "port"])
def test_identity_chunk_tail(lowering):
  """What the kernel's skip relies on: whole identity chunks read the
  incoming state and leave it as it is, y_t = c_t . s_fin^T."""
  live, chunk = 8, 4
  dl, b_in, c_in, v, s0 = _IdentityTail(live=live, chunk=chunk)
  if lowering == "port":
    y, s_fin = ssd_scan.SsdScan(*_Torch([dl, b_in, c_in, v]),
                                s0=torch.as_tensor(s0), chunk_size=chunk)
    y, s_fin = y.numpy(), s_fin.numpy()
    _, s_live = ssd_scan.SsdScan(*_Torch([x[:, :live] for x in
                                          (dl, b_in, c_in, v)]),
                                 s0=torch.as_tensor(s0), chunk_size=chunk)
    s_live = s_live.numpy()
  else:
    jnp, jax_scan = _Jax()
    kw = (dict(lowering="pallas", interpret=True)
          if lowering == "jax_pallas" else dict(lowering="chunked"))
    y, s_fin = map(np.asarray, jax_scan.SsdScan(
        *map(jnp.asarray, (dl, b_in, c_in, v)), s0=jnp.asarray(s0),
        chunk_size=chunk, **kw))
    _, s_live = jax_scan.SsdScan(
        *(jnp.asarray(x[:, :live]) for x in (dl, b_in, c_in, v)),
        s0=jnp.asarray(s0), chunk_size=chunk, **kw)
    s_live = np.asarray(s_live)
  np.testing.assert_array_equal(s_fin, s_live)   # the tail adds exact zeros
  want = np.einsum("btns,bnhs->btnh", c_in[:, live:], s_fin)
  np.testing.assert_allclose(y[:, live:], want, atol=ATOL)


def _KernelModel(dl, b_in, c_in, v, s0, chunk):
  """The kernel's three phases in plain float32 PyTorch, on flat [R, T,
  ...] tensors (the `_SequentialScan` contract). Per row, block k of the
  cluster owns the chunks `ChunkRuns(...)["runs"][k]`. Phase 1: each live
  chunk's U_j (cut at its last nonzero v) folded from zero into the run's
  L and D. Phase 2: a live run's S_out = D S_in + L goes to every block up
  to the next live run. Phase 3: y = (c o exp(cum)) S_{j-1}^T + (G o decay)
  v per chunk, S advanced within the run; identity chunks y = c S^T."""
  r, t = dl.shape
  s_dim, h = b_in.shape[-1], v.shape[-1]
  plan = ssd_scan.ChunkRuns(t, chunk)
  q = t if 0 < t < chunk else chunk
  dl, b_in, c_in, v, _ = ssd_scan._PadChunks(dl, b_in, c_in, v, q)
  y = torch.zeros((r, dl.shape[1], h))
  s_fin = torch.zeros((r, h, s_dim))
  for row in range(r):
    chunks = []
    for j in range(plan["chunks"]):
      sl = slice(j * q, (j + 1) * q)
      d, bb, cc, vv = dl[row, sl], b_in[row, sl], c_in[row, sl], v[row, sl]
      nz = torch.nonzero((vv != 0).any(-1))
      kv = int(nz.max()) + 1 if len(nz) else 0
      live = bool((d != 0).any()) or kv > 0
      cum = torch.cumsum(d, 0)
      tot = cum[-1]
      w = torch.exp(tot - cum)
      u = ((vv[:kv] * w[:kv, None]).T @ bb[:kv]) if live else None
      chunks.append(dict(live=live, kv=kv, cum=cum, e=torch.exp(tot), u=u,
                         b=bb, c=cc, v=vv))
    runs = plan["runs"]
    local = []
    for j0, j1 in runs:   # phase 1
      ell, dd, any_live = torch.zeros((h, s_dim)), torch.ones(()), False
      for ch in chunks[j0:j1]:
        if ch["live"]:
          ell = ch["e"] * ell + ch["u"]
          dd = dd * ch["e"]
          any_live = True
      local.append((dd, ell, any_live))
    s_in, carry = [None] * len(runs), s0[row]
    for k in range(len(runs)):   # phase 2
      s_in[k] = carry
      dd, ell, any_live = local[k]
      if any_live:
        carry = dd * carry + ell
    s_fin[row] = carry
    for k, (j0, j1) in enumerate(runs):   # phase 3
      st = s_in[k]
      for j in range(j0, j1):
        ch = chunks[j]
        out = ch["c"] @ st.T
        if ch["live"]:
          cum, kv = ch["cum"], ch["kv"]
          out = (ch["c"] * torch.exp(cum)[:, None]) @ st.T
          g = ch["c"] @ ch["b"][:kv].T
          keep = torch.tril(torch.ones((q, q), dtype=torch.bool))[:, :kv]
          dec = torch.exp(torch.where(keep, cum[:, None] - cum[None, :kv],
                                      torch.tensor(-1e30)))
          out = out + (g * dec) @ ch["v"][:kv]
          if j + 1 < j1:
            st = ch["e"] * st + ch["u"]
        y[row, j * q:(j + 1) * q] = out
  return y[:, :t], s_fin


def _Pack(kind, seed, b, t, n, h, s):
  """Inputs of a kernel case: 'random', 'masked' (`_Inputs`), 'decode'
  (every row live at step 0 only, the last row idle), 'hole' (steps 64 to
  127 identity in every row: a whole identity chunk at Q = 64, or runs of
  them at smaller Q, between live chunks)."""
  dl, b_in, c_in, v, s0 = _Inputs(seed=seed, b=b, t=t, n=n, h=h, s=s,
                                  masked=kind == "masked")
  if kind == "decode":
    dl[:, 1:] = 0.0
    v[:, 1:] = 0.0
    dl[-1] = 0.0
    v[-1] = 0.0
  elif kind == "hole":
    dl[:, 64:128] = 0.0
    v[:, 64:128] = 0.0
  return dl, b_in, c_in, v, s0


def _Flat(arrays):
  dl, b_in, c_in, v, s0 = (torch.as_tensor(x) for x in arrays)
  b, t, n = dl.shape
  s_dim, h = b_in.shape[-1], v.shape[-1]
  return (dl.permute(0, 2, 1).reshape(b * n, t),
          b_in.permute(0, 2, 1, 3).reshape(b * n, t, s_dim),
          c_in.permute(0, 2, 1, 3).reshape(b * n, t, s_dim),
          v.permute(0, 2, 1, 3).reshape(b * n, t, h),
          s0.reshape(b * n, h, s_dim))


@pytest.mark.parametrize("kind, shape, chunk", [
    ("masked", (2, 13, 3, 8, 4), 4),       # runs of one chunk, a ragged tail
    ("random", (1, 40, 2, 8, 4), 4),       # 10 chunks: runs of 1 and 2
    ("masked", (1, 100, 2, 8, 4), 4),      # 25 chunks: runs of 3 and 4
    ("decode", (3, 256, 1, 8, 4), 64),     # one live step a row, a row idle
    ("hole", (2, 256, 1, 8, 4), 64),       # an identity chunk between live
    ("hole", (1, 200, 1, 8, 4), 8),        # identity runs across blocks
    ("random", (2, 20, 1, 8, 4), 64),      # T < Q
    ("random", (1, 200, 1, 7, 5), 24),     # Q = 24: 9 chunks, odd S and H
])
def test_kernel_model_matches_jax(kind, shape, chunk):
  jnp, jax_scan = _Jax()
  b, t, n, h, s = shape
  args = _Pack(kind, 9, b, t, n, h, s)
  y_j, s_j = jax_scan.SsdScan(*map(jnp.asarray, args[:4]),
                              s0=jnp.asarray(args[4]), chunk_size=chunk,
                              lowering="chunked")
  y, s_fin = _KernelModel(*_Flat(args), chunk)
  y = y.reshape(b, n, t, h).permute(0, 2, 1, 3)
  np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=ATOL)
  np.testing.assert_allclose(s_fin.reshape(b, n, h, s).numpy(),
                             np.asarray(s_j), atol=ATOL)


# The launches of the kernel cases: (T, S, H, Q), the split of a row's
# chunks over its cluster (checked here) and the rest of the launch, which
# only the built library computes (checked on the card).
LAUNCHES = [
    ((256, 64, 64, 64), dict(cluster=2, per_block=2),     # hybrid serving
     dict(stages=2, threads=256, h_groups=1, smem=106176)),
    ((1024, 64, 64, 64), dict(cluster=8, per_block=2),    # hybrid training
     dict(stages=2, threads=256, h_groups=1, smem=106176)),
    ((1100, 64, 64, 64), dict(cluster=8, per_block=3), dict(stages=2)),
    ((20, 64, 64, 64), dict(cluster=1, per_block=1, chunks=1),
     dict(stages=1)),
    ((64, 64, 64, 64), dict(cluster=1, per_block=1),
     dict(stages=1, smem=70560)),
    ((0, 8, 8, 4), dict(cluster=1, per_block=0, chunks=0), dict()),
    ((1200, 128, 128, 128), dict(cluster=5, per_block=2),
     dict(stages=1, threads=512, h_groups=2)),
    ((40, 40, 100, 32), dict(cluster=1, per_block=2),
     dict(h_groups=2, threads=256)),
    ((300, 64, 64, 64), dict(cluster=3, per_block=2, chunks=5), dict()),
]


@pytest.mark.parametrize("t, s_dim, h, chunk, want",
                         [(*shape, runs) for shape, runs, _ in LAUNCHES])
def test_launch_plan(t, s_dim, h, chunk, want):
  del s_dim, h   # the split depends on T and Q alone
  plan = ssd_scan.ChunkRuns(t, chunk)
  for key, value in want.items():
    assert plan[key] == value, (key, plan)
  runs = plan["runs"]   # contiguous, in order, covering every chunk
  assert len(runs) == plan["cluster"] and runs[0][0] == 0
  assert runs[-1][1] == plan["chunks"]
  assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
  assert max(j1 - j0 for j0, j1 in runs) == plan["per_block"]
  if plan["chunks"]:
    assert min(j1 - j0 for j0, j1 in runs) >= 1


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


def _CardCase(kind, shape, chunk, seed=10):
  b, t, n, h, s = shape
  return _Torch(_Pack(kind, seed, b, t, n, h, s), "cuda")


def _AgreeWithPlain(got, want):
  for g, w in zip(got, want):
    assert bool(torch.isfinite(g).all())
    tol = ATOL * max(1.0, float(w.abs().max()))
    assert float((g - w).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("kind, shape, chunk", [
    ("hole", (2, 256, 3, 64, 64), 64),        # an identity chunk mid-row
    ("masked", (1, 1100, 2, 64, 64), 64),     # 18 chunks: runs of 2 and 3
    ("random", (2, 20, 3, 64, 64), 64),       # T < Q
    ("masked", (2, 200, 2, 40, 24), 24),      # Q = 24: 9 chunks
    ("masked", (1, 77, 2, 7, 5), 16),         # odd S and H: 4-byte copies
    ("masked", (1, 300, 1, 100, 36), 32),     # two h groups of 52 and 48
    ("random", (1, 1200, 1, 128, 128), 128),  # 512 threads, one stage
])
def test_kernel_edges_on_card(cuda, kind, shape, chunk):
  torch.backends.cuda.matmul.allow_tf32 = False
  args = _CardCase(kind, shape, chunk)
  before = ssd_scan.SsdScan.launches
  got = ssd_scan.SsdScan(*args[:4], s0=args[4], chunk_size=chunk)
  again = ssd_scan.SsdScan(*args[:4], s0=args[4], chunk_size=chunk)
  want = ssd_scan.SsdScan(*args[:4], s0=args[4], chunk_size=chunk,
                          lowering="chunked")
  torch.cuda.synchronize()
  assert ssd_scan.SsdScan.launches == before + 2
  _AgreeWithPlain(got, want)
  assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_kernel_decode_only_pack(cuda):
  """Every row 1 live step of 256, the last row idle: 3 of every row's 4
  chunks are identity chunks. The dead steps read the final state."""
  torch.backends.cuda.matmul.allow_tf32 = False
  args = _CardCase("decode", (4, 256, 4, 64, 64), 64)
  y, s_fin = ssd_scan.SsdScan(*args[:4], s0=args[4], chunk_size=64)
  y2, s_fin2 = ssd_scan.SsdScan(*args[:4], s0=args[4], chunk_size=64)
  want = ssd_scan.SsdScan(*args[:4], s0=args[4], chunk_size=64,
                          lowering="chunked")
  torch.cuda.synchronize()
  _AgreeWithPlain((y, s_fin), want)
  assert torch.equal(y, y2) and torch.equal(s_fin, s_fin2)
  dead = torch.einsum("btns,bnhs->btnh", args[2][:, 1:], s_fin)
  tol = ATOL * max(1.0, float(dead.abs().max()))
  assert float((y[:, 1:] - dead).abs().max()) <= tol
  idle = torch.einsum("btns,bnhs->btnh", args[2][-1:], args[4][-1:])
  assert float((y[-1:] - idle).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("t, s_dim, h, chunk, want",
                         [(*shape, rest) for shape, _, rest in LAUNCHES])
def test_kernel_geometry_matches_plan(cuda, t, s_dim, h, chunk, want):
  geo = ssd_scan.KernelGeometry(t, s_dim, h, chunk)
  plan = ssd_scan.ChunkRuns(t, chunk)
  for key in ("cluster", "chunks", "per_block"):
    assert geo[key] == plan[key], key
  for key, value in want.items():
    assert geo[key] == value, (key, geo)
  assert geo["smem"] <= 232448   # what a block may opt in to on sm_90
  assert geo["per_sm"] >= 1 and geo["clusters"] >= 1   # it launches


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
