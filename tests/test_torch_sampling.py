"""Seeded sampling of lingvo_tpu_torch (core/threefry.py, core/sampling.py, ops/sample_tokens.py).

On the CPU, against JAX (`jax_threefry_partitionable=True`, as
tests/conftest.py pins it):
- `PRNGKey`, `FoldIn`, `Split` and `Bits32` equal `jax.random`'s bit for
  bit, for seeds 0, 1, 7 and 2**31 - 1, and so do the uniforms; the
  Gumbel noise is within 2e-6 (PyTorch's and XLA's float32 logarithms
  differ by an ulp on some elements).
- `_TransformLogits` equals `jax.jit` of the reference's bit for bit (XLA
  makes its `logits / temperature` a product with the float32
  reciprocal; the control: eager JAX divides, and differs), and the plain
  version's threshold is the k-th largest scaled logit, ties included,
  and the k-th largest raw logit times the reciprocal (the kernel's).
- `SampleFromLogits` gives the tokens of `jax.jit` of the reference at
  T in {0.3, 0.7, 1.0, 1.7} and top_k in {0, 1, 5, V}, with row seeds,
  and with row seeds and positions, on rows whose k-th value is tied;
  `SampleTokens` with its top_k does at the threshold's edges (a tie at
  the k-th value, +0.0 and -0.0 there, -inf logits, k = 1, V - 1 and >=
  V). Without row seeds it raises: no caller of the port draws one stream
  over the whole array. A token may differ only where the two
  largest perturbed values of its row are closer than 1e-5 (the Gumbel
  noise's ulps); the test prints that margin.
- `rows` draws the full draw's tokens and winning values at those rows,
  bit for bit; every call counts its rows (`rows_drawn`, `widest`).
- `Plan`, the kernel's cluster size, on a stand-in for the card's fit.
- Greedy (temperature 0) is the argmax and launches nothing.
- `GShardDecode(temperature=0.8, top_k=5)` continuations on DenseLmTiny
  equal the JAX decoder's, each side restoring its own checkpoint (JAX's
  orbax checkpointer, the port's own), and two calls give the same ones.

The `cuda` cases (they skip without a card) hold the sampling kernel
against its plain version on the card at the serving shapes ([264,
32000] with the engine's (seed, position) folds, [8, 32000] with
GShardDecode's row folds), T = 0.7, top_k 0 and 40 (two calls bitwise
equal), R' = 8 rows of [264, 32000] through `rows` (the full draw's bits
at those rows), a row split over clusters of 1, 2, 3, 8 and 16 blocks at
R = 1 and 8 (V = 32000 and 32001), and the threshold's edges: equal
tokens, the winning value within 1 ulp, one launch a call.
This file imports JAX only inside its CPU tests, so on the card run

    python -m pytest tests/test_torch_sampling.py -m cuda
"""

import numpy as np
import pytest
import torch

from lingvo_tpu_torch.core import jit_arith
from lingvo_tpu_torch.core import sampling
from lingvo_tpu_torch.core import threefry
from lingvo_tpu_torch.ops import sample_tokens

_SEEDS = [0, 1, 7, 2**31 - 1]


def _Jax():
  import jax   # lazily: the card's machine has no JAX
  import jax.numpy as jnp
  from lingvo_tpu.core import sampling as jax_sampling
  return jax, jnp, jax_sampling


def _U32(x):
  return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", _SEEDS)
def test_keys_and_bits_match_jax(seed):
  jax, _, _ = _Jax()
  jk, tk = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
  np.testing.assert_array_equal(tk.numpy(), _U32(jk))
  for d in (0, 3, 12345, 2**31 - 1):
    np.testing.assert_array_equal(threefry.FoldIn(tk, d).numpy(),
                                  _U32(jax.random.fold_in(jk, d)))
  # folds of a vector of data, as the reference's vmapped rows
  data = np.array([0, 5, 99, 2**31 - 1], np.int32)
  want = jax.vmap(lambda s: jax.random.fold_in(jk, s))(data.astype(np.uint32))
  np.testing.assert_array_equal(
      threefry.FoldIn(tk, torch.as_tensor(data)).numpy(), _U32(want))
  np.testing.assert_array_equal(threefry.Split(tk, 6).numpy(),
                                _U32(jax.random.split(jk, 6)))
  np.testing.assert_array_equal(threefry.Bits32(tk, (3, 7)).numpy(),
                                _U32(jax.random.bits(jk, (3, 7))))


@pytest.mark.parametrize("seed", _SEEDS)
def test_uniform_bitwise_and_gumbel_close(seed):
  jax, _, _ = _Jax()
  jk, tk = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
  tiny = np.finfo(np.float32).tiny
  want = np.asarray(jax.random.uniform(jk, (4000,), minval=tiny, maxval=1.0))
  got = threefry.Uniform(tk, (4000,)).numpy()
  np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
  assert got.min() >= tiny and got.max() < 1.0
  np.testing.assert_allclose(threefry.Gumbel(tk, (4000,)).numpy(),
                             np.asarray(jax.random.gumbel(jk, (4000,))),
                             atol=2e-6, rtol=0)
  # a zero mantissa gives tiny, the floor
  assert threefry.UniformFromBits(torch.tensor([0, 511])).tolist() == [
      tiny, tiny]


_V = 1000


def _Logits(seed=0, b=6):
  """[b, V] logits; row 0's maximum is tied (two copies), row 1's 5th
  largest value is tied three ways, row 2 has a tie at 40."""
  rng = np.random.RandomState(seed)
  x = (rng.randn(b, _V) * 3).astype(np.float32)
  x[0, [10, 500]] = 20.0
  x[1, [3, 4, 5, 6]] = [30.0, 29.0, 28.0, 27.0]
  x[1, [100, 200, 300]] = 26.0
  x[2, :39] = 25.0 + np.arange(39, dtype=np.float32) / 8
  x[2, [700, 800]] = 24.0
  return x


@pytest.mark.parametrize("temperature", [0.3, 0.7, 1.0, 1.7])
def test_transform_logits_follows_the_jitted_reference(temperature):
  jax, jnp, jax_sampling = _Jax()
  x = _Logits()
  for k in (0, 1, 5, 40, _V):
    want = np.asarray(jax.jit(
        lambda l: jax_sampling._TransformLogits(l, temperature, k))(x))
    got = sampling._TransformLogits(torch.as_tensor(x), temperature, k)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    scaled = torch.as_tensor(x) * jit_arith.Reciprocal(temperature)
    if 0 < k < _V:
      # the plain version's threshold: the k-th largest scaled value, ties
      # counted, bit for bit, and the k-th largest raw value times the
      # reciprocal (what the kernel computes)
      thr = sample_tokens._KthLargest(scaled, k)[:, 0].numpy()
      kth = np.sort(got.numpy(), axis=-1)[:, -k]
      np.testing.assert_array_equal(thr.view(np.int32), kth.view(np.int32))
      raw = np.sort(x, axis=-1)[:, -k] * np.float32(
          jit_arith.Reciprocal(temperature))
      np.testing.assert_array_equal(raw.view(np.int32), kth.view(np.int32))
      live = np.isfinite(got.numpy()).sum(-1)
      assert (live >= k).all()
      if k == 5:
        assert live[1] == 7   # the three-way tie at the 5th value stays live
    else:
      assert not sample_tokens.Masked(k, _V)
      assert sample_tokens.MaskTopK(scaled, k) is scaled
  # the control: eager JAX divides by the temperature, and differs
  eager = np.asarray(jax_sampling._TransformLogits(jnp.asarray(x),
                                                   temperature, 0))
  scaled = sampling._TransformLogits(torch.as_tensor(x), temperature, 0)
  assert (eager != scaled.numpy()).any() == (temperature != 1.0)
  assert jit_arith.Reciprocal(temperature) == float(
      np.float32(1) / np.float32(temperature))


def _AssertSameTokens(want, got, x, key, temperature, top_k, seeds, pos):
  """Tokens equal, or, where one differs, a near-tie: the two largest
  perturbed values of the row (the port's) within 1e-5, printed."""
  differ = np.nonzero(np.asarray(want) != np.asarray(got))[0]
  if not len(differ):
    return
  z = sampling._TransformLogits(torch.as_tensor(x), temperature, top_k)
  keys = threefry.FoldIn(key, torch.as_tensor(seeds))
  if pos is not None:
    keys = threefry.FoldIn(keys, torch.as_tensor(pos))
  noise = threefry.Gumbel(keys, (z.shape[1],))
  top2 = torch.topk(noise + z, 2, dim=-1).values.numpy()
  for r in differ:
    margin = float(top2[r, 0] - top2[r, 1])
    print(f"row {r}: token {got[r]} against {want[r]}, margin {margin:.3g}")
    assert margin < 1e-5, (r, margin)


@pytest.mark.parametrize("top_k", [0, 1, 5, _V])
@pytest.mark.parametrize("temperature", [0.3, 0.7, 1.0, 1.7])
def test_sample_from_logits_matches_the_jitted_reference(temperature, top_k):
  jax, _, jax_sampling = _Jax()
  x = _Logits(seed=int(temperature * 10) + top_k)
  rng = np.random.RandomState(top_k)
  seeds = rng.randint(0, 2**31 - 1, size=x.shape[0]).astype(np.int32)
  pos = rng.randint(0, 100, size=x.shape[0]).astype(np.int32)
  key = threefry.PRNGKey(3)
  for use_pos in (False, True):
    p = pos if use_pos else None

    def Ref(l, rs, ps, p=p):
      return jax_sampling.SampleFromLogits(
          l, jax.random.PRNGKey(3), temperature, top_k, row_seeds=rs,
          positions=None if p is None else ps)

    want = np.asarray(jax.jit(Ref)(x, seeds, pos))
    got = sampling.SampleFromLogits(
        torch.as_tensor(x), key, temperature, top_k,
        row_seeds=torch.as_tensor(seeds),
        positions=None if p is None else torch.as_tensor(p))
    assert got.dtype == torch.int32 and tuple(got.shape) == (x.shape[0],)
    _AssertSameTokens(want, got.numpy(), x, key, temperature, top_k, seeds,
                      p)
    if top_k == 1:   # only the maximum is live: the argmax, or a tied one
      assert (x[np.arange(len(x)), got.numpy()] == x.max(-1)).all()


def test_leading_dims_sample_row_by_row():
  """[B, C, V] logits with per-(row, column) seeds equal the same rows
  flattened: the legacy step's every-column draw."""
  x = np.random.RandomState(4).randn(3, 4, 50).astype(np.float32)
  seeds = torch.arange(3, dtype=torch.int32)[:, None].expand(3, 4)
  pos = torch.arange(4, dtype=torch.int32)[None].expand(3, 4)
  key = threefry.PRNGKey(9)
  got = sampling.SampleFromLogits(torch.as_tensor(x), key, 0.8, 5,
                                  row_seeds=seeds, positions=pos)
  flat = sampling.SampleFromLogits(torch.as_tensor(x.reshape(12, 50)), key,
                                   0.8, 5, row_seeds=seeds.reshape(-1),
                                   positions=pos.reshape(-1))
  assert tuple(got.shape) == (3, 4)
  np.testing.assert_array_equal(got.reshape(-1).numpy(), flat.numpy())


def _EdgeLogits(v=64, seed=11):
  """[6, v] rows at the threshold's edges: row 0's 5th largest value is
  tied four ways; row 1 has four positives, then one +0.0 and three -0.0
  (the 5th largest is +0.0, the 6th -0.0 in the radix order, equal to it
  in a comparison); row 2 three finite values and the rest -inf (a k-th
  value of -inf masks nothing); row 3 -inf at every even column; row 4
  its maximum tied eight ways; row 5 plain."""
  rng = np.random.RandomState(seed)
  x = (rng.randn(6, v) * 2).astype(np.float32)
  x[0] = np.minimum(x[0], 3.0)
  x[0, [1, 2, 3, 4]] = [9.0, 8.0, 7.0, 6.0]
  x[0, [7, 20, 33, 50]] = 5.0
  x[1] = -np.abs(x[1]) - 0.5
  x[1, [5, 6, 7, 8]] = [4.0, 3.0, 2.0, 1.0]
  x[1, 10] = 0.0
  x[1, [11, 12, 13]] = -0.0
  x[2] = -np.inf
  x[2, [9, 40, v - 1]] = [1.0, 0.5, 2.0]
  x[3, ::2] = -np.inf
  x[4, 8:16] = 7.0
  return x


_EDGE_K = [1, 2, 5, 6, 8, 63, 64, 69]   # V = 64: k = 1, V - 1, >= V


@pytest.mark.parametrize("top_k", _EDGE_K)
def test_fused_top_k_edges_match_the_jitted_reference(top_k):
  """The plain version with its top_k (`SampleTokens(..., top_k)`) gives
  the tokens of `jax.jit` of the reference at the threshold's edges."""
  jax, _, jax_sampling = _Jax()
  x = _EdgeLogits()
  rng = np.random.RandomState(top_k)
  seeds = rng.randint(0, 2**31 - 1, size=x.shape[0]).astype(np.int32)
  pos = rng.randint(0, 100, size=x.shape[0]).astype(np.int32)
  key = threefry.PRNGKey(5)
  fold = torch.as_tensor(np.stack([seeds, pos], 1))
  for temperature in (0.7, 1.0):

    def Ref(l, rs, ps, t=temperature):
      return jax_sampling.SampleFromLogits(l, jax.random.PRNGKey(5), t,
                                           top_k, row_seeds=rs, positions=ps)

    want = np.asarray(jax.jit(Ref)(x, seeds, pos))
    got = sample_tokens.SampleTokens(torch.as_tensor(x), key, fold,
                                     jit_arith.Reciprocal(temperature),
                                     top_k)
    _AssertSameTokens(want, got.numpy(), x, key, temperature, top_k, seeds,
                      pos)
    z = sampling._TransformLogits(torch.as_tensor(x), temperature,
                                  top_k).numpy()
    assert np.isfinite(z[np.arange(len(z)), got.numpy()]).all()
    live = (z > -np.inf).sum(-1)
    if top_k == 5:
      assert live[0] == 8          # the four-way tie at the 5th value
      assert live[1] == 8          # +0.0 at the 5th: every zero stays
    if top_k == 6:
      assert live[1] == 8          # -0.0 at the 6th: +0.0 stays too
    if top_k in (5, 8, 63):
      assert live[2] == 3          # a k-th of -inf masks nothing
    if top_k == 1:
      assert got.numpy()[2] == 63 and 8 <= got.numpy()[4] < 16


@pytest.mark.parametrize("top_k", [0, 5])
def test_rows_draw_the_full_draws_rows(top_k):
  """A draw of some rows (`rows`) gives the full draw's tokens and
  winning values at those rows, bit for bit, through `SampleTokens` and
  through `SampleFromLogits` of [B, C, V] logits flattened."""
  x = torch.as_tensor(np.concatenate([_EdgeLogits(), _Logits(b=4)[:, :64]]))
  key = threefry.PRNGKey(8)
  fold = torch.randint(0, 2**31 - 1, (10, 2), generator=torch.Generator(
      "cpu").manual_seed(top_k), dtype=torch.int32)
  full, full_z = sample_tokens.SampleTokens(x, key, fold, 1.3, top_k,
                                            return_z=True)
  rows = torch.tensor([9, 0, 4, 4, 2, 7], dtype=torch.int32)
  part, part_z = sample_tokens.SampleTokens(x, key, fold[rows.long()], 1.3,
                                            top_k, rows=rows, return_z=True)
  np.testing.assert_array_equal(part.numpy(), full.numpy()[rows.numpy()])
  np.testing.assert_array_equal(part_z.numpy().view(np.int32),
                                full_z.numpy()[rows.numpy()].view(np.int32))
  # [B, C, V] with a stream per (row, column): rows of the flattened logits
  seeds = fold[:, 0].reshape(2, 5)
  pos = fold[:, 1].reshape(2, 5)
  grid = sampling.SampleFromLogits(x.reshape(2, 5, 64), key, 0.9, top_k,
                                   row_seeds=seeds, positions=pos)
  some = sampling.SampleFromLogits(x.reshape(2, 5, 64), key, 0.9, top_k,
                                   row_seeds=fold[rows.long(), 0],
                                   positions=fold[rows.long(), 1], rows=rows)
  assert tuple(some.shape) == (6,)
  np.testing.assert_array_equal(some.numpy(),
                                grid.reshape(-1).numpy()[rows.numpy()])


def test_rows_counters():
  """Every draw adds its R' to `rows_drawn` and raises `widest` to it, on
  the CPU too; the plain version launches nothing."""
  x = torch.as_tensor(_Logits())
  key = threefry.PRNGKey(1)
  fold = torch.zeros(6, 1, dtype=torch.int32)
  counts = (sample_tokens.SampleTokens.launches,
            sample_tokens.SampleTokens.rows_drawn)
  sample_tokens.SampleTokens.widest = 0
  sample_tokens.SampleTokens(x, key, fold, 1.0)
  sample_tokens.SampleTokens(x, key, fold[:2], 1.0, 3,
                             rows=torch.tensor([5, 1], dtype=torch.int32))
  assert sample_tokens.SampleTokens.launches == counts[0]
  assert sample_tokens.SampleTokens.rows_drawn == counts[1] + 8
  assert sample_tokens.SampleTokens.widest == 6


def _Fit(masked, chunk, s, per_sm_full=4):
  """A stand-in for the card's fit: the masked kernel by its shared
  memory (228 KB an SM, 1 KB reserved and 2.2 KB static a block), the
  full-row kernel by its registers."""
  if not masked:
    return per_sm_full, True
  return min(8, 228 * 1024 // (chunk * 4 + 3277)), True


def test_launch_plan():
  """`Plan`: the largest cluster of one wave, else the smallest with 3
  blocks or more an SM; slices that fit."""
  plan = sample_tokens.Plan
  # GShardDecode's step and a ragged step's draw: a cluster of 16 a row
  assert plan(8, 32000, 40, 132, _Fit) == (16, 2000)
  assert plan(8, 32000, 0, 132, _Fit) == (16, 2000)
  assert plan(1, 32000, 40, 132, _Fit) == (16, 2000)
  # 264 masked rows never fit one wave: the smallest cluster with 3 blocks
  # or more an SM
  s, chunk = plan(264, 32000, 40, 132, _Fit)
  per_sm = _Fit(True, chunk, s)[0]
  assert per_sm >= sample_tokens.MIN_BLOCKS_PER_SM
  assert 264 * s > 132 * per_sm and (s, chunk) == (2, 16000)
  # 264 full rows: the largest cluster of one wave
  assert plan(264, 32000, 0, 132, _Fit) == (2, 16000)
  eight = lambda m, c, s: _Fit(m, c, s, per_sm_full=8)
  assert plan(264, 32000, 0, 132, eight) == (4, 8000)
  assert plan(4096, 32000, 0, 132, _Fit) == (1, 32000)
  for v in (1, 3, 100, 255, 257, 513, 32001):
    for n, k in ((1, 0), (8, 2), (264, 1)):
      s, chunk = plan(n, v, k, 132, _Fit)
      assert chunk % 4 == 0 and s * chunk >= v and (s - 1) * chunk < v
      assert s <= max(1, v // sample_tokens.THREADS)
  # a cluster the card cannot place: the largest that it can
  portable = lambda m, c, s: (_Fit(m, c, s)[0], s <= 8)
  assert plan(8, 32000, 40, 132, portable) == (8, 4000)
  # a row too long for 16 held slices
  with pytest.raises(ValueError, match="does not fit"):
    plan(1, 16 * sample_tokens.HOLD_BYTES // 4 + 4, 5, 132, _Fit)
  # unmasked, the same row needs no slice held
  assert plan(1, 16 * sample_tokens.HOLD_BYTES // 4 + 4, 0, 132, _Fit)[0] \
      == 16


def test_greedy_is_the_argmax_and_launches_nothing():
  x = torch.as_tensor(_Logits())
  before = sample_tokens.SampleTokens.launches
  got = sampling.SampleFromLogits(x)
  assert got.dtype == torch.int32
  np.testing.assert_array_equal(got.numpy(),
                                np.argmax(x.numpy(), axis=-1))
  assert (sampling.SampleFromLogits(x, threefry.PRNGKey(1), 0.0, 5)
          == got).all()
  assert sample_tokens.SampleTokens.launches == before


def test_sample_tokens_checks_its_inputs():
  x = torch.zeros(4, 10)
  key = threefry.PRNGKey(0)
  fold = torch.zeros(4, 2, dtype=torch.int32)
  with pytest.raises(TypeError):
    sample_tokens.SampleTokens(x.double(), key, fold, 1.0)
  with pytest.raises(ValueError, match="fold"):
    sample_tokens.SampleTokens(x, key, torch.zeros(4, 3, dtype=torch.int32),
                               1.0)
  with pytest.raises(ValueError, match="fold"):
    sample_tokens.SampleTokens(x, key, torch.zeros(4, 0, dtype=torch.int32),
                               1.0)
  with pytest.raises(ValueError, match="fold"):
    sample_tokens.SampleTokens(x, key, fold.long(), 1.0)
  for bad in (-1, 2.0, True, None):
    with pytest.raises(ValueError, match="top_k"):
      sample_tokens.SampleTokens(x, key, fold, 1.0, top_k=bad)
  for bad in (torch.zeros(2, dtype=torch.int64),
              torch.zeros(2, 1, dtype=torch.int32),
              torch.zeros(0, dtype=torch.int32)):
    with pytest.raises(ValueError, match="rows"):
      sample_tokens.SampleTokens(x, key, fold[:2], 1.0, rows=bad)
  for bad in ((-1, 0), (0, 4)):
    with pytest.raises(ValueError, match="rows"):
      sample_tokens.SampleTokens(x, key, fold[:2], 1.0,
                                 rows=torch.tensor(bad, dtype=torch.int32))
  # with rows, fold has a row a draw: [R', F], not [R, F]
  with pytest.raises(ValueError, match="fold"):
    sample_tokens.SampleTokens(x, key, fold, 1.0,
                               rows=torch.zeros(2, dtype=torch.int32))
  with pytest.raises(ValueError, match="rows"):
    sampling.SampleFromLogits(x, rows=torch.zeros(2, dtype=torch.int32))
  with pytest.raises(ValueError, match="row_seeds"):
    sampling.SampleFromLogits(x, key, 1.0)
  with pytest.raises(ValueError, match="row_seeds"):
    sampling.SampleFromLogits(x, key, 1.0, positions=fold[:, 0])
  tokens, z = sample_tokens.SampleTokens(x, key, fold, 1.0, return_z=True)
  assert tokens.dtype == torch.int32 and z.dtype == torch.float32
  tokens = sample_tokens.SampleTokens(x, key, fold[1:3], 1.0, top_k=3,
                                      rows=torch.tensor([3, 0],
                                                        dtype=torch.int32))
  assert tuple(tokens.shape) == (2,)
  assert sample_tokens.SampleTokens.launches == 0


_STEPS = 8


@pytest.fixture(scope="module")
def sampled_checkpoints(tmp_path_factory):
  """DenseLmTiny's noised theta saved at step 5 by the JAX checkpointer
  and by the port's; the JAX decoder's sampled records."""
  jax, jnp, _ = _Jax()
  from lingvo_tpu.core import checkpointer as jax_checkpointer
  from lingvo_tpu.runners import gshard_decode as jax_gshard
  from lingvo_tpu_torch import convert
  from lingvo_tpu_torch.core import checkpointer
  from tests.test_torch_gshard_decode import (_JaxTiny, _LENS, _Noised,
                                              _PROMPTS, _PortTiny)
  root = tmp_path_factory.mktemp("gshard_sampled")
  task = _JaxTiny(4)
  state = task.CreateTrainState(jax.random.PRNGKey(3))
  theta = _Noised(state.theta, seed=4, scale=0.3)
  state.theta = jax.tree_util.tree_map(jnp.asarray, theta)
  jax_dir = str(root / "jax")
  ckpt = jax_checkpointer.Checkpointer(jax_dir)
  ckpt.Save(5, state, force=True)
  ckpt.Close()
  want = jax_gshard.GShardDecode(
      task, jax_dir, str(root / "jax.jsonl"), max_decode_steps=_STEPS,
      prefill_chunk_size=3, temperature=0.8, top_k=5).DecodeOnce(
          5, _PROMPTS, _LENS)
  lm = _PortTiny(4)
  convert.LoadJaxTheta(lm, theta)
  port_dir = str(root / "port")
  assert checkpointer.Checkpointer(port_dir).Save(
      5, lm, lm.CreateTrainState(), force=True)
  return root, port_dir, want, _PortTiny, _PROMPTS, _LENS


@pytest.mark.parametrize("page, chunk", [(4, 3), (0, 0)])
def test_gshard_decode_sampled_matches_reference(sampled_checkpoints, page,
                                                 chunk):
  from lingvo_tpu_torch.runners import gshard_decode
  root, port_dir, want, port_tiny, prompts, lens = sampled_checkpoints
  decoder = gshard_decode.GShardDecode(
      port_tiny(page), port_dir, str(root / f"port_{page}.jsonl"),
      max_decode_steps=_STEPS, prefill_chunk_size=chunk, temperature=0.8,
      top_k=5)
  got = [r["output_ids"] for r in decoder.DecodeOnce(5, prompts, lens)]
  assert got == [r["output_ids"] for r in want]
  again = decoder.DecodeOnce(5, prompts, lens)
  assert [r["output_ids"] for r in again] == got
  greedy = gshard_decode.GShardDecode(
      port_tiny(page), port_dir, str(root / f"greedy_{page}.jsonl"),
      max_decode_steps=_STEPS, prefill_chunk_size=chunk).DecodeOnce(
          5, prompts, lens)
  assert [r["output_ids"] for r in greedy] != got


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (the sampling kernel runs only on a "
                "card)")


def _OnCard(r, v, f, top_k, temperature=0.7, seed=0, rows=None,
            cluster=None, x=None):
  """The kernel against the plain version on the card: equal tokens, the
  winning value within 1 ulp, one launch. rows: the drawn rows (None:
  all); cluster: the launch's S (None: `LaunchPlan`'s); x: the logits
  (default randn * 4)."""
  gen = torch.Generator("cpu").manual_seed(seed)
  if x is None:
    x = torch.randn(r, v, generator=gen) * 4
  x = torch.as_tensor(x).cuda()
  n = r if rows is None else len(rows)
  fold = torch.randint(0, 2**31 - 1, (n, f), generator=gen,
                       dtype=torch.int32).cuda()
  rows = None if rows is None else torch.tensor(rows, dtype=torch.int32,
                                                device="cuda")
  key = threefry.PRNGKey(3 + seed)
  inv_t = jit_arith.Reciprocal(temperature)
  before = sample_tokens.SampleTokens.launches
  if cluster is None:
    tokens, z = sample_tokens.SampleTokens(x, key, fold, inv_t, top_k,
                                           rows=rows, return_z=True)
  else:
    tokens, z = sample_tokens._CudaSample(x, key, fold, inv_t, top_k, rows,
                                          cluster=cluster)
  torch.cuda.synchronize()
  assert sample_tokens.SampleTokens.launches == before + 1
  want, want_z = sample_tokens._PlainSample(x, key, fold, inv_t, top_k,
                                            rows)
  assert torch.equal(tokens, want)
  ulp = torch.abs(torch.nextafter(want_z, torch.full_like(want_z, np.inf))
                  - want_z)
  assert ((z == want_z) | (torch.abs(z - want_z) <= ulp)).all()
  # the CPU's plain version draws the same tokens
  cpu = sample_tokens.SampleTokens(x.cpu(), key, fold.cpu(), inv_t, top_k,
                                   rows=None if rows is None else rows.cpu())
  assert torch.equal(cpu, tokens.cpu())
  return tokens, z


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [0, 40])
@pytest.mark.parametrize("r, f", [(264, 2), (8, 1)])
def test_kernel_matches_plain_on_card(cuda, r, f, top_k):
  _OnCard(r, 32000, f, top_k)
  # two calls are bitwise equal
  a = _OnCard(r, 32000, f, top_k, seed=4)
  b = _OnCard(r, 32000, f, top_k, seed=4)
  assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [0, 40])
def test_kernel_rows_on_card(cuda, top_k):
  """R' = 8 rows of [264, 32000] drawn in place: the full draw's tokens
  and winning values at those rows, bit for bit."""
  rows = [263, 0, 17, 17, 100, 5, 200, 131]
  x = torch.randn(264, 32000, generator=torch.Generator(
      "cpu").manual_seed(6)) * 4
  fold = torch.randint(0, 2**31 - 1, (264, 2), dtype=torch.int32,
                       generator=torch.Generator("cpu").manual_seed(7))
  key = threefry.PRNGKey(11)
  xc, fc = x.cuda(), fold.cuda()
  rc = torch.tensor(rows, dtype=torch.int32, device="cuda")
  full, full_z = sample_tokens.SampleTokens(xc, key, fc, 0.5, top_k,
                                            return_z=True)
  part, part_z = sample_tokens.SampleTokens(xc, key, fc[rc.long()], 0.5,
                                            top_k, rows=rc, return_z=True)
  assert torch.equal(part, full[rc.long()])
  assert torch.equal(part_z, full_z[rc.long()])
  _OnCard(264, 32000, 2, top_k, rows=rows, seed=8)


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [0, 40])
@pytest.mark.parametrize("v", [32000, 32001])
@pytest.mark.parametrize("r", [1, 8])
def test_kernel_cluster_split_on_card(cuda, r, v, top_k):
  """A row split over clusters of 1, 2, 3, 8 and 16 blocks (the
  histograms and the bests summed through distributed shared memory),
  and the plan's own; v = 32001 copies its slices 4 bytes at a time."""
  tokens = [_OnCard(r, v, 2, top_k, seed=9, cluster=s)[0]
            for s in (1, 2, 3, 8, 16)]
  tokens.append(_OnCard(r, v, 2, top_k, seed=9)[0])
  assert all(torch.equal(t, tokens[0]) for t in tokens)


@pytest.mark.cuda
def test_kernel_edges_on_card(cuda):
  # a row shorter than the block, a vocabulary that is no multiple of 256,
  # top-1 (only the maximum is live)
  _OnCard(3, 100, 2, 0, seed=1)
  _OnCard(5, 32001, 1, 1, seed=2)
  _OnCard(1, 1, 2, 0, seed=3)
  # the threshold's edges (ties at the k-th value, +0.0 / -0.0 at it, -inf
  # logits, k = 1 and V - 1, top_k >= V), at V = 64 and with the edge rows
  # spread over a 32000-wide row split over a cluster
  edges = _EdgeLogits()
  for k in _EDGE_K:
    _OnCard(6, 64, 2, k, x=edges, seed=k)
  wide = torch.full((6, 32000), -30.0)
  wide[:, 100:32000:499] = torch.as_tensor(edges)   # 64 columns
  for k in (1, 5, 6, 8, 31999, 32000):
    for s in (None, 16):
      _OnCard(6, 32000, 2, k, x=wide, seed=k, cluster=s)
  # an index out of [0, R) draws nothing and gives -1
  x = torch.randn(4, 300, device="cuda")
  fold = torch.zeros(2, 1, dtype=torch.int32, device="cuda")
  rows = torch.tensor([1, 4], dtype=torch.int32, device="cuda")
  tokens = sample_tokens.SampleTokens(x, threefry.PRNGKey(0), fold, 1.0, 5,
                                      rows=rows)
  assert tokens.tolist()[1] == -1
  # greedy launches nothing
  before = sample_tokens.SampleTokens.launches
  sampling.SampleFromLogits(torch.randn(4, 50, device="cuda"))
  assert sample_tokens.SampleTokens.launches == before
