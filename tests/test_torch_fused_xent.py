"""lingvo_tpu_torch fused blockwise xent against the JAX reference on the CPU.

- The plain `FusedXent` (the CPU path: `_PlainStats` forward,
  `_PlainCoreBwd` backward) against the JAX `FusedXent(lowering="xla")`,
  over cap {0, 30}, label smoothing {0, 0.1}, a block that divides V and
  one that leaves a ragged tail, and both weight layouts: all four
  outputs, and the gradients of x, w and b through a loss that gives each
  of xent, label_log_prob and lse its own cotangent. One case against the
  Pallas kernel run in interpret mode. Tolerance: float32, atol 2e-5
  (the frameworks sum in different orders).
- The first-occurrence argmax on exact ties, within a block and across
  blocks.
- The wrapper raises on float16 and bad shapes; the kernel is checked on
  the card by the `cuda`-marked cases, which skip here. The module imports
  JAX only inside `_Jax`, so on a machine with a card and no JAX the
  kernel cases run alone:

    python -m pytest tests/test_torch_fused_xent.py -m cuda
"""

import numpy as np
import pytest
import torch

from lingvo_tpu_torch.ops import fused_xent as fx

ATOL = 2e-5
LEAD, D, V = (3, 4), 16, 50


def _Jax():
  """(jax, jax.numpy, the reference fused_xent)."""
  import jax
  import jax.numpy as jnp
  from lingvo_tpu.ops import fused_xent as jax_fx
  return jax, jnp, jax_fx


def _Inputs(seed, layout):
  rng = np.random.RandomState(seed)
  x = rng.randn(*LEAD, D).astype(np.float32)
  w = rng.randn(V, D).astype(np.float32) * 0.7
  if layout == "dv":
    w = np.ascontiguousarray(w.T)
  b = rng.randn(V).astype(np.float32) * 0.1
  labels = rng.randint(0, V, LEAD).astype(np.int32)
  coefs = [rng.randn(*LEAD).astype(np.float32) for _ in range(3)]
  return x, w, b, labels, coefs


def _JaxRun(x, w, b, labels, coefs, **kw):
  jax, jnp, jax_fx = _Jax()
  def Loss(x, w, b):
    out = jax_fx.FusedXent(x, w, jnp.asarray(labels), bias=b, **kw)
    loss = sum(jnp.sum(c * o) for c, o in zip(
        coefs, (out.per_example_xent, out.label_log_prob, out.lse)))
    return loss, out
  (_, out), grads = jax.value_and_grad(Loss, argnums=(0, 1, 2), has_aux=True)(
      *map(jnp.asarray, (x, w, b)))
  return [np.asarray(o) for o in out], [np.asarray(g) for g in grads]


def _TorchRun(x, w, b, labels, coefs, **kw):
  leaves = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
  out = fx.FusedXent(leaves[0], leaves[1], torch.as_tensor(labels),
                     bias=leaves[2], **kw)
  loss = sum(torch.sum(torch.as_tensor(c) * o) for c, o in zip(
      coefs, (out.per_example_xent, out.label_log_prob, out.lse)))
  loss.backward()
  return [o.detach().numpy() for o in out], [a.grad.numpy() for a in leaves]


def _Compare(jax_res, torch_res):
  (out_j, grads_j), (out_t, grads_t) = jax_res, torch_res
  for oj, ot in zip(out_j[:3], out_t[:3]):
    np.testing.assert_allclose(ot, oj, atol=ATOL, rtol=0)
  np.testing.assert_array_equal(out_t[3], out_j[3])
  assert out_t[3].dtype == np.int32
  for gj, gt in zip(grads_j, grads_t):
    np.testing.assert_allclose(gt, gj, atol=ATOL, rtol=0)


@pytest.mark.parametrize("layout", ["vd", "dv"])
@pytest.mark.parametrize("block", [10, 16])    # divides V = 50, or not
@pytest.mark.parametrize("ls", [0.0, 0.1])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_plain_matches_reference(cap, ls, block, layout):
  args = _Inputs(0, layout)
  kw = dict(block_size=block, logits_soft_max=cap, label_smoothing=ls,
            weight_layout=layout)
  _Compare(_JaxRun(*args, lowering="xla", **kw), _TorchRun(*args, **kw))


def test_plain_matches_interpreted_pallas_kernel():
  args = _Inputs(1, "vd")
  kw = dict(block_size=16, logits_soft_max=3.0, label_smoothing=0.1)
  _Compare(_JaxRun(*args, lowering="pallas", interpret=True, **kw),
           _TorchRun(*args, **kw))


def test_argmax_takes_the_first_occurrence():
  """Rows whose max is attained twice: inside one block (columns 3 and 5)
  and across blocks (columns 7 and 23 with block 16); the smallest index
  wins, as in the reference."""
  x = np.eye(4, D, dtype=np.float32)[None]           # [1, 4, D]
  w = np.zeros((V, D), np.float32)
  w[[3, 5], 0] = 2.0
  w[[7, 23], 1] = 2.0
  w[[40, 41], 2] = 2.0
  labels = np.zeros((1, 4), np.int32)
  _, jnp, jax_fx = _Jax()
  out_j = jax_fx.FusedXent(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels),
                           block_size=16, lowering="xla")
  out_t = fx.FusedXent(torch.as_tensor(x), torch.as_tensor(w),
                       torch.as_tensor(labels), block_size=16)
  np.testing.assert_array_equal(out_t.argmax.numpy(), np.asarray(out_j.argmax))
  np.testing.assert_array_equal(out_t.argmax.numpy()[0, :3], [3, 7, 40])


def test_wrapper_raises_on_bf16_and_bad_shapes():
  """bfloat16 is taken since the bf16 slice; float16 and mixed dtypes
  still raise, as do bad shapes."""
  x, w, b = torch.zeros(4, D), torch.zeros(V, D), torch.zeros(V)
  labels = torch.zeros(4, dtype=torch.int32)
  with pytest.raises(TypeError, match="float32 or bfloat16 x"):
    fx.FusedXent(x.half(), w.half(), labels, block_size=16)
  with pytest.raises(TypeError, match="weight is torch.float32"):
    fx.FusedXent(x.bfloat16(), w, labels, block_size=16)
  assert fx.FusedXent(x.bfloat16(), w.bfloat16(), labels,
                      block_size=16).lse.dtype == torch.float32
  with pytest.raises(ValueError, match="do not match class_ids"):
    fx.FusedXent(x, w, labels[:3], block_size=16)
  with pytest.raises(ValueError, match="weight_layout"):
    fx.FusedXent(x, w, labels, block_size=16, weight_layout="x")
  cfg = fx._Cfg(block_size=16, vocab=V, vd=True, soft_cap=0.0,
                label_smoothing=0.0)
  with pytest.raises(ValueError, match="labels must be int32"):
    fx.FusedXentStats(x, w, b, labels.long(), cfg)
  with pytest.raises(ValueError, match="FusedXent shapes"):
    fx.FusedXentStats(x, w[:, :8], b, labels, cfg)


@pytest.mark.parametrize("xent_block_size", [0, 16])
def test_shared_embedding_fprop_matches_reference(xent_block_size):
  """The tied softmax layer's FProp, dense (0) and fused (16, a ragged tail
  of V = 50), with the tanh cap and label smoothing."""
  from lingvo_tpu.core import layers as jax_layers
  from lingvo_tpu_torch import convert
  from lingvo_tpu_torch.core import layers
  jax, jnp, _ = _Jax()
  fields = dict(name="emb", vocab_size=V, embedding_dim=D, logits_soft_max=3.0,
                xent_block_size=xent_block_size)
  jl = jax_layers.SharedEmbeddingSoftmaxLayer.Params().Set(
      **fields).Instantiate()
  theta = jax.tree_util.tree_map(
      np.asarray, jl.InstantiateVariables(jax.random.PRNGKey(0)))
  tl = layers.SharedEmbeddingSoftmaxLayer.Params().Set(**fields).Instantiate(
      device="cpu")
  convert.LoadJaxTheta(tl, theta)
  x, _, _, labels, _ = _Inputs(2, "vd")
  out_j = jl.FProp(theta, jnp.asarray(x), class_ids=jnp.asarray(labels),
                   label_smoothing=0.1)
  out_t = tl.FProp(torch.as_tensor(x), class_ids=torch.as_tensor(labels),
                   label_smoothing=0.1)
  assert sorted(out_t) == sorted(out_j)
  for k, v in out_j.items():
    if v is None:
      assert out_t[k] is None
    else:
      np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(v),
                                 atol=ATOL, rtol=1e-5)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: the fused-xent kernel is CUDA C++ with "
                "no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["vd", "dv"])
def test_kernel_matches_plain_on_card(cuda, layout):
  """Rows and vocab with ragged tails (200 rows, V 1000, block 384), both
  layouts, cap and label smoothing on."""
  rng = np.random.RandomState(5)
  m, d, vocab = 200, 96, 1000
  x = torch.as_tensor(rng.randn(m, d).astype(np.float32)).cuda()
  w = (rng.randn(vocab, d) / np.sqrt(d)).astype(np.float32)
  w = torch.as_tensor(w if layout == "vd" else np.ascontiguousarray(w.T))
  w = w.cuda()
  b = torch.as_tensor(rng.randn(vocab).astype(np.float32)).cuda()
  labels = torch.as_tensor(rng.randint(0, vocab, m).astype(np.int32)).cuda()
  cfg = fx._Cfg(block_size=384, vocab=vocab, vd=layout == "vd",
                soft_cap=5.0, label_smoothing=0.1)
  got = fx.FusedXentStats(x, w, b, labels, cfg)
  want = fx._PlainStats(x, w, b, labels, cfg)
  torch.cuda.synchronize()
  for a, e in zip(got[:3], want[:3]):
    assert float((a - e).abs().max()) <= 1e-4
  assert torch.equal(got[3], want[3])


def _Bf16Inputs(rng, m, d, vocab):
  """bf16 x, table and bias on the card (bias bf16: the reference makes
  its zero bias in the weight's dtype), int32 labels."""
  x = torch.as_tensor(rng.randn(m, d).astype(np.float32))
  w = torch.as_tensor((rng.randn(vocab, d) / np.sqrt(d)).astype(np.float32))
  b = torch.as_tensor(rng.randn(vocab).astype(np.float32) * 0.1)
  labels = torch.as_tensor(rng.randint(0, vocab, m).astype(np.int32))
  return [t.cuda() if t.dtype == torch.int32 else t.bfloat16().cuda()
          for t in (x, w, b)] + [labels.cuda()]


@pytest.mark.cuda
@pytest.mark.parametrize("cap, ls", [(0.0, 0.0), (5.0, 0.1)])
def test_bf16_kernel_matches_plain_on_card(cuda, cap, ls):
  """The bf16 instantiation: 200 rows (a ragged row tile), V 1000 (a
  ragged sub-tile), D 96 (a ragged stage). Every statistic is float32 and
  nothing rounds, so lse, the label logit and the logit sum agree within
  1e-4 (2e-3 for the sum over V): float32 sums of exact products in other
  orders; the argmax agrees except on logits within 1e-5 of each other."""
  m, d, vocab = 200, 96, 1000
  x, w, b, labels = _Bf16Inputs(np.random.RandomState(8), m, d, vocab)
  cfg = fx._Cfg(block_size=384, vocab=vocab, vd=True, soft_cap=cap,
                label_smoothing=ls)
  before = dict(fx.FusedXentStats.launches_by_dtype)
  got = fx.FusedXentStats(x, w, b, labels, cfg)
  want = fx._PlainStats(x, w, b, labels, cfg)
  torch.cuda.synchronize()
  assert fx.FusedXentStats.launches_by_dtype["bfloat16"] == (
      before["bfloat16"] + 1)
  for a, e, tol in zip(got[:3], want[:3], (1e-4, 1e-4, 2e-3)):
    if e is not None:
      assert float((a - e).abs().max()) <= tol
  differ = torch.nonzero(got[3] != want[3]).flatten()
  if len(differ):
    s = fx._BlockLogits(x[differ], w, b, cfg)
    rows = torch.arange(len(differ), device="cuda")
    gap = (s[rows, got[3][differ].long()] - s[rows, want[3][differ].long()])
    assert float(gap.abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("m, d, vocab", [(300, 200, 1003), (1100, 2048, 4001)])
def test_bf16_kernel_edges_on_card(cuda, m, d, vocab):
  """The bf16 kernel (wgmma fed by TMA, vocab splits) at shapes with more
  than one split and a vocabulary that is not a multiple of its 128-column
  tile: a partial row tile, D not a whole 64-wide stage (200) or several
  (2048); cap and label smoothing on. lse and label logit within 1e-4 and
  the logit sum within 2e-3 of `_PlainStats`, the argmax equal except on
  logits within 1e-5, two calls bitwise equal, one counted launch."""
  x, w, b, labels = _Bf16Inputs(np.random.RandomState(10), m, d, vocab)
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  per_sm = fx.KernelGeometry(torch.bfloat16)[2]
  assert fx.StatsGeometry(m, vocab, sms, per_sm)["splits"] > 1
  cfg = fx._Cfg(block_size=384, vocab=vocab, vd=True, soft_cap=5.0,
                label_smoothing=0.1)
  before = fx.FusedXentStats.launches_by_dtype["bfloat16"]
  got = fx.FusedXentStats(x, w, b, labels, cfg)
  again = fx.FusedXentStats(x, w, b, labels, cfg)
  want = fx._PlainStats(x, w, b, labels, cfg)
  torch.cuda.synchronize()
  assert fx.FusedXentStats.launches_by_dtype["bfloat16"] == before + 2
  for a, e, tol in zip(got[:3], want[:3], (1e-4, 1e-4, 2e-3)):
    assert float((a - e).abs().max()) <= tol
  for a, e in zip(got, again):
    assert torch.equal(a, e)
  differ = torch.nonzero(got[3] != want[3]).flatten()
  if len(differ):
    s = fx._BlockLogits(x[differ], w, b, cfg)
    rows = torch.arange(len(differ), device="cuda")
    gap = (s[rows, got[3][differ].long()] - s[rows, want[3][differ].long()])
    assert float(gap.abs().max()) <= 1e-5


# -- the kernels' grids (run here) ---------------------------------------------


@pytest.mark.parametrize("rows, vocab", [
    (8192, 32000), (8192 + 37, 32000), (300, 1003), (1100, 4001)])
def test_bf16_stats_geometry_splits_the_vocabulary(rows, vocab):
  """The bf16 kernel's grid at its one block an SM: consecutive runs of
  128-column tiles that cover the vocabulary once, none empty; at the
  main path's shape at least two waves."""
  geo = fx.StatsGeometry(rows, vocab, 132, 1)
  tps, splits = geo["tiles_per_split"], geo["splits"]
  assert (splits - 1) * tps < geo["col_tiles"] <= splits * tps
  assert geo["grid"] == (-(-rows // 128), splits)
  if rows >= 8192:
    assert geo["row_tiles"] * splits >= 2 * 132


@pytest.mark.parametrize("rows, vocab", [
    (8192, 32000), (8192 + 37, 32000), (200, 1000), (300, 1003), (16, 50),
    (1, 1), (5000, 129), (8192, 128 * 250 + 1)])
def test_stats_geometry_covers_every_row_and_column_once(rows, vocab):
  """The grid of `StatsGeometry`: row tiles cover every row once; the
  splits, in order, own consecutive runs of 128-column vocab tiles that
  cover every column once, none empty; the main path's shapes give at
  least two waves of 2 blocks on each of 132 SMs."""
  geo = fx.StatsGeometry(rows, vocab)
  tile, splits, tps = geo["tile"], geo["splits"], geo["tiles_per_split"]
  assert geo["grid"] == (geo["row_tiles"], splits)
  row_hits = np.zeros(rows, int)
  for rt in range(geo["row_tiles"]):
    row_hits[rt * tile:(rt + 1) * tile] += 1
  assert (row_hits == 1).all()
  col_hits = np.zeros(vocab, int)
  last_end = 0
  for s in range(splits):   # the kernel's split s: tiles [s tps, ...)
    t0 = s * tps
    t1 = min(t0 + tps, geo["col_tiles"])
    assert t1 > t0, f"split {s} owns no tile"
    assert t0 * tile == last_end, "splits out of order or with a gap"
    last_end = min(t1 * tile, vocab)
    col_hits[t0 * tile:t1 * tile] += 1
  assert last_end == vocab
  assert (col_hits == 1).all()
  if rows >= 8192:
    assert geo["row_tiles"] * splits >= 2 * 132 * 2


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["vd", "dv"])
@pytest.mark.parametrize("d, vocab", [(96, 1000), (98, 1003), (100, 130)])
def test_kernel_edges_on_card(cuda, layout, d, vocab):
  """The float32 kernel at edges the main path does not reach: a partial
  row tile (300 rows), D not a whole stage (96, 100) or not whole float4s
  (98: 4-byte copies), V not whole float4s (1003: the [D, V] layout's
  4-byte copies) and a last vocab tile of 2 columns (130); cap and label
  smoothing on. lse, label logit within 1e-4 and the logit sum within
  1e-3 of `_PlainStats`, the argmax equal, two calls bitwise equal."""
  rng = np.random.RandomState(9)
  m = 300
  x = torch.as_tensor(rng.randn(m, d).astype(np.float32)).cuda()
  w = (rng.randn(vocab, d) / np.sqrt(d)).astype(np.float32)
  w = torch.as_tensor(w if layout == "vd" else np.ascontiguousarray(w.T))
  w = w.cuda()
  b = torch.as_tensor(rng.randn(vocab).astype(np.float32)).cuda()
  labels = torch.as_tensor(rng.randint(0, vocab, m).astype(np.int32)).cuda()
  cfg = fx._Cfg(block_size=384, vocab=vocab, vd=layout == "vd",
                soft_cap=5.0, label_smoothing=0.1)
  got = fx.FusedXentStats(x, w, b, labels, cfg)
  again = fx.FusedXentStats(x, w, b, labels, cfg)
  want = fx._PlainStats(x, w, b, labels, cfg)
  torch.cuda.synchronize()
  for a, e, tol in zip(got[:3], want[:3], (1e-4, 1e-4, 1e-3)):
    assert float((a - e).abs().max()) <= tol
  assert torch.equal(got[3], want[3])
  for a, e in zip(got, again):
    assert torch.equal(a, e)
