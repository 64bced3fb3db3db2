"""Quantized KV storage of lingvo_tpu_torch (quant/kv.py and the attention steps) against JAX.

- `QuantizeKv` gives the int8 values and float32 scales of the reference
  as its jitted serving programs compute them, bit for bit: random rows,
  all-zero rows (the 1e-8 scale floor), exact half-steps (round half to
  even) and +-127 extremes; `DequantKv` too. Under jit XLA makes the
  reference's `amax / 127.0` a product with float32(1 / 127); eager JAX
  divides. Every bitwise comparison of scales here is against the jitted
  reference, with a control: the eager reference (true division) differs
  from it in at least one scale of the same data.
- `KvBytesPerToken` and the stack census (`StackKvCensus`,
  `MixerCensus`) equal the reference's on a repeat stack, a stack of
  distinct layers and an attention/SSM hybrid, for every pool dtype;
  an unknown dtype name raises ValueError, as in the reference.
- `MultiHeadedAttention`'s `PagedStep`, `RaggedStep`, `ExtendStep` and
  `Prefill` on int8 and bfloat16 storage: the pools, caches and scale
  sidecars equal the jitted reference's bit for bit after the steps (the
  pools'
  last page, the trash page that padding tokens write in an unspecified
  order, excepted), and the outputs are within 2e-5. The layer runs
  without rotary, on weights and inputs that are small multiples of
  1/16 and 1/8, so both frameworks project K and V exactly and the
  comparison sees only the storage path.
- Page reuse after eviction: a real allocator frees one sequence's int8
  pages and hands them to another, whose tokens overwrite the pages and
  their sidecars in place; the block-decode and ragged reads still equal
  the reference's and the float read of the dequantized pool.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lingvo_tpu.core import attention as jax_attention
from lingvo_tpu.core import ragged as jax_ragged
from lingvo_tpu.ops import block_decode as jax_block_decode
from lingvo_tpu.quant import kv as jax_kv
from lingvo_tpu.serving import spec_decode as jax_spec_decode
from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import attention
from lingvo_tpu_torch.core import jit_arith
from lingvo_tpu_torch.core import ragged
from lingvo_tpu_torch.ops import block_decode
from lingvo_tpu_torch.ops import ragged_block_attend
from lingvo_tpu_torch.quant import kv as kv_quant
from lingvo_tpu_torch.serving import engine
from lingvo_tpu_torch.serving import kv_cache
from lingvo_tpu_torch.serving import spec_decode

from tests.conftest import InstantiateLm, TinyLmParams
from tests.test_torch_legacy_serving import _PortParams

ATOL = 2e-5


def _Bits(x):
  """A float array's bits (bfloat16 widened exactly to float32 first), so
  equality is bitwise, NaN included."""
  if isinstance(x, torch.Tensor):
    x = x.float().numpy() if x.is_floating_point() else x.numpy()
  else:
    x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
  return x.view(np.int32) if x.dtype == np.float32 else x


def _Rows(case):
  rng = np.random.RandomState(0)
  if case == "random":
    return (rng.randn(5, 7, 4, 16) * rng.rand(5, 7, 4, 1) * 9).astype(
        np.float32)
  x = np.zeros((3, 4, 8), np.float32)
  if case == "zero_rows":
    x[0, 1:] = rng.randn(3, 8)
  elif case == "half_steps":
    # amax 127 makes the scale 1, so k + 0.5 sits exactly on a tie
    x[..., 0] = 127.0
    x[..., 1:] = (np.arange(-3, 4) + 0.5)[None, None]
  else:   # extremes
    x[..., 0] = -127.0
    x[..., 1] = 127.0
    x[..., 2:] = rng.randn(3, 4, 6) * 50
  return x


class TestQuantizeKv:

  @pytest.mark.parametrize("case", ["random", "zero_rows", "half_steps",
                                    "extremes"])
  def test_bitwise_equal_to_reference(self, case):
    x = _Rows(case)
    j_q, j_s = jax.jit(jax_kv.QuantizeKv)(jnp.asarray(x))
    t_q, t_s = kv_quant.QuantizeKv(torch.as_tensor(x))
    assert t_q.dtype == torch.int8 and t_s.dtype == torch.float32
    np.testing.assert_array_equal(t_q.numpy(), np.asarray(j_q))
    np.testing.assert_array_equal(_Bits(t_s), _Bits(j_s))
    np.testing.assert_array_equal(
        _Bits(kv_quant.DequantKv(t_q, t_s)),
        _Bits(jax_kv.DequantKv(j_q, j_s)))
    if case == "zero_rows":
      assert (t_q[1:].numpy() == 0).all() and np.allclose(t_s[1:], 1e-8)
    if case == "half_steps":   # ties to even: -2.5 -> -2, 3.5 -> 4
      np.testing.assert_array_equal(t_q[0, 0, 1:].numpy(),
                                    [-2, -2, 0, 0, 2, 2, 4])

  def test_scales_follow_the_jitted_reference(self):
    """On [256, 16, 128] rows the port's scales equal the jitted
    reference's; the control: eager JAX's true division differs from
    them in some scales, so the comparison tells the two apart."""
    x = (np.random.RandomState(5).randn(256, 16, 128) * 3).astype(np.float32)
    j_q, j_s = jax.jit(jax_kv.QuantizeKv)(jnp.asarray(x))
    t_q, t_s = kv_quant.QuantizeKv(torch.as_tensor(x))
    np.testing.assert_array_equal(_Bits(t_s), _Bits(j_s))
    np.testing.assert_array_equal(t_q.numpy(), np.asarray(j_q))
    _, e_s = jax_kv.QuantizeKv(jnp.asarray(x))
    assert (_Bits(e_s) != _Bits(j_s)).sum() > 0
    np.testing.assert_array_equal(
        _Bits(j_s), _Bits(np.maximum(
            np.abs(x).max(-1) * np.float32(jit_arith.INV_127),
            np.float32(1e-8))))

  @pytest.mark.parametrize("dtype", [None, "float32", "bfloat16", "int8"])
  @pytest.mark.parametrize("n, h", [(2, 16), (16, 128)])
  def test_kv_bytes_per_token(self, dtype, n, h):
    assert (kv_quant.KvBytesPerToken(n, h, dtype)
            == jax_kv.KvBytesPerToken(n, h, dtype, jnp.float32))

  def test_unknown_dtype_raises_value_error(self):
    with pytest.raises(ValueError, match="not in"):
      kv_quant.ResolveKvCacheDtype("fp8")
    layer = attention.MultiHeadedAttention.Params().Set(
        name="a", input_dim=8, num_heads=2, kv_cache_dtype="int4").Instantiate(
            device="cpu")
    with pytest.raises(ValueError, match="int4"):
      layer.InitPagedStates(3, 4)
    with pytest.raises(ValueError, match="int4"):
      layer.InitStates(1, 4)
    lm = _PortParams(TinyLmParams()).Instantiate(device="cpu")
    with pytest.raises(ValueError, match="fp8"):
      engine.ServingLoop(lm, page_size=8, num_pages=8, max_batch=2,
                         max_seq_len=16, device="cpu", kv_cache_dtype="fp8")


_STACKS = {"repeat": dict(use_repeat_layer=True),
           "stacked": dict(use_repeat_layer=False),
           "hybrid": dict(every_n=2)}


@pytest.fixture(scope="module")
def stacks():
  """{stack: (JAX task, the port's LM)} (the census reads no weights)."""
  out = {}
  for name, kw in _STACKS.items():
    task, _ = InstantiateLm(TinyLmParams(**kw))
    out[name] = (task, _PortParams(task.p).Instantiate(device="cpu"))
  return out


@pytest.mark.parametrize("dtype", [None, "bfloat16", "int8"])
@pytest.mark.parametrize("stack", sorted(_STACKS))
def test_stack_census_matches_reference(stack, dtype, stacks):
  """The page price, sidecars included, counts only attention layers."""
  task, lm = stacks[stack]
  want = jax_kv.StackKvCensus(task, dtype)
  assert kv_quant.StackKvCensus(lm, dtype) == want
  assert spec_decode.MixerCensus(lm) == jax_spec_decode.MixerCensus(task)
  per_layer = kv_quant.KvBytesPerToken(2, 16, dtype)
  assert want["kv_bytes_per_token"] == per_layer * want["attention_layers"]


# -- the attention layer's steps on quantized storage ------------------------


def _Dyadic(shape, rng, denom, top):
  return (rng.randint(-top, top + 1, size=shape) / denom).astype(np.float32)


def _Layers(dtype, decode_page_size=0, seed=0):
  """The reference's MultiHeadedAttention and the port's (N 2, H 16, no
  rotary), with one theta of multiples of 1/16 in [-1, 1]."""
  kw = dict(name="atten", input_dim=32, hidden_dim=32, num_heads=2,
            kv_cache_dtype=dtype, decode_page_size=decode_page_size)
  layer = jax_attention.MultiHeadedAttention.Params().Set(**kw).Instantiate()
  theta = layer.InstantiateVariables(jax.random.PRNGKey(seed))
  rng = np.random.RandomState(seed)
  theta = jax.tree_util.tree_map(
      lambda x: _Dyadic(np.shape(x), rng, 16, 16), theta)
  port = attention.MultiHeadedAttention.Params().Set(**kw).Instantiate(
      device="cpu")
  convert.LoadJaxTheta(port, theta)
  return layer, theta, port


def _AssertPoolsBitwise(j_states, t_states, trash_page=True):
  j_items = dict(j_states.FlattenItems())
  t_items = {k: v for k, v in t_states.FlattenItems()
             if isinstance(v, torch.Tensor)}
  # the same cache leaves (the port's time_step is a host int)
  assert sorted(t_items) == sorted(k for k in j_items if k != "time_step")
  for key, t_leaf in t_items.items():
    j_leaf = j_items[key]
    assert str(t_leaf.dtype).removeprefix("torch.") == str(j_leaf.dtype), key
    j_bits, t_bits = _Bits(j_leaf), _Bits(t_leaf)
    if trash_page:
      j_bits, t_bits = j_bits[:-1], t_bits[:-1]
    np.testing.assert_array_equal(t_bits, j_bits, err_msg=key)


def _AssertScalesTellJitFromEager(dtype, j_states, e_states):
  """The control of an int8 comparison: the eager reference's scale
  sidecars (true divisions) differ from the jitted reference's in at
  least one element, so matching the jitted ones is a real test."""
  if dtype != "int8":
    return
  j_items = dict(j_states.FlattenItems())
  e_items = dict(e_states.FlattenItems())
  differ = sum(int((_Bits(j_items[k]) != _Bits(e_items[k])).sum())
               for k in j_items if k.endswith("_scale"))
  assert differ > 0


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_paged_step_pools_bitwise(dtype):
  """A mixed [3, 5] step (prefill from 0, a row mid-prompt, an idle
  row), then a decode [3, 1] step over what it wrote (the block-decode
  read); pages of 4 slots."""
  layer, theta, port = _Layers(dtype)
  page, n_pages, b = 4, 16, 3
  rng = np.random.RandomState(1)
  tables = rng.permutation(n_pages)[:b * 4].reshape(b, 4).astype(np.int32)
  j_states = layer.InitPagedStates(theta, n_pages + 1, page,
                                   kv_cache_dtype=dtype)
  t_states = port.InitPagedStates(n_pages + 1, page, kv_cache_dtype=dtype)
  e_states = j_states
  assert ("key_scale" in t_states) == (dtype == "int8")
  step = jax.jit(layer.PagedStep)
  for c, q_pos, in_len in ((5, [0, 4, 0], [5, 3, 0]),
                           (1, [5, 7, 0], [1, 1, 0])):
    x = _Dyadic((b, c, 32), rng, 8, 8)
    args = [np.asarray(a, np.int32) for a in (tables, q_pos, in_len)]
    j_args = [jnp.asarray(a) for a in args]
    j_out, j_states = step(theta, jnp.asarray(x), j_states, *j_args)
    _, e_states = layer.PagedStep(theta, jnp.asarray(x), e_states, *j_args)
    t_out, t_states = port.PagedStep(torch.as_tensor(x), t_states,
                                     *(torch.as_tensor(a) for a in args))
    valid = np.arange(c)[None] < np.asarray(in_len)[:, None]
    np.testing.assert_allclose(t_out.numpy()[valid],
                               np.asarray(j_out)[valid], atol=ATOL)
    _AssertPoolsBitwise(j_states, t_states)
  _AssertScalesTellJitFromEager(dtype, j_states, e_states)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_ragged_step_pools_bitwise(dtype):
  """Two packed steps: prefill-heavy, then a pack that reads the pools
  the first one wrote (the ragged read); pages of 8 slots."""
  layer, theta, port = _Layers(dtype, seed=1)
  page, n_pages, b = 8, 16, 3
  rng = np.random.RandomState(2)
  tables = rng.permutation(n_pages)[:b * 4].reshape(b, 4).astype(np.int32)
  j_states = layer.InitPagedStates(theta, n_pages + 1, page,
                                   kv_cache_dtype=dtype)
  t_states = port.InitPagedStates(n_pages + 1, page, kv_cache_dtype=dtype)
  e_states = j_states
  step = jax.jit(layer.RaggedStep)
  for row_lens, q_pos in (([6, 9, 0], [0, 0, 1]), ([1, 4, 2], [6, 9, 0])):
    rows = jax_ragged.BuildRaggedRows(row_lens, q_pos, 16, 9)
    x = _Dyadic((1, 16, 32), rng, 8, 8)
    j_args = (jnp.asarray(tables),
              jax_ragged.RaggedRows(*(jnp.asarray(m) for m in rows)))
    j_out, j_states = step(theta, jnp.asarray(x), j_states, *j_args)
    _, e_states = layer.RaggedStep(theta, jnp.asarray(x), e_states, *j_args)
    t_out, t_states = port.RaggedStep(torch.as_tensor(x), t_states,
                                      torch.as_tensor(tables),
                                      ragged.ToTorch(rows, "cpu"))
    valid = np.asarray(rows.valid)
    np.testing.assert_allclose(t_out.numpy()[0, valid],
                               np.asarray(j_out)[0, valid], atol=ATOL)
    _AssertPoolsBitwise(j_states, t_states)
  _AssertScalesTellJitFromEager(dtype, j_states, e_states)


@pytest.mark.parametrize("page", [4, 0])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_prefill_and_extend_step_caches_bitwise(dtype, page):
  """A right-aligned batch (left pads) primed by two Prefill chunks, then
  three ExtendSteps, on the dense cache. With decode_page_size 4 a
  bfloat16 cache takes the flash-decode read and an int8 cache the dense
  read (as in the reference); 0 is the dense read for both. Queries at
  left-pad slots see no live slot and give garbage on both sides: their
  outputs are not compared."""
  layer, theta, port = _Layers(dtype, decode_page_size=page, seed=2)
  b, max_len = 3, 16
  rng = np.random.RandomState(3)
  pad = np.zeros((b, max_len), np.float32)
  pad[1, :2] = 1.0
  pad[2, :5] = 1.0
  j_states = layer.InitStates(theta, b, max_len)
  t_states = port.InitStates(b, max_len)
  e_states = j_states
  assert ("key_scale" in t_states) == (dtype == "int8")
  prefill, extend = jax.jit(layer.Prefill), jax.jit(layer.ExtendStep)
  for start, c in ((0, 3), (3, 4)):
    x = _Dyadic((b, c, 32), rng, 8, 8)
    j_out, j_states = prefill(theta, jnp.asarray(x), j_states,
                              paddings=jnp.asarray(pad))
    _, e_states = layer.Prefill(theta, jnp.asarray(x), e_states,
                                paddings=jnp.asarray(pad))
    t_out, t_states = port.Prefill(torch.as_tensor(x), t_states,
                                   paddings=torch.as_tensor(pad))
    live = pad[:, start:start + c] < 0.5
    np.testing.assert_allclose(t_out.numpy()[live], np.asarray(j_out)[live],
                               atol=ATOL)
  for _ in range(3):
    x = _Dyadic((b, 1, 32), rng, 8, 8)
    j_out, j_states = extend(theta, jnp.asarray(x), j_states,
                             paddings=jnp.asarray(pad))
    _, e_states = layer.ExtendStep(theta, jnp.asarray(x), e_states,
                                   paddings=jnp.asarray(pad))
    t_out, t_states = port.ExtendStep(torch.as_tensor(x), t_states,
                                      paddings=torch.as_tensor(pad))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL)
  assert t_states.time_step == int(j_states.time_step) == 10
  _AssertPoolsBitwise(j_states, t_states, trash_page=False)
  _AssertScalesTellJitFromEager(dtype, j_states, e_states)


def test_int8_pages_bitwise_after_reuse():
  """The eviction scenario of the reference's
  test_int8_twins_bitwise_after_page_reuse, through the port's allocator
  and reads."""
  rng = np.random.RandomState(4)
  n, h, page = 1, 8, 8
  q = rng.randn(2, 1, n, h).astype(np.float32)
  k8, ks = kv_quant.QuantizeKv(torch.as_tensor(
      rng.randn(4, page, n, h).astype(np.float32) * 2))
  v8, vs = kv_quant.QuantizeKv(torch.as_tensor(
      rng.randn(4, page, n, h).astype(np.float32) * 2))
  ks, vs = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
  tables = np.array([[0, 1], [2, 3]], np.int32)

  def _Reads(lens):
    t_ = torch.as_tensor
    port = block_decode.BlockDecode(
        t_(q), k8, v8, t_(tables), t_(lens), page_size=page, k_scale=ks,
        v_scale=vs).numpy()
    ref = np.asarray(jax_block_decode.BlockDecode(
        jnp.asarray(q), jnp.asarray(k8.numpy()), jnp.asarray(v8.numpy()),
        jnp.asarray(tables), jnp.asarray(lens), page_size=page,
        k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()),
        lowering="xla"))
    np.testing.assert_allclose(port, ref, atol=ATOL)
    rows = torch.arange(2, dtype=torch.int32)
    packed = ragged_block_attend.RaggedAttend(
        t_(q[:, 0]), k8, v8, t_(tables), rows, t_(lens), page_size=page,
        k_scale=ks, v_scale=vs).numpy()
    np.testing.assert_array_equal(packed, port[:, 0])
    return port

  before = _Reads(np.array([5, 16], np.int32))
  alloc = kv_cache.PageAllocator(num_pages=4, page_size=page)
  alloc.Allocate("a", 2)
  alloc.Allocate("b", 2)
  alloc.Free("a")
  reused = alloc.Allocate("c", 2)
  assert sorted(reused) == [0, 1]
  for pg in reused:   # quantize-on-write into the reused page, in place
    fk8, fks = kv_quant.QuantizeKv(torch.as_tensor(
        rng.randn(page, n, h).astype(np.float32) * 3))
    fv8, fvs = kv_quant.QuantizeKv(torch.as_tensor(
        rng.randn(page, n, h).astype(np.float32) * 3))
    k8[pg], v8[pg] = fk8, fv8
    ks[pg], vs[pg] = fks.T, fvs.T
  tables = np.array([reused, alloc.PagesOf("b")], np.int32)
  after = _Reads(np.array([12, 16], np.int32))
  assert not np.array_equal(before[0], after[0])
  flt = block_decode.BlockDecode(
      torch.as_tensor(q), ragged_block_attend._DequantPages(k8, ks),
      ragged_block_attend._DequantPages(v8, vs), torch.as_tensor(tables),
      torch.tensor([12, 16], dtype=torch.int32), page_size=page).numpy()
  np.testing.assert_array_equal(after, flt)
