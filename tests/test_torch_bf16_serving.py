"""Serving and batch decode at fprop_dtype=bfloat16 in lingvo_tpu_torch against the JAX reference, on the CPU.

- The paged kernels' plain versions (`RaggedAttend`, `BlockDecode`,
  `FlashDecode`, `BlockPrefill`) with a bfloat16 q over each pool or
  cache dtype against the reference's XLA twins on dyadic q and K: a
  bfloat16 output, bitwise equal to the reference's. Each plain version
  multiplies the widened q, so it also equals its own float32-q run on
  the widened q with the output rounded to bfloat16.
- `MultiHeadedAttention` `RaggedStep` / `PagedStep` / `ExtendStep` /
  `Prefill` at bfloat16 for each kv_cache_dtype (None, that is bfloat16
  pools and caches, 'float32' and 'int8') against the reference run op
  by op (`jax.disable_jit()`): the output's dtype is the reference's
  (float32 where a float32 or dequantized int8 cache meets bfloat16
  queries in the dense reads) and its values within a relative error
  norm of 1e-4 (they agree bit for bit but for float32 sums taken in
  another order); the same port layer at float32 activations is at least
  1e-3 off. A bfloat16 `Prefill` read trimmed to live_len equals the
  full read bit for bit.
- The whole LM, the engine and GShardDecode at bfloat16:
  tests/test_torch_bf16_serving_engine.py and test_torch_bf16_decode.py.
- A hybrid stack at bfloat16 (DenseLmSsmHybridTiny): its greedy streams
  in both step modes equal the JAX engine's; its SSM states stay float32.

The layers' reference runs op by op, where a bfloat16 value is rounded
wherever its program rounds it; the kernels' twins run as the reference
calls them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lingvo_tpu.core import attention as jax_attention
from lingvo_tpu.core import ragged as jax_ragged
from lingvo_tpu.models.lm.params import synthetic_packed_input as jax_spi
from lingvo_tpu.ops import block_decode as jax_bd
from lingvo_tpu.ops import flash_decode as jax_fd
from lingvo_tpu.ops import ragged_block_attend as jax_rba
from lingvo_tpu.serving import engine as jax_engine
from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import attention
from lingvo_tpu_torch.core import ragged
from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
from lingvo_tpu_torch.ops import block_decode
from lingvo_tpu_torch.ops import flash_decode
from lingvo_tpu_torch.ops import ragged_block_attend as rba
from lingvo_tpu_torch.quant import kv as kv_quant
from lingvo_tpu_torch.serving import engine

from tests.conftest import InstantiateLm
from tests.test_torch_legacy_serving import _ENGINE_KW, _Noised, _Prompts

BF16 = torch.bfloat16
POOLS = ["float32", "bfloat16", "int8"]


def _Dyadic(x, step):
  """x rounded to a multiple of the power of two `step`: q.k of such
  values is exact in float32 in any summation order."""
  return (np.round(x / step) * step).astype(np.float32)


def _Bits(x):
  """A bfloat16 tensor or array's bits, as int16."""
  if isinstance(x, torch.Tensor):
    return x.view(torch.int16).numpy()
  return np.asarray(x).view(np.int16)


def _F32(x):
  if isinstance(x, torch.Tensor):
    return x.detach().float().numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _RelNorm(got, want):
  got, want = _F32(got), _F32(want)
  return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- the kernels' plain versions against the reference twins -----------------


def _Pools(dtype, page=8, b=3, t_pages=4, n=2, h=16, seed=0):
  """(port pools and sidecars as kwargs, the reference's, the tables)."""
  rng = np.random.RandomState(seed)
  np_total = b * t_pages + 1
  k = _Dyadic(rng.randn(np_total, page, n, h), 1 / 8)
  v = rng.randn(np_total, page, n, h).astype(np.float32)
  tables = rng.permutation(np_total - 1).reshape(b, t_pages).astype(np.int32)
  kt, vt = torch.as_tensor(k), torch.as_tensor(v)
  if dtype == "int8":
    (k8, ks), (v8, vs) = kv_quant.QuantizeKv(kt), kv_quant.QuantizeKv(vt)
    ks, vs = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
    port = dict(k_pool=k8, v_pool=v8, k_scale=ks, v_scale=vs)
  else:
    dt = getattr(torch, dtype)
    port = dict(k_pool=kt.to(dt), v_pool=vt.to(dt))
  ref = {key: jnp.asarray(_F32(x)).astype(
      jnp.bfloat16 if x.dtype == BF16 else
      jnp.int8 if x.dtype == torch.int8 else jnp.float32)
         for key, x in port.items()}
  return port, ref, tables


def _Query(shape, seed=1):
  q = _Dyadic(np.random.RandomState(seed).randn(*shape) / 4, 1 / 32)
  return torch.as_tensor(q).to(BF16)


def _JaxQ(q):
  return jnp.asarray(q.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("pool", POOLS)
def test_plain_ragged_attend_bf16_q_matches_reference(pool):
  port, ref, tables = _Pools(pool)
  row_of = np.array([0, 1, 1, 1, 2, 2, 2, 0, 0], np.int32)
  q_end = np.array([17, 5, 6, 7, 12, 13, 14, 0, 0], np.int32)
  q = _Query((9, 2, 16))
  t_ = torch.as_tensor
  got = rba.RaggedAttend(
      q, port["k_pool"], port["v_pool"], t_(tables), t_(row_of), t_(q_end),
      page_size=8, k_scale=port.get("k_scale"), v_scale=port.get("v_scale"))
  want = jax_rba.RaggedAttend(
      _JaxQ(q), ref["k_pool"], ref["v_pool"], jnp.asarray(tables),
      jnp.asarray(row_of), jnp.asarray(q_end), page_size=8,
      k_scale=ref.get("k_scale"), v_scale=ref.get("v_scale"), lowering="xla")
  assert got.dtype == BF16 and want.dtype == jnp.bfloat16
  np.testing.assert_array_equal(_Bits(got), _Bits(want))
  wide = rba.RaggedAttend(
      q.float(), port["k_pool"], port["v_pool"], t_(tables), t_(row_of),
      t_(q_end), page_size=8, k_scale=port.get("k_scale"),
      v_scale=port.get("v_scale"))
  np.testing.assert_array_equal(_Bits(got), _Bits(wide.to(BF16)))
  assert bool((got[7:] == 0).all())


@pytest.mark.parametrize("pool", POOLS)
def test_plain_block_decode_and_prefill_bf16_q_match_reference(pool):
  port, ref, tables = _Pools(pool)
  t_ = torch.as_tensor
  lens = np.array([6, 0, 19], np.int32)
  q = _Query((3, 1, 2, 16))
  got = block_decode.BlockDecode(
      q, port["k_pool"], port["v_pool"], t_(tables), t_(lens), page_size=8,
      k_scale=port.get("k_scale"), v_scale=port.get("v_scale"))
  want = jax_bd.BlockDecode(
      _JaxQ(q), ref["k_pool"], ref["v_pool"], jnp.asarray(tables),
      jnp.asarray(lens), page_size=8, k_scale=ref.get("k_scale"),
      v_scale=ref.get("v_scale"), lowering="xla")
  assert got.dtype == BF16 and want.dtype == jnp.bfloat16
  np.testing.assert_array_equal(_Bits(got), _Bits(want))
  # the legacy mixed step's plain read
  c = 5
  qc = _Query((3, c, 2, 16), seed=2)
  q_pos = np.array([3, 0, 9], np.int32)
  in_len = np.array([5, 2, 1], np.int32)
  got = block_decode.BlockPrefill(
      qc, port["k_pool"], port["v_pool"], t_(tables), t_(q_pos), t_(in_len),
      page_size=8, k_scale=port.get("k_scale"), v_scale=port.get("v_scale"))
  want = jax_bd.BlockPrefill(
      _JaxQ(qc), ref["k_pool"], ref["v_pool"], jnp.asarray(tables),
      jnp.asarray(q_pos), jnp.asarray(in_len), page_size=8,
      k_scale=ref.get("k_scale"), v_scale=ref.get("v_scale"))
  assert got.dtype == BF16 and want.dtype == jnp.bfloat16
  np.testing.assert_array_equal(_Bits(got), _Bits(want))


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_plain_flash_decode_bf16_q_matches_reference(cache):
  rng = np.random.RandomState(4)
  b, s, n, h = 3, 16, 2, 16
  k = _Dyadic(rng.randn(b, s, n, h), 1 / 8)
  v = rng.randn(b, s, n, h).astype(np.float32)
  pad = np.zeros((b, s), np.float32)
  pad[1, :3] = 1.0
  pad[2, :] = 1.0                      # nothing live: exact zeros
  dt = getattr(torch, cache)
  kt, vt = torch.as_tensor(k).to(dt), torch.as_tensor(v).to(dt)
  q = _Query((b, 1, n, h), seed=5)
  for t in (5, 15):
    got = flash_decode.FlashDecode(q, kt, vt, t, page_size=4,
                                   cache_paddings=torch.as_tensor(pad))
    want = jax_fd.FlashDecode(
        _JaxQ(q), jnp.asarray(_F32(kt)).astype(getattr(jnp, cache)),
        jnp.asarray(_F32(vt)).astype(getattr(jnp, cache)),
        jnp.asarray(t, jnp.int32), page_size=4,
        cache_paddings=jnp.asarray(pad), lowering="xla")
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_Bits(got), _Bits(want))
    assert bool((got[2] == 0).all())


# -- the attention layer's serving steps, op by op ----------------------------


STEP_REL = 1e-4   # bfloat16 steps against the reference run op by op
# the same port layer at float32 activations misses it by at least this
CONTROL_REL = 1e-3


def _Layers(kv_dtype, decode_page_size=4, seed=0, fprop=BF16):
  """The reference's MultiHeadedAttention at fprop_dtype=bfloat16 and the
  port's at `fprop` (N 2, H 16), one seeded theta."""
  kw = dict(name="atten", input_dim=32, hidden_dim=32, num_heads=2,
            kv_cache_dtype=kv_dtype, decode_page_size=decode_page_size)
  layer = jax_attention.MultiHeadedAttention.Params().Set(
      fprop_dtype=jnp.bfloat16, **kw).Instantiate()
  theta = layer.InstantiateVariables(jax.random.PRNGKey(seed))
  rng = np.random.RandomState(seed)
  theta = jax.tree_util.tree_map(
      lambda x: jnp.asarray(0.5 * rng.randn(*np.shape(x)), jnp.float32),
      theta)
  port = attention.MultiHeadedAttention.Params().Set(
      fprop_dtype=fprop, **kw).Instantiate(device="cpu")
  convert.LoadJaxTheta(port, theta)
  return layer, theta, port


def _RunSteps(kv_dtype, fprop):
  """Every serving step of the layer on both sides, the reference op by
  op: [(step, port output, reference output)] at the rows that feed a
  real token."""
  layer, theta, port = _Layers(kv_dtype, fprop=fprop)
  rng = np.random.RandomState(1)
  t_, j_ = torch.as_tensor, jnp.asarray
  out = []
  n_pages, b = 16, 3
  tables = rng.permutation(n_pages)[:b * 4].reshape(b, 4).astype(np.int32)
  with jax.disable_jit():
    # two packed steps, pages of 8: the ragged read
    js = layer.InitPagedStates(theta, n_pages + 1, 8)
    ts = port.InitPagedStates(n_pages + 1, 8)
    for row_lens, q_pos in (([6, 9, 0], [0, 0, 1]), ([1, 4, 2], [6, 9, 0])):
      rows = jax_ragged.BuildRaggedRows(row_lens, q_pos, 16, 9)
      x = rng.randn(1, 16, 32).astype(np.float32)
      jo, js = layer.RaggedStep(
          theta, j_(x), js, j_(tables),
          jax_ragged.RaggedRows(*(j_(m) for m in rows)))
      to, ts = port.RaggedStep(t_(x), ts, t_(tables),
                               ragged.ToTorch(rows, "cpu"))
      valid = np.asarray(rows.valid)
      out.append(("RaggedStep", to[0][t_(valid)], jo[0][valid]))
    # a mixed [3, 5] step, then a decode [3, 1] one, pages of 4: the plain
    # BlockPrefill, then the block-decode read
    js = layer.InitPagedStates(theta, n_pages + 1, 4)
    ts = port.InitPagedStates(n_pages + 1, 4)
    for c, q_pos, in_len in ((5, [0, 4, 0], [5, 3, 0]),
                             (1, [5, 7, 0], [1, 1, 0])):
      x = rng.randn(b, c, 32).astype(np.float32)
      args = [np.asarray(a, np.int32) for a in (tables, q_pos, in_len)]
      jo, js = layer.PagedStep(theta, j_(x), js, *(j_(a) for a in args))
      to, ts = port.PagedStep(t_(x), ts, *(t_(a) for a in args))
      valid = np.arange(c)[None] < np.asarray(in_len)[:, None]
      out.append(("PagedStep", to[t_(valid)], jo[valid]))
    # right-aligned rows (left pads) primed by two Prefill chunks, then
    # three ExtendSteps (the flash-decode read of a float cache, the dense
    # read of an int8 one)
    pad = np.zeros((b, 16), np.float32)
    pad[1, :2] = 1.0
    pad[2, :5] = 1.0
    js = layer.InitStates(theta, b, 16)
    ts = port.InitStates(b, 16)
    for start, c in ((0, 3), (3, 4)):
      x = rng.randn(b, c, 32).astype(np.float32)
      jo, js = layer.Prefill(theta, j_(x), js, paddings=j_(pad))
      to, ts = port.Prefill(t_(x), ts, paddings=t_(pad))
      out.append(("Prefill", to, jo))
    for _ in range(3):
      x = rng.randn(b, 1, 32).astype(np.float32)
      jo, js = layer.ExtendStep(theta, j_(x), js, paddings=j_(pad))
      to, ts = port.ExtendStep(t_(x), ts, paddings=t_(pad))
      out.append(("ExtendStep", to, jo))
  return out


# the reference's output dtype of each step per cache dtype: a float32 or
# dequantized int8 cache read densely by bfloat16 queries gives float32
_OUT_DTYPES = {
    None: {},
    "float32": {"Prefill": "float32"},
    "int8": {"Prefill": "float32", "ExtendStep": "float32"},
}


@pytest.mark.parametrize("kv_dtype", [None, "float32", "int8"])
def test_attention_steps_match_reference_op_by_op(kv_dtype):
  """RaggedStep, PagedStep (mixed and decode), Prefill and ExtendStep at
  bfloat16 against the reference op by op: the reference's output dtype
  and values within STEP_REL; the port layer at float32 activations (the
  control) misses STEP_REL by 10x."""
  layer, _, port = _Layers(kv_dtype)
  want_pool = "bfloat16" if kv_dtype is None else kv_dtype
  assert port.KvCacheDtype() == layer.KvCacheDtype() == want_pool
  assert port.KvBytesPerToken() == layer.KvBytesPerToken()
  assert port.InitStates(1, 4).key.dtype == getattr(torch, want_pool)
  for (step, got, want), (_, ctl, _) in zip(_RunSteps(kv_dtype, BF16),
                                            _RunSteps(kv_dtype, None)):
    dtype = _OUT_DTYPES[kv_dtype].get(step, "bfloat16")
    assert str(want.dtype) == dtype, step
    assert str(got.dtype) == f"torch.{dtype}", step
    assert _RelNorm(got, want) <= STEP_REL, step
    assert _RelNorm(ctl, want) >= CONTROL_REL, step


@pytest.mark.parametrize("kv_dtype", [None, "float32", "int8"])
def test_bf16_prefill_trimmed_read_equals_full_read(kv_dtype):
  """A bfloat16 Prefill whose read stops at live_len gives the bits of
  the read over the whole cache (300 slots: three tiles, of which the
  trimmed read takes two), outputs and caches."""
  _, _, port = _Layers(kv_dtype, decode_page_size=0, seed=3)
  rng = np.random.RandomState(4)
  b, total = 2, 300
  pad = np.zeros((b, total), np.float32)
  pad[1, :70] = 1.0
  states = [port.InitStates(b, total) for _ in range(2)]
  for start, c in ((0, 130), (130, 70)):
    x = torch.as_tensor(rng.randn(b, c, 32).astype(np.float32))
    full, states[0] = port.Prefill(x, states[0], paddings=torch.as_tensor(pad))
    cut, states[1] = port.Prefill(x, states[1], paddings=torch.as_tensor(pad),
                                  live_len=start + c)
    # the left-pad queries of row 1 see no slot: their uniform read spans
    # [0, live), which the two reads draw differently, as the reference's
    real = torch.as_tensor(np.arange(start, start + c)[None] >= 70 *
                           np.arange(b)[:, None])
    assert torch.equal(full[real], cut[real])
  for key in ("key", "value"):
    assert torch.equal(states[0][key], states[1][key])


def test_hybrid_still_refuses_bf16_activations():
  """A hybrid stack takes bfloat16 activations since its mixer's were
  ported: DenseLmSsmHybridTiny at fprop_dtype=bfloat16 (noised theta,
  weights float32) serves greedy streams token for token the JAX
  engine's, in both step modes, with its step counters; its SSM slot
  states stay float32 (the KV pools bfloat16)."""
  task, theta = InstantiateLm(jax_spi.DenseLmSsmHybridTiny().Task().Set(
      fprop_dtype=jnp.bfloat16), seed=5)
  theta = _Noised(theta, seed=2, scale=0.3)
  lm = spi.DenseLmSsmHybridTiny().Task().Set(fprop_dtype=BF16).Instantiate(
      device="cpu")
  convert.LoadJaxTheta(lm, theta)
  prompts, lens = _Prompts(task.p.vocab_size)
  for mode in ("ragged", "legacy"):
    j_eng = jax_engine.ServingLoop(task, theta, trace=False, step_mode=mode,
                                   **_ENGINE_KW)
    want = j_eng.RunBatch(prompts, lens, max_new_tokens=8)
    eng = engine.ServingLoop(lm, device="cpu", step_mode=mode, **_ENGINE_KW)
    got = eng.RunBatch(prompts, lens, max_new_tokens=8)
    np.testing.assert_array_equal(got, want)
    assert len({tuple(r) for r in want}) > 1
    stats, j_stats = eng.Stats(), j_eng.Stats()
    for key in ("steps", "decode_steps", "mixed_steps", "tokens_emitted",
                "kv_cache_dtype", "kv_bytes_per_token"):
      assert stats[key] == j_stats[key], key
    dtypes = {k.rsplit(".", 1)[-1]: v.dtype
              for k, v in eng._states.FlattenItems()}
    assert dtypes["state"] == torch.float32
    assert dtypes["key"] == dtypes["value"] == BF16
