"""Int8 weight serving of lingvo_tpu_torch against JAX.

- `Int8QuantizeWeight` bitwise against the reference over 'dv' / 'vd',
  contract_ndim None / 1 / 2, per-tensor, and a weight with an all-zero
  channel; `Int8Einsum` bitwise against the jitted reference (XLA makes
  its `amax / 127.0` a product with float32(1 / 127); eager JAX divides,
  and a control shows the two apart) over batch dims, a two-axis
  contraction, a scalar scale and a row whose x / x_scale lands on .5.
  Weight scales are quantized eagerly in the reference, and compared
  against it eagerly.
- `Int8ServingTheta` on DenseLmTiny in both modes, leaf for leaf bitwise
  (the repeat stack's per-layer scales stacked against the reference's
  per-repeat ones), and `Int8ServingThetaFromArtifact` on a tree the
  reference made.
- Each int8 layer path against the reference's, tolerance 0 (the product
  is exact integer arithmetic and both sides scale it in the same float32
  order): the projection, the attention's heads and post projections,
  `EmbLookup`, `Logits` with the tanh cap; the fused-xent gate sends an
  int8 table down the dense path.
- Engine greedy streams with `serve_int8_weights=True`, ragged and legacy,
  float32 and int8 KV pools, equal to the reference engine's;
  `GShardDecode` continuations equal to the reference decoder's, the int8
  theta rebuilt only when the restored step changes.
- The float task computes what it did after an int8 engine was built on
  it; the served theta is seen only on the thread that activated it; the
  hybrid attention/SSM stack fails in the reference at its first int8 step
  and is refused at construction in the port.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lingvo_tpu.core import attention as jax_attention
from lingvo_tpu.core import layers as jax_layers
from lingvo_tpu.core import quant_utils as jax_quant
from lingvo_tpu.models.lm.params import synthetic_packed_input as jax_spi
from lingvo_tpu.quant import weights as jax_weights
from lingvo_tpu.runners import gshard_decode as jax_gshard
from lingvo_tpu.serving import engine as jax_engine
from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import attention
from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import checkpointer
from lingvo_tpu_torch.core import layers
from lingvo_tpu_torch.core import quant_utils
from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
from lingvo_tpu_torch.ops import int8_matmul
from lingvo_tpu_torch.quant import weights
from lingvo_tpu_torch.runners import gshard_decode
from lingvo_tpu_torch.serving import engine

from tests.conftest import InstantiateLm, TinyLmParams
from tests.test_torch_gshard_decode import (_LENS, _PROMPTS, _STEPS,
                                            _JaxTiny, _PortTiny,
                                            checkpoints)  # noqa: F401
from tests.test_torch_legacy_serving import (_ENGINE_KW, _Noised,
                                             _PortParams, _Prompts)


def _Rand(*shape, seed=0, scale=1.0):
  return (np.random.RandomState(seed).randn(*shape) * scale).astype(
      np.float32)


def _Np(t):
  return t.detach().cpu().numpy()


@pytest.mark.parametrize("layout, contract_ndim, shape, per_channel", [
    ("dv", None, (6, 5), True), ("dv", None, (4, 3, 5), True),
    ("dv", 1, (8, 3, 4), True), ("dv", 2, (4, 3, 5), True),
    ("vd", None, (7, 6), True), ("vd", 1, (5, 3, 8), True),
    ("vd", 2, (6, 3, 4), True), ("dv", None, (6, 5), False),
    ("vd", 2, (6, 3, 4), False)])
def test_quantize_weight_matches_reference(layout, contract_ndim, shape,
                                           per_channel):
  w = _Rand(*shape, seed=sum(shape), scale=0.7)
  # an all-zero output channel takes the 1e-8 floor and quantizes to 0
  if layout == "dv":
    w[..., 0] = 0.0
  else:
    w[0] = 0.0
  want_w8, want_s = jax_quant.Int8QuantizeWeight(
      jnp.asarray(w), per_channel, layout, contract_ndim)
  got_w8, got_s = quant_utils.Int8QuantizeWeight(
      torch.tensor(w), per_channel, layout, contract_ndim)
  assert got_w8.dtype == torch.int8 and got_s.dtype == torch.float32
  np.testing.assert_array_equal(_Np(got_w8), np.asarray(want_w8))
  np.testing.assert_array_equal(_Np(got_s), np.asarray(want_s))
  assert _Np(got_s).min() == np.float32(1e-8) or not per_channel


def _EinsumCase(case):
  """(x, w, per_channel, layout, contract_ndim) of one Int8Einsum case."""
  if case == "batch_dims":
    return _Rand(2, 3, 16, seed=1), _Rand(16, 12, seed=2), True, "dv", 1
  if case == "two_axes":
    return _Rand(2, 5, 3, 4, seed=3), _Rand(10, 3, 4, seed=4), True, "vd", 2
  if case == "scalar_scale":
    return _Rand(4, 16, seed=5), _Rand(16, 7, seed=6), False, "dv", None
  # amax 127 -> x_scale exactly 1: x / x_scale lands on .5 in a row
  x = _Rand(3, 16, seed=7)
  x[0, 0] = 127.0
  x[1, :6] = [2.5, 3.5, -2.5, -0.5, 0.5, 126.5]
  return x, _Rand(9, 16, seed=8), True, "vd", 1


@pytest.mark.parametrize("case", ["batch_dims", "two_axes", "scalar_scale",
                                  "half_way"])
def test_int8_einsum_matches_reference(case):
  x, w, per_channel, layout, k = _EinsumCase(case)
  w8, s = jax_quant.Int8QuantizeWeight(jnp.asarray(w), per_channel, layout,
                                       k)
  want = jax.jit(jax_quant.Int8Einsum, static_argnums=(3, 4))(
      jnp.asarray(x), w8, s, layout, k)
  got = quant_utils.Int8Einsum(torch.tensor(x), torch.tensor(np.asarray(w8)),
                               torch.tensor(np.asarray(s)), layout, k)
  np.testing.assert_array_equal(_Np(got), np.asarray(want))
  leaf = quant_utils.Int8Weight(torch.tensor(np.asarray(w8)),
                                torch.tensor(np.asarray(s)), layout, k)
  np.testing.assert_array_equal(_Np(leaf.Einsum(torch.tensor(x))),
                                np.asarray(want))
  np.testing.assert_array_equal(_Np(leaf.w_int8), np.asarray(w8))
  np.testing.assert_array_equal(
      _Np(leaf.Dequant()),
      np.asarray(jax_quant.Int8Weight(w8, s, layout, k).Dequant()))
  if case == "half_way":
    x8, x_scale = int8_matmul.QuantizeActivations(
        torch.tensor(x).reshape(-1, 16))
    assert x_scale.item() == 1.0
    assert x8[1, :6].tolist() == [2, 4, -2, 0, 0, 126]


def test_activation_scales_follow_the_jitted_reference():
  """200 calls of Int8Einsum on random activations: the port's outputs
  equal the jitted reference's bit for bit (its activation scale is
  amax * float32(1 / 127), the product XLA makes of `amax / 127.0`); the
  control: eager JAX's true division changes the output of some calls."""
  w = _Rand(16, 12, seed=11)
  w8, s = jax_quant.Int8QuantizeWeight(jnp.asarray(w), True, "dv", 1)
  leaf = quant_utils.Int8Weight(torch.tensor(np.asarray(w8)),
                                torch.tensor(np.asarray(s)), "dv", 1)
  jitted = jax.jit(jax_quant.Int8Einsum, static_argnums=(3, 4))
  eager_differs = 0
  for seed in range(200):
    x = _Rand(4, 16, seed=100 + seed, scale=3.0)
    want = np.asarray(jitted(jnp.asarray(x), w8, s, "dv", 1))
    np.testing.assert_array_equal(_Np(leaf.Einsum(torch.tensor(x))), want)
    eager = np.asarray(jax_quant.Int8Einsum(jnp.asarray(x), w8, s, "dv", 1))
    eager_differs += not np.array_equal(eager, want)
  assert eager_differs > 0


def test_int8_weight_keeps_one_k_major_copy():
  w = torch.tensor(_Rand(8, 4, 6, seed=9))
  leaf = quant_utils.Int8Weight.Quantize(w, "dv", 1)
  assert leaf.w_nk.shape == (24, 8) and leaf.w_nk.is_contiguous()
  assert leaf.w_int8.shape == (8, 4, 6)
  assert leaf.w_int8.untyped_storage().data_ptr() == (
      leaf.w_nk.untyped_storage().data_ptr())
  vd = quant_utils.Int8Weight.Quantize(w, "vd", 2)
  assert vd.w_nk.shape == (8, 24)
  assert vd.w_int8.data_ptr() == vd.w_nk.data_ptr()


@pytest.fixture(scope="module")
def dense_lm_tiny():
  """DenseLmTiny: the reference task with a noised theta, the port's
  carrying the same theta."""
  task, theta = InstantiateLm(jax_spi.DenseLmTiny().Task(), seed=5)
  theta = _Noised(theta, seed=2, scale=0.3)
  lm = spi.DenseLmTiny().Task().Instantiate(device="cpu")
  convert.LoadJaxTheta(lm, theta)
  return task, theta, lm


def _Leaves(leaf, mode):
  """A port leaf of a rewritten theta as numpy: (w_int8, scale) of an
  Int8Weight, float arrays in dequant mode; a StackedLeaf's members
  stacked on a leading axis."""
  members = (leaf.layers if isinstance(leaf, base_layer.StackedLeaf)
             else [leaf])
  if mode == "dequant":
    out = [np.stack([_Np(m) for m in members])]
  else:
    assert all(isinstance(m, quant_utils.Int8Weight) for m in members)
    out = [np.stack([_Np(m.w_int8) for m in members]),
           np.stack([_Np(m.scale) for m in members])]
  return [a if isinstance(leaf, base_layer.StackedLeaf) else a[0]
          for a in out]


def _CheckTheta(got, want, got_paths, want_paths, mode):
  assert sorted(got_paths) == sorted(want_paths)
  assert any(weights.IsStackedPath(p) for p in got_paths)
  for path in want_paths:
    ref = want.Get(path)
    ref_arrays = ([np.asarray(ref)] if mode == "dequant"
                  else [np.asarray(ref.w_int8), np.asarray(ref.scale)])
    for a, b in zip(_Leaves(got.Get(path), mode), ref_arrays):
      assert a.shape == b.shape, path
      np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("mode", ["int8", "dequant"])
def test_serving_theta_matches_reference(dense_lm_tiny, mode):
  _, theta, lm = dense_lm_tiny
  want, want_paths = jax_weights.Int8ServingTheta(
      jax.tree_util.tree_map(jnp.asarray, theta), mode=mode)
  got, got_paths = weights.Int8ServingTheta(lm.ThetaTree(), mode=mode)
  _CheckTheta(got, want, got_paths, want_paths, mode)
  # the leaves it does not rewrite are the module's own parameters
  own = dict(lm.ThetaTree().FlattenItems())
  members = lambda x: getattr(x, "layers", (x,))
  for path, leaf in got.FlattenItems():
    if path not in got_paths:
      assert all(a is b for a, b in zip(members(leaf), members(own[path]))
                 ), path
  stacked = got.Get("stack.body.fflayer.ffn_in.w")
  if mode == "int8":
    assert stacked.shape == (2, 64, 128)
    assert [m.scale.shape for m in stacked.layers] == [(1, 128)] * 2
    assert weights.WeightLayoutFor("w_post") == ("vd", 2)
    assert weights.WeightLayoutFor("wi") == ("dv", None)


@pytest.mark.parametrize("mode", ["int8", "dequant"])
def test_serving_theta_from_artifact(dense_lm_tiny, mode):
  """The reference's exported pairs (a stacked path's with their repeat
  axis) onto the port's frozen theta."""
  _, theta, _ = dense_lm_tiny
  jtheta = jax.tree_util.tree_map(jnp.asarray, theta)
  frozen, _ = jax_weights.Int8ServingTheta(jtheta, mode="dequant")
  rewritten, paths = jax_weights.Int8ServingTheta(jtheta)
  tree = {p: {"w_int8": np.asarray(rewritten.Get(p).w_int8),
              "scale": np.asarray(rewritten.Get(p).scale)} for p in paths}
  tree["stack.body.fflayer.ffn_in.b"] = {"w_int8": np.zeros(1, np.int8),
                                         "scale": np.ones(1, np.float32)}
  want, want_paths = jax_weights.Int8ServingThetaFromArtifact(
      frozen, tree, mode=mode)
  lm = spi.DenseLmTiny().Task().Instantiate(device="cpu")
  convert.LoadJaxTheta(lm, jax.tree_util.tree_map(np.asarray, frozen))
  got, got_paths = weights.Int8ServingThetaFromArtifact(lm.ThetaTree(), tree,
                                                        mode=mode)
  _CheckTheta(got, want, got_paths, want_paths, mode)


# -- the layer paths -------------------------------------------------------------


def _JaxLayer(p):
  layer = p.Instantiate()
  layer.FinalizePaths()
  return layer, _Noised(layer.InstantiateVariables(jax.random.PRNGKey(0)),
                        seed=3, scale=0.2)


def _PortLayer(p, theta_np):
  layer = p.Instantiate(device="cpu")
  convert.LoadJaxTheta(layer, theta_np)
  return layer


def _Int8Both(layer_j, theta_np, layer_t):
  """(the reference's int8 theta, the port's ServedTheta over layer_t)."""
  jt, _ = jax_weights.Int8ServingTheta(
      jax.tree_util.tree_map(jnp.asarray, theta_np))
  tt, _ = weights.Int8ServingTheta(layer_t.ThetaTree())
  return jt, base_layer.ServedTheta(layer_t, tt)


def test_projection_int8_path_matches_reference():
  kw = dict(name="proj", input_dim=24, output_dim=40, activation="RELU")
  lj, th = _JaxLayer(jax_layers.ProjectionLayer.Params().Set(**kw))
  lt = _PortLayer(layers.ProjectionLayer.Params().Set(**kw), th)
  jt, served = _Int8Both(lj, th, lt)
  assert isinstance(jt.w, jax_quant.Int8Weight)
  x = _Rand(3, 5, 24, seed=11)
  want = np.asarray(lj.FProp(jt, jnp.asarray(x)))
  with served.Active():
    got = _Np(lt.FProp(torch.tensor(x)))
  np.testing.assert_array_equal(got, want)
  float_out = _Np(lt.FProp(torch.tensor(x)))   # outside: the float weight
  assert np.abs(float_out - got).max() > 0


def test_attention_projections_int8_path_match_reference():
  kw = dict(name="atten", input_dim=32, hidden_dim=32, num_heads=4)
  lj, th = _JaxLayer(jax_attention.MultiHeadedAttention.Params().Set(**kw))
  lt = _PortLayer(attention.MultiHeadedAttention.Params().Set(**kw), th)
  jt, served = _Int8Both(lj, th, lt)
  x = _Rand(2, 6, 32, seed=12)
  ctx = _Rand(2, 6, 4, 8, seed=13)
  with served.Active():
    for name in ("query", "key", "value"):
      np.testing.assert_array_equal(
          _Np(lt._HeadsProj(name, torch.tensor(x))),
          np.asarray(lj._HeadsProj(jt, name, jnp.asarray(x))), err_msg=name)
    np.testing.assert_array_equal(
        _Np(lt._PostProj(torch.tensor(ctx))),
        np.asarray(lj._PostProj(jt, jnp.asarray(ctx))))


def _Emb(xent_block_size=0, cap=30.0):
  kw = dict(name="emb", vocab_size=96, embedding_dim=32, logits_soft_max=cap,
            xent_block_size=xent_block_size)
  lj, th = _JaxLayer(jax_layers.SharedEmbeddingSoftmaxLayer.Params().Set(
      **kw))
  th = jax.tree_util.tree_map(lambda a: a * 10.0, th)   # logits reach the cap
  lt = _PortLayer(layers.SharedEmbeddingSoftmaxLayer.Params().Set(**kw), th)
  return lj, th, lt


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_embedding_int8_paths_match_reference(cap):
  """Bitwise without the cap. With it, 1e-5: the int8 logits are bitwise
  equal, and the float32 tanh and division of the cap round differently
  in XLA and torch (a few ulps at |logit| ~ 30)."""
  lj, th, lt = _Emb(cap=cap)
  jt, served = _Int8Both(lj, th, lt)
  ids = np.random.RandomState(14).randint(0, 96, size=(3, 7)).astype(np.int32)
  x = _Rand(3, 7, 32, seed=15, scale=3.0)
  with served.Active():
    got_rows = _Np(lt.EmbLookup(torch.tensor(ids)))
    got_logits = _Np(lt.Logits(torch.tensor(x)))
  np.testing.assert_array_equal(
      got_rows, np.asarray(lj.EmbLookup(jt, jnp.asarray(ids))))
  want_logits = np.asarray(lj.Logits(jt, jnp.asarray(x)))
  if cap == 0:
    np.testing.assert_array_equal(got_logits, want_logits)
  else:
    assert np.abs(want_logits).max() > 20   # the cap bends them
    np.testing.assert_allclose(got_logits, want_logits, rtol=0, atol=1e-5)


def test_int8_table_takes_the_dense_xent_path():
  lj, th, lt = _Emb(xent_block_size=32)
  jt, served = _Int8Both(lj, th, lt)
  x = _Rand(2, 5, 32, seed=16)
  ids = np.random.RandomState(17).randint(0, 96, size=(2, 5)).astype(np.int32)
  want = lj.FProp(jt, jnp.asarray(x), class_ids=jnp.asarray(ids))
  with served.Active():
    got = lt.FProp(torch.tensor(x), class_ids=torch.tensor(ids))
  assert got.logits is not None and want.logits is not None
  # 1e-5: the cap's float32 tanh and division (see the test above)
  np.testing.assert_allclose(_Np(got.logits), np.asarray(want.logits),
                             rtol=0, atol=1e-5)
  np.testing.assert_allclose(_Np(got.per_example_xent),
                             np.asarray(want.per_example_xent), atol=1e-5)
  assert lt.FProp(torch.tensor(x), class_ids=torch.tensor(ids)).logits is None


def test_served_theta_is_seen_only_on_its_thread_and_casts_its_scale():
  p = layers.ProjectionLayer.Params().Set(name="proj", input_dim=8,
                                          output_dim=4)
  lt = p.Instantiate(device="cpu")
  lt.InstantiateVariables(torch.Generator("cpu").manual_seed(0))
  theta, _ = weights.Int8ServingTheta(lt.ThetaTree())
  served = base_layer.ServedTheta(lt, theta)
  seen = {}
  with served.Active():
    assert isinstance(lt.CastTheta().w, quant_utils.Int8Weight)
    th = threading.Thread(target=lambda: seen.update(w=lt.CastTheta().w))
    th.start()
    th.join(timeout=30)
  assert not th.is_alive() and seen["w"] is lt.w
  assert lt.CastTheta().w is lt.w
  bf = p.Copy().Set(fprop_dtype=torch.bfloat16).Instantiate(device="cpu")
  served16 = base_layer.ServedTheta(bf, theta)
  with served16.Active():
    w = bf.CastTheta().w
  assert w.scale.dtype == torch.bfloat16
  assert w.w_nk is theta.w.w_nk and w.w_nk.dtype == torch.int8


# -- the engine and the decoder ------------------------------------------------------


_COUNTS = ("steps", "decode_steps", "mixed_steps", "tokens_emitted",
           "prompt_tokens", "quantized_steps")


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
@pytest.mark.parametrize("step_mode", ["ragged", "legacy"])
def test_int8_engine_streams_match_reference(dense_lm_tiny, step_mode,
                                             kv_cache_dtype):
  task, theta, lm = dense_lm_tiny
  prompts, lens = _Prompts(task.p.vocab_size)
  kw = dict(_ENGINE_KW, step_mode=step_mode, kv_cache_dtype=kv_cache_dtype,
            serve_int8_weights=True)
  j_eng = jax_engine.ServingLoop(task, theta, trace=False, **kw)
  want = j_eng.RunBatch(prompts, lens, max_new_tokens=8)
  eng = engine.ServingLoop(lm, device="cpu", **kw)
  got = eng.RunBatch(prompts, lens, max_new_tokens=8)
  np.testing.assert_array_equal(got, want)
  stats, j_stats = eng.Stats(), j_eng.Stats()
  for key in _COUNTS + ("serve_int8_weights", "kv_cache_dtype",
                        "kv_bytes_per_token"):
    assert stats[key] == j_stats[key], key
  assert stats["serve_int8_weights"] is True
  # the int8 weights change the streams: they are not the float ones
  float_out = engine.ServingLoop(lm, device="cpu", step_mode=step_mode,
                                 kv_cache_dtype=kv_cache_dtype,
                                 **_ENGINE_KW).RunBatch(prompts, lens,
                                                        max_new_tokens=8)
  assert (float_out != got).any()


def test_float_task_unchanged_by_an_int8_engine(dense_lm_tiny):
  """The int8 rewrite belongs to the engine: the task's parameters, a
  float engine built later and the training loss are what they were."""
  task, theta, _ = dense_lm_tiny
  lm = spi.DenseLmTiny().Task().Instantiate(device="cpu")
  convert.LoadJaxTheta(lm, theta)
  prompts, lens = _Prompts(task.p.vocab_size)
  inputs = spi.DenseLmTiny().Train().Set(batch_size=2).Instantiate(
  ).GetPreprocessedInputBatch().Transform(torch.as_tensor)
  before_params = {k: v.clone() for k, v in lm.state_dict().items()}
  before = engine.ServingLoop(lm, device="cpu", **_ENGINE_KW).RunBatch(
      prompts, lens, max_new_tokens=6)
  with torch.no_grad():
    loss = lm.FProp(inputs)[0].loss[0]
  int8 = engine.ServingLoop(lm, device="cpu", serve_int8_weights=True,
                            **_ENGINE_KW)
  int8.RunBatch(prompts, lens, max_new_tokens=6)
  after = engine.ServingLoop(lm, device="cpu", **_ENGINE_KW).RunBatch(
      prompts, lens, max_new_tokens=6)
  np.testing.assert_array_equal(after, before)
  with torch.no_grad():
    assert torch.equal(lm.FProp(inputs)[0].loss[0], loss)
  for k, v in lm.state_dict().items():
    assert torch.equal(v, before_params[k]), k
  assert all(isinstance(p, torch.nn.Parameter) for p in lm.parameters())


def test_gshard_decode_int8_matches_reference(checkpoints, tmp_path):
  root, port_dir, _ = checkpoints
  want = jax_gshard.GShardDecode(
      _JaxTiny(4), str(root / "jax"), str(tmp_path / "jax8.jsonl"),
      max_decode_steps=_STEPS, prefill_chunk_size=3,
      serve_int8_weights=True).DecodeOnce(1, _PROMPTS, _LENS)
  lm = _PortTiny(4)
  decoder = gshard_decode.GShardDecode(
      lm, port_dir, str(tmp_path / "port8.jsonl"), max_decode_steps=_STEPS,
      prefill_chunk_size=3, serve_int8_weights=True)
  got = decoder.DecodeOnce(1, _PROMPTS, _LENS)
  assert [r["output_ids"] for r in got] == [r["output_ids"] for r in want]
  tel = got[0]["telemetry"]
  assert tel["serve_int8_weights"] is True
  assert tel["serve_int8_weights"] == want[0]["telemetry"]["serve_int8_weights"]
  # the int8 theta is built once per restored step
  cached = decoder._served
  assert cached[0] == 1
  decoder.DecodeOnce(1, _PROMPTS, _LENS)
  assert decoder._served is cached
  ckpt = checkpointer.Checkpointer(port_dir)
  lm2 = _PortTiny(4, seed=11)
  ckpt.Save(2, lm2, force=True)
  again = decoder.DecodeOnce(2, _PROMPTS, _LENS)
  assert decoder._served is not cached and decoder._served[0] == 2
  fresh = gshard_decode.GShardDecode(
      _PortTiny(4), port_dir, str(tmp_path / "fresh.jsonl"),
      max_decode_steps=_STEPS, prefill_chunk_size=3,
      serve_int8_weights=True).DecodeOnce(2, _PROMPTS, _LENS)
  assert [r["output_ids"] for r in again] == [r["output_ids"] for r in fresh]


def test_hybrid_int8_fails_in_reference_and_is_refused_in_port(tmp_path):
  """The SSM mixer's w_post is a serving-eligible leaf name that its
  einsum cannot take as an Int8Weight: the reference rewrites it and
  fails at the first step; the port refuses at construction."""
  task, theta = InstantiateLm(TinyLmParams(every_n=2), seed=3)
  prompts, lens = _Prompts(task.p.vocab_size)
  _, paths = jax_weights.Int8ServingTheta(theta)
  assert any(p.endswith("mixer.w_post") or ".w_post" in p for p in paths)
  j_eng = jax_engine.ServingLoop(task, theta, trace=False,
                                 serve_int8_weights=True, **_ENGINE_KW)
  with pytest.raises(Exception):
    j_eng.RunBatch(prompts, lens, max_new_tokens=2)
  lm = _PortParams(task.p).Instantiate(device="cpu")
  convert.LoadJaxTheta(lm, theta)
  with pytest.raises(NotImplementedError, match="GatedSSMLayer"):
    engine.ServingLoop(lm, device="cpu", serve_int8_weights=True,
                       **_ENGINE_KW)
  with pytest.raises(NotImplementedError, match="GatedSSMLayer"):
    gshard_decode.GShardDecode(lm, str(tmp_path), "x.jsonl",
                               serve_int8_weights=True)
  # float serving of the hybrid is untouched
  engine.ServingLoop(lm, device="cpu", **_ENGINE_KW).RunBatch(
      prompts, lens, max_new_tokens=2)
