"""The SSM mixer, the hybrid stacks and their serving engine against JAX.

- `GatedSSMLayer.FProp` with paddings and segment ids, and its serving
  steps (`PagedStep` with C = 1 and C > 1, `RaggedStep` over slots with
  reuse (q_pos == 0) and 0-token rows), against the JAX layer with the
  same theta carried over by `convert.LoadJaxTheta` (float32, atol 2e-5 on
  outputs; states within atol/rtol 1e-4, since they accumulate over steps).
- The hybrid `TransformerLm.RaggedStep` logits and states against JAX on
  the conftest `TinyLmParams`: attention every 2nd layer flat and as a
  repeat of [ssm, attention] blocks, and the pure-SSM stack (atol/rtol
  1e-4, as the attention-only serving test).
- `convert.LoadJaxTheta` consumes every leaf of the repeat-of-Stacked
  hybrid theta exactly once.

The serving engine over these stacks is held against JAX in
tests/test_torch_ssm_serving.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lingvo_tpu.core import ragged as jax_ragged
from lingvo_tpu.core import ssm as jax_ssm
from lingvo_tpu.core.nested_map import NestedMap as JaxNestedMap
from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import ragged
from lingvo_tpu_torch.core import ssm
from lingvo_tpu_torch.models.lm import layers as lm_layers

from tests.conftest import InstantiateLm, TinyLmParams

ATOL = 2e-5
D, N, S, CHUNK = 16, 2, 4, 4


def _Noised(theta, seed=0, scale=0.5):
  """theta as numpy with seeded noise on every leaf: freshly initialized
  biases and norms are constants, which would leave paths untested, and a
  fresh model echoes one token per stream."""
  rng = np.random.RandomState(seed)
  return jax.tree_util.tree_map(
      lambda x: np.asarray(x) + scale * rng.randn(*x.shape).astype(np.float32),
      theta)


def _JaxRows(rows):
  return jax_ragged.RaggedRows(*(jnp.asarray(m) for m in rows))


# -- the layer -----------------------------------------------------------------


@pytest.fixture(scope="module")
def layers():
  """(JAX layer, its noised theta, the port's layer with that theta)."""
  p = jax_ssm.GatedSSMLayer.Params().Set(
      name="ssm", input_dim=D, hidden_dim=D, num_heads=N, state_dim=S,
      chunk_size=CHUNK)
  j_layer = p.Instantiate()
  theta = _Noised(j_layer.InstantiateVariables(jax.random.PRNGKey(0)), 1,
                  0.3)
  t_layer = ssm.GatedSSMLayer.Params().Set(
      name="ssm", input_dim=D, hidden_dim=D, num_heads=N, state_dim=S,
      chunk_size=CHUNK).Instantiate(device="cpu")
  loaded = convert.LoadJaxTheta(t_layer, theta)
  assert len(loaded) == len(theta.Flatten()) == 13
  return j_layer, theta, t_layer


def test_fprop_matches_reference(layers):
  j_layer, theta, t_layer = layers
  rng = np.random.RandomState(2)
  x = rng.randn(2, 11, D).astype(np.float32)
  paddings = np.zeros((2, 11), np.float32)
  paddings[1, 8:] = 1.0
  seg = np.ones((2, 11), np.int32)
  seg[0, 6:] = 2
  seg[1, 8:] = 0
  j_out, _ = j_layer.FProp(theta, jnp.asarray(x),
                           paddings=jnp.asarray(paddings),
                           segment_ids=jnp.asarray(seg), causal=True)
  with torch.no_grad():
    t_out, probs = t_layer.FProp(torch.as_tensor(x),
                                 paddings=torch.as_tensor(paddings),
                                 segment_ids=torch.as_tensor(seg),
                                 causal=True)
  assert probs is None
  np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL)
  assert not t_out[1, 8:].any()   # padded outputs are exact zeros


def _AssertStatesClose(j_states, t_states):
  j_items = dict(j_states.FlattenItems())
  t_items = dict(t_states.FlattenItems())
  assert sorted(j_items) == sorted(t_items)
  for key, j_leaf in j_items.items():
    j_leaf, t_leaf = np.asarray(j_leaf), t_items[key].numpy()
    assert j_leaf.shape == t_leaf.shape, key
    if "state" not in key:   # the last page of a KV pool is the trash page
      j_leaf, t_leaf = j_leaf[..., :-1, :, :, :], t_leaf[..., :-1, :, :, :]
    np.testing.assert_allclose(t_leaf, j_leaf, atol=1e-4, rtol=1e-4,
                               err_msg=key)


def test_ragged_step_matches_reference_with_slot_reuse(layers):
  """Three packed steps over 3 slots: two prefills (slot 2 idle at
  q_pos 1), then decode rows beside slot 2 starting a request (q_pos 0
  with a zero state), then slot 2 reused again (q_pos 0 over its live
  state) beside a 0-token live row at its true position."""
  j_layer, theta, t_layer = layers
  rng = np.random.RandomState(3)
  j_states = j_layer.InitPagedStates(theta, 9, 8, num_slots=3)
  t_states = t_layer.InitPagedStates(9, 8, num_slots=3)
  for lens, q_pos in (([6, 9, 0], [0, 0, 1]), ([1, 1, 4], [6, 9, 0]),
                      ([1, 0, 3], [7, 10, 0])):
    rows = jax_ragged.BuildRaggedRows(lens, q_pos, 16, 9)
    x = rng.randn(1, 16, D).astype(np.float32)
    j_out, j_states = jax.jit(j_layer.RaggedStep, static_argnums=3)(
        theta, jnp.asarray(x), j_states, None, _JaxRows(rows))
    t_out, returned = t_layer.RaggedStep(torch.as_tensor(x), t_states, None,
                                         ragged.ToTorch(rows, "cpu"))
    assert returned is t_states   # updated in place
    valid = np.asarray(rows.valid)
    np.testing.assert_allclose(t_out[0].numpy()[valid],
                               np.asarray(j_out)[0][valid], atol=ATOL)
    _AssertStatesClose(j_states, t_states)


@pytest.mark.parametrize("c_len", [1, 5])
def test_paged_step_matches_reference(layers, c_len):
  """PagedStep's two branches: SequentialStep for one column, the chunked
  scan for several (chunk min(4, c_len)); in_len masks the tail."""
  j_layer, theta, t_layer = layers
  rng = np.random.RandomState(4 + c_len)
  s0 = rng.randn(3, N, D // N, S).astype(np.float32)
  x = rng.randn(3, c_len, D).astype(np.float32)
  q_pos = np.array([0, 4, 9], np.int32)
  in_len = np.array([c_len, min(2, c_len), 0], np.int32)
  j_out, j_new = j_layer.PagedStep(
      theta, jnp.asarray(x), JaxNestedMap(state=jnp.asarray(s0)), None,
      jnp.asarray(q_pos), jnp.asarray(in_len))
  t_states = t_layer.InitPagedStates(1, 8, num_slots=3)
  t_states.state.copy_(torch.as_tensor(s0))
  t_out, _ = t_layer.PagedStep(torch.as_tensor(x), t_states, None,
                               torch.as_tensor(q_pos), torch.as_tensor(in_len))
  np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL)
  np.testing.assert_allclose(t_states.state.numpy(), np.asarray(j_new.state),
                             atol=1e-4, rtol=1e-4)
  # a row with no token this step keeps its state bitwise
  assert torch.equal(t_states.state[2], torch.as_tensor(s0[2]))


def test_unported_paths_raise(layers):
  _, _, t_layer = layers
  states = t_layer.InitPagedStates(1, 8, num_slots=2)
  x = torch.zeros((2, 3, D))
  pos = torch.zeros((2,), dtype=torch.int32)
  with pytest.raises(NotImplementedError, match="speculative-decoding"):
    t_layer.PagedStep(x, states, None, pos, pos, collect_col_states=True)
  with pytest.raises(ValueError, match="causal"):
    t_layer.FProp(x)
  assert t_layer.StateBytesPerSlot() == N * (D // N) * S * 4


# -- the hybrid stacks ---------------------------------------------------------


def _PortParams(jax_p):
  """The port's TransformerLm Params with the reference's model fields."""
  p = lm_layers.TransformerLm.Params().Set(
      name=jax_p.name, vocab_size=jax_p.vocab_size,
      model_dim=jax_p.model_dim, num_layers=jax_p.num_layers,
      num_heads=jax_p.num_heads, hidden_dim=jax_p.hidden_dim,
      use_rotary=jax_p.use_rotary, use_repeat_layer=jax_p.use_repeat_layer)
  if jax_p.mixer_tpl is not None:
    m = jax_p.mixer_tpl
    p.Set(mixer_atten_every_n=jax_p.mixer_atten_every_n,
          mixer_tpl=ssm.GatedSSMLayer.Params().Set(
              state_dim=m.state_dim, chunk_size=m.chunk_size))
  return p


_STACKS = {
    "flat": dict(every_n=2),
    "repeat": dict(every_n=2, use_repeat=True, num_layers=4),
    "pure_ssm": dict(every_n=0),
}


@pytest.fixture(scope="module")
def hybrids():
  """{stack: (JAX task, noised theta, the port's LM)} over _STACKS."""
  out = {}
  for name, kw in _STACKS.items():
    task, theta = InstantiateLm(TinyLmParams(**kw), seed=3)
    theta = _Noised(theta)
    lm = _PortParams(task.p).Instantiate(device="cpu")
    convert.LoadJaxTheta(lm, theta)
    out[name] = (task, theta, lm)
  return out


@pytest.mark.parametrize("stack", sorted(_STACKS))
def test_hybrid_ragged_step_matches_reference(stack, hybrids):
  """Three packed steps through the stack (prefills, decode rows beside a
  fresh request, slot reuse beside a 0-token row): logits and every KV
  pool and SSM slot state."""
  task, theta, lm = hybrids[stack]
  page, n_pages, b = 8, 16, 3
  rng = np.random.RandomState(0)
  tables = rng.permutation(n_pages)[:b * 4].reshape(b, 4).astype(np.int32)
  j_states = task.InitPagedDecodeState(theta, n_pages + 1, page, b)
  t_states = lm.InitPagedDecodeState(n_pages + 1, page, b)
  for lens, q_pos in (([6, 9, 0], [0, 0, 1]), ([1, 1, 4], [6, 9, 0]),
                      ([1, 0, 3], [7, 10, 0])):
    rows = jax_ragged.BuildRaggedRows(lens, q_pos, 16, 9)
    ids = rng.randint(0, task.p.vocab_size, size=(1, 16)).astype(np.int32)
    j_logits, j_states = jax.jit(task.RaggedStep)(
        theta, jnp.asarray(ids), j_states, jnp.asarray(tables),
        _JaxRows(rows))
    t_logits, t_states = lm.RaggedStep(
        torch.as_tensor(ids), t_states, torch.as_tensor(tables),
        ragged.ToTorch(rows, "cpu"))
    valid = np.asarray(rows.valid)
    np.testing.assert_allclose(t_logits[0].numpy()[valid],
                               np.asarray(j_logits)[0][valid],
                               atol=1e-4, rtol=1e-4)
    _AssertStatesClose(j_states, t_states)


def test_load_jax_theta_consumes_every_hybrid_leaf_once(hybrids):
  """The repeat-of-Stacked theta: each reference leaf is [num_layers // n,
  ...] inside body.x_layers[j] and is consumed once per repeat."""
  task, theta, _ = hybrids["repeat"]
  lm = _PortParams(task.p).Instantiate(device="cpu")
  with torch.no_grad():
    for prm in lm.parameters():
      prm.fill_(float("nan"))
  loaded = convert.LoadJaxTheta(lm, theta)
  reps = task.p.num_layers // task.p.mixer_atten_every_n
  assert len(lm.stack.body) == reps
  leaves = [k for k, _ in theta.FlattenItems()]
  stacked = [k for k in leaves if k.startswith("stack.")]
  assert any(".atten.w_dt" in k for k in stacked)   # SSM leaves are there
  for k in stacked:
    assert theta.GetItem(k).shape[0] == reps, k
  per_layer = [p.replace(f"body[{i}]", "body") for p in loaded
               for i in range(reps) if f"body[{i}]" in p]
  assert sorted(set(per_layer)) == sorted(stacked)
  assert all(per_layer.count(k) == reps for k in stacked)
  assert len(loaded) == len(list(lm.parameters()))
  assert all(torch.isfinite(prm).all() for prm in lm.parameters())
  back = convert.ThetaToNumpy(lm)
  for k in leaves:
    np.testing.assert_array_equal(back.GetItem(k), theta.GetItem(k))


def _HybridStackParams(transformer_lib, ssm_lib, atten_lib):
  """A StackedTransformerLayers [ssm, attention] block with the reference's
  default final_ln (True), in the JAX package or the port."""
  layer = transformer_lib.TransformerLayer.Params().Set(
      num_heads=N, hidden_dim=2 * D, mask_self_atten=True)
  layer.tr_atten_tpl.atten_tpl = atten_lib.MultiHeadedAttention.Params().Set(
      use_rotary_position_emb=True)
  ssm_layer = layer.Copy().Set(mixer_tpl=ssm_lib.GatedSSMLayer.Params().Set(
      state_dim=S, chunk_size=CHUNK))
  return transformer_lib.StackedTransformerLayers.Params().Set(
      name="stack", num_layers=2, input_dim=D,
      layer_tpls=[ssm_layer, layer.Copy()])


def test_stacked_final_ln_matches_reference():
  """StackedTransformerLayers with final_ln (the reference's default; the
  LM's stacks set it False): FProp and RaggedStep against JAX."""
  from lingvo_tpu.core import attention as jax_attention
  from lingvo_tpu.core import transformer as jax_transformer
  from lingvo_tpu_torch.core import attention
  from lingvo_tpu_torch.core import transformer
  j_stack = _HybridStackParams(jax_transformer, jax_ssm,
                               jax_attention).Instantiate()
  assert j_stack.p.final_ln
  theta = _Noised(j_stack.InstantiateVariables(jax.random.PRNGKey(5)), 6)
  t_stack = _HybridStackParams(transformer, ssm, attention).Instantiate(
      device="cpu")
  assert t_stack.p.final_ln and hasattr(t_stack, "final_ln")
  loaded = convert.LoadJaxTheta(t_stack, theta)
  assert len(loaded) == len(theta.Flatten())
  assert any(k.startswith("final_ln.") for k in loaded)
  rng = np.random.RandomState(7)
  x = rng.randn(2, 9, D).astype(np.float32)
  paddings = np.zeros((2, 9), np.float32)
  paddings[1, 7:] = 1.0
  j_out = j_stack.FProp(theta, jnp.asarray(x), jnp.asarray(paddings))
  with torch.no_grad():
    t_out = t_stack.FProp(torch.as_tensor(x), torch.as_tensor(paddings))
  np.testing.assert_allclose(t_out.numpy()[0], np.asarray(j_out)[0],
                             atol=1e-4, rtol=1e-4)
  np.testing.assert_allclose(t_out.numpy()[1, :7], np.asarray(j_out)[1, :7],
                             atol=1e-4, rtol=1e-4)
  rows = jax_ragged.BuildRaggedRows([5, 1], [0, 3], 8, 5)
  tables = np.arange(4, dtype=np.int32).reshape(2, 2)
  x = rng.randn(1, 8, D).astype(np.float32)
  j_states = j_stack.InitPagedStates(theta, 5, 8, num_slots=2)
  j_out, _ = jax.jit(j_stack.RaggedStep)(theta, jnp.asarray(x), j_states,
                                         jnp.asarray(tables), _JaxRows(rows))
  t_states = t_stack.InitPagedStates(5, 8, num_slots=2)
  with torch.no_grad():
    t_out, _ = t_stack.RaggedStep(torch.as_tensor(x), t_states,
                                  torch.as_tensor(tables),
                                  ragged.ToTorch(rows, "cpu"))
  valid = np.asarray(rows.valid)
  np.testing.assert_allclose(t_out[0].numpy()[valid],
                             np.asarray(j_out)[0][valid], atol=1e-4, rtol=1e-4)


def test_every_n_one_is_the_attention_stack():
  p = _PortParams(TinyLmParams(every_n=1).Instantiate().p)
  lm = p.Instantiate(device="cpu")
  assert not any(isinstance(m, ssm.GatedSSMLayer) for m in lm.modules())
