"""lingvo_tpu_torch layers against the JAX reference on the CPU.

Each layer is built from the same Params on both sides, the JAX theta is
carried into the port with `convert.LoadJaxTheta`, and the same numpy
inputs (made from a seed) go through both. Tolerance: float32, atol 2e-5
(the reference's own decode tolerance; the frameworks order float sums
differently).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lingvo_tpu.core import attention as jax_attention
from lingvo_tpu.core import layers as jax_layers
from lingvo_tpu.core import nested_map as jax_nested_map
from lingvo_tpu.core import ragged as jax_ragged
from lingvo_tpu.core import transformer as jax_transformer
from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import attention
from lingvo_tpu_torch.core import layers
from lingvo_tpu_torch.core import ragged
from lingvo_tpu_torch.core import transformer

ATOL = 2e-5


def _Pair(jax_cls, torch_cls, seed=0, **fields):
  """(jax layer, jax theta, port layer with the same weights)."""
  jl = jax_cls.Params().Set(name="l", **fields).Instantiate()
  theta = jl.InstantiateVariables(jax.random.PRNGKey(seed))
  # perturb zero-initialized leaves (norm scales, biases) so they matter
  rng = np.random.RandomState(seed + 100)
  theta = jax.tree_util.tree_map(
      lambda x: np.asarray(x) + 0.1 * rng.randn(*x.shape).astype(np.float32),
      theta)
  tl = torch_cls.Params().Set(name="l", **fields).Instantiate(device="cpu")
  convert.LoadJaxTheta(tl, theta)
  return jl, theta, tl


def _Close(a, b, atol=ATOL):
  np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=atol,
                             rtol=1e-5)


def test_layer_norm():
  jl, theta, tl = _Pair(jax_layers.LayerNorm, layers.LayerNorm, input_dim=24)
  x = np.random.RandomState(1).randn(2, 5, 24).astype(np.float32) * 3 + 1
  _Close(jl.FProp(theta, jnp.asarray(x)), tl.FProp(torch.as_tensor(x)))


@pytest.mark.parametrize("embedding_dim", [0, 8])
def test_rotary_at_packed_positions(embedding_dim):
  """Full and partial rotary at large, unordered positions (the packed
  step's pos_ids), float32 timescale as the reference builds it."""
  jl = jax_layers.RotaryPositionalEmbeddingLayer.Params().Set(
      embedding_dim=embedding_dim).Instantiate()
  tl = layers.RotaryPositionalEmbeddingLayer.Params().Set(
      embedding_dim=embedding_dim).Instantiate(device="cpu")
  rng = np.random.RandomState(2)
  x = rng.randn(1, 7, 3, 16).astype(np.float32)
  pos = np.array([[0, 1, 900, 901, 1023, 5, 64]], np.float32)
  _Close(jl.FProp({}, jnp.asarray(x), position=jnp.asarray(pos)),
         tl.FProp(torch.as_tensor(x), torch.as_tensor(pos)))


def test_feed_forward():
  jl, theta, tl = _Pair(jax_transformer.TransformerFeedForwardLayer,
                        transformer.TransformerFeedForwardLayer,
                        input_dim=16, hidden_dim=40)
  x = np.random.RandomState(3).randn(1, 6, 16).astype(np.float32)
  _Close(jl.FProp(theta, jnp.asarray(x)), tl.FProp(torch.as_tensor(x)))


def test_emb_lookup_and_capped_logits():
  jl, theta, tl = _Pair(jax_layers.SharedEmbeddingSoftmaxLayer,
                        layers.SharedEmbeddingSoftmaxLayer,
                        vocab_size=50, embedding_dim=16, logits_soft_max=2.0)
  ids = np.random.RandomState(4).randint(0, 50, size=(1, 9)).astype(np.int32)
  emb_j = jl.EmbLookup(theta, jnp.asarray(ids))
  emb_t = tl.EmbLookup(torch.as_tensor(ids))
  _Close(emb_j, emb_t)
  # a small cap so the tanh is far from linear on these inputs
  _Close(jl.Logits(theta, emb_j), tl.Logits(emb_t))
  assert float(tl.Logits(emb_t).abs().max()) <= 2.0


def test_mha_ragged_step():
  """A mixed pack (decode, prefill chunk, padding) through one attention
  layer: outputs and the updated page pools match the reference."""
  page, n_pages, b = 8, 4, 3
  jl, theta, tl = _Pair(jax_attention.MultiHeadedAttention,
                        attention.MultiHeadedAttention, input_dim=16,
                        num_heads=2, use_rotary_position_emb=True)
  rng = np.random.RandomState(5)
  tables = rng.permutation(b * n_pages).reshape(b, n_pages).astype(np.int32)
  rows = jax_ragged.BuildRaggedRows([1, 5, 3], [17, 0, 6], 12, 8)
  x = rng.randn(1, 12, 16).astype(np.float32)
  k0 = rng.randn(b * n_pages + 1, page, 2, 8).astype(np.float32)
  v0 = rng.randn(b * n_pages + 1, page, 2, 8).astype(np.float32)
  j_states = jax_nested_map.NestedMap(key=jnp.asarray(k0),
                                      value=jnp.asarray(v0))
  j_out, j_new = jl.RaggedStep(
      theta, jnp.asarray(x), j_states, jnp.asarray(tables),
      jax_ragged.RaggedRows(*(jnp.asarray(m) for m in rows)))
  t_states = tl.InitPagedStates(b * n_pages + 1, page)
  t_states.key.copy_(torch.as_tensor(k0))
  t_states.value.copy_(torch.as_tensor(v0))
  t_out, t_new = tl.RaggedStep(torch.as_tensor(x), t_states,
                               torch.as_tensor(tables),
                               ragged.ToTorch(rows, "cpu"))
  assert t_new.key is t_states.key   # updated in place
  valid = np.asarray(rows.valid)
  _Close(np.asarray(j_out)[:, valid], t_out[:, torch.as_tensor(valid)])
  # the trash page takes padding writes in an unspecified order
  _Close(np.asarray(j_new.key)[:-1], t_new.key[:-1])
  _Close(np.asarray(j_new.value)[:-1], t_new.value[:-1])


def test_mha_ineligible_config_raises():
  """A layer the paged kernels do not serve takes the gather-dense
  fallback (tests/test_torch_dense_fallback.py). With attention dropout
  it no longer raises: serving has no step seed, so the dropout is the
  identity, and the step's outputs and pools match the reference's
  `RaggedStep` (which serves it through the same fallback)."""
  page, n_pages, b = 8, 4, 2
  jl, theta, tl = _Pair(jax_attention.MultiHeadedAttention,
                        attention.MultiHeadedAttention, input_dim=16,
                        num_heads=2, use_rotary_position_emb=True,
                        atten_dropout_prob=0.1)
  assert not tl.BlockDecodeEligible(page)
  rng = np.random.RandomState(6)
  tables = rng.permutation(b * n_pages).reshape(b, n_pages).astype(np.int32)
  rows = jax_ragged.BuildRaggedRows([1, 5], [9, 0], 8, 6)
  x = rng.randn(1, 8, 16).astype(np.float32)
  k0 = rng.randn(b * n_pages + 1, page, 2, 8).astype(np.float32)
  v0 = rng.randn(b * n_pages + 1, page, 2, 8).astype(np.float32)
  j_states = jax_nested_map.NestedMap(key=jnp.asarray(k0),
                                      value=jnp.asarray(v0))
  j_out, j_new = jax.jit(jl.RaggedStep)(
      theta, jnp.asarray(x), j_states, jnp.asarray(tables),
      jax_ragged.RaggedRows(*(jnp.asarray(m) for m in rows)))
  t_states = tl.InitPagedStates(b * n_pages + 1, page)
  t_states.key.copy_(torch.as_tensor(k0))
  t_states.value.copy_(torch.as_tensor(v0))
  t_out, t_new = tl.RaggedStep(torch.as_tensor(x), t_states,
                               torch.as_tensor(tables),
                               ragged.ToTorch(rows, "cpu"))
  valid = np.asarray(rows.valid)
  _Close(np.asarray(j_out)[:, valid], t_out[:, torch.as_tensor(valid)])
  _Close(np.asarray(j_new.key)[:-1], t_new.key[:-1])
  _Close(np.asarray(j_new.value)[:-1], t_new.value[:-1])
