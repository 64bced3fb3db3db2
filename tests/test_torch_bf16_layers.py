"""Mixed precision (fprop_dtype=bfloat16) in lingvo_tpu_torch against the JAX reference, layer by layer, on the CPU.

The reference runs op by op (`jax.disable_jit()`), so every bf16 value
is rounded where its program rounds it; under jit XLA may keep float32
between fused ops, which no eager program reproduces.

- `fprop_dtype` reaches every child as the reference's rule passes it
  on; weights stay float32 and `CastTheta` hands the layers bf16 copies
  whose gradients come back in float32, StackedLeafs included.
- `ProjectionLayer`, `LayerNorm`, the rotary layer, the tied embedding
  (`EmbLookup`, `Logits`, the dense and the fused loss), `PerDimScaleLayer`
  and `MultiHeadedAttention` (einsum and flash paths) in bf16 against the
  reference's layers: outputs and input gradients within a relative
  error norm of 1e-4 (bf16 results) or 1e-6 (float32 losses); they agree
  bit for bit but for a float32 sum taken in another order, which can
  move one bf16 rounding. The same port layer in float32 must miss each
  bar by 10x.
- The bf16 kernels' plain versions against the reference's are in
  `test_torch_bf16_ops.py`; the whole model in `test_torch_bf16_train.py`.
"""

import math
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lingvo_tpu.core import attention as jax_attention
from lingvo_tpu.core import layers as jax_layers
from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import attention
from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import layers
from lingvo_tpu_torch.models.lm import layers as lm_layers

from tests.conftest import TinyLmParams

TOL = 1e-6     # relative to max|want|, where the two agree bit for bit
SHARE = 1e-3   # the bar for bf16 kernels' twins: share of differing elements


def _F32(x):
  if isinstance(x, torch.Tensor):
    return x.detach().float().numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _RelMax(got, want):
  got, want = _F32(got), _F32(want)
  return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _RelNorm(got, want):
  got, want = _F32(got), _F32(want)
  return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _Share(got, want):
  """The share of elements that differ by more than 1e-5 x max|want| (the
  floor spares the noise of exact cancellations)."""
  got, want = _F32(got), _F32(want)
  floor = 1e-5 * np.abs(want).max()
  return float(np.mean(np.abs(got - want) > floor))


def _Walk(layer):
  yield layer
  for child in layer.children.values():
    for c in (child if isinstance(child, list) else [child]):
      yield from _Walk(c)


def test_fprop_dtype_propagates_like_reference():
  jp = TinyLmParams(fprop_dtype=jnp.bfloat16)
  jlm = jp.Instantiate()
  jlm.FinalizePaths()
  jax_dtypes = {l.path: l.p.fprop_dtype for l in _Walk(jlm)}
  port = lm_layers.TransformerLm.Params().Set(
      name=jp.name, vocab_size=jp.vocab_size, model_dim=jp.model_dim,
      num_layers=jp.num_layers, num_heads=jp.num_heads,
      hidden_dim=jp.hidden_dim, use_rotary=jp.use_rotary,
      fprop_dtype=torch.bfloat16).Instantiate(device="cpu")
  port.FinalizePaths()
  names = {jnp.bfloat16: torch.bfloat16, None: None}
  port_layers = [m for m in port.modules()
                 if isinstance(m, base_layer.BaseLayer)]
  for m in port_layers:
    # the reference's repeat keeps one body; the port one per layer
    path = re.sub(r"/body_\d+", "/body", m.path)
    assert m.p.fprop_dtype == names[jax_dtypes[path]], m.path
    assert m.fprop_dtype == torch.bfloat16, m.path
  # 13 a body (3 of them dropout layers, as in the reference) times 2
  # bodies, plus the LM, its embedding, stack and final norm
  assert len(port_layers) == 30
  assert all(p.dtype == torch.float32 for p in port.parameters())
  # theta casts: bf16 copies, float32 gradients, StackedLeafs per layer
  proj = port.stack.body[0].fflayer.ffn_in
  th = proj.CastTheta()
  assert th.w.dtype == th.b.dtype == torch.bfloat16
  th.w.float().sum().backward()
  assert proj.w.grad.dtype == torch.float32
  stacked = port.stack.ThetaTree().body.fflayer.ffn_in.w
  cast = proj.CastTheta(base_layer.NestedMap(w=stacked)).w
  assert isinstance(cast, base_layer.StackedLeaf)
  assert all(x.dtype == torch.bfloat16 for x in cast.layers)
  # fprop_dtype unset: theta comes back as it is
  f32 = layers.ProjectionLayer.Params().Set(
      input_dim=2, output_dim=3).Instantiate(device="cpu")
  assert f32.CastTheta().w is f32.w


def _Pair(jax_cls, port_cls, seed, fprop=True, **fields):
  """(jax layer, its theta as jnp, port layer with the same weights)."""
  rng = np.random.RandomState(seed)
  jl = jax_cls.Params().Set(name="x", fprop_dtype=jnp.bfloat16,
                            **fields).Instantiate()
  theta = jax.tree_util.tree_map(
      lambda x: np.asarray(x) + 0.1 * rng.randn(*x.shape).astype(np.float32),
      jl.InstantiateVariables(jax.random.PRNGKey(seed)))
  tl = port_cls.Params().Set(
      name="x", fprop_dtype=torch.bfloat16 if fprop else None,
      **fields).Instantiate(device="cpu")
  convert.LoadJaxTheta(tl, theta)
  return jl, jax.tree_util.tree_map(jnp.asarray, theta), tl


def _Cases():
  """name -> (jax cls, port cls, fields, jax fn(layer, theta, x), port fn(
  layer, x), input shape)."""
  seg = np.ones((2, 32), np.int32)
  seg[0, 11:] = 2
  mha = lambda flash: (
      jax_attention.MultiHeadedAttention, attention.MultiHeadedAttention,
      dict(input_dim=32, num_heads=2, use_rotary_position_emb=True,
           use_flash_attention=flash),
      lambda l, th, x: l.FProp(th, x, segment_ids=jnp.asarray(seg),
                               causal=True)[0],
      lambda l, x: l.FProp(x, segment_ids=torch.as_tensor(seg),
                           causal=True)[0], (2, 32, 32))
  labels = np.random.RandomState(9).randint(0, 50, (2, 32)).astype(np.int32)
  emb = dict(vocab_size=50, embedding_dim=32, logits_soft_max=30.0)
  return {
      "projection": (jax_layers.ProjectionLayer, layers.ProjectionLayer,
                     dict(input_dim=32, output_dim=24, activation="RELU"),
                     lambda l, th, x: l.FProp(th, x),
                     lambda l, x: l.FProp(x), (2, 8, 32)),
      "layer_norm": (jax_layers.LayerNorm, layers.LayerNorm,
                     dict(input_dim=32), lambda l, th, x: l.FProp(th, x),
                     lambda l, x: l.FProp(x), (2, 8, 32)),
      "logits": (jax_layers.SharedEmbeddingSoftmaxLayer,
                 layers.SharedEmbeddingSoftmaxLayer, emb,
                 lambda l, th, x: l.Logits(th, x), lambda l, x: l.Logits(x),
                 (2, 32, 32)),
      "dense_xent": (jax_layers.SharedEmbeddingSoftmaxLayer,
                     layers.SharedEmbeddingSoftmaxLayer, emb,
                     lambda l, th, x: l.FProp(
                         th, x, class_ids=jnp.asarray(labels),
                         label_smoothing=0.1).per_example_xent,
                     lambda l, x: l.FProp(
                         x, class_ids=torch.as_tensor(labels),
                         label_smoothing=0.1).per_example_xent, (2, 32, 32)),
      "fused_xent": (jax_layers.SharedEmbeddingSoftmaxLayer,
                     layers.SharedEmbeddingSoftmaxLayer,
                     dict(emb, xent_block_size=16),
                     lambda l, th, x: l.FProp(
                         th, x, class_ids=jnp.asarray(labels),
                         label_smoothing=0.1).per_example_xent,
                     lambda l, x: l.FProp(
                         x, class_ids=torch.as_tensor(labels),
                         label_smoothing=0.1).per_example_xent, (2, 32, 32)),
      "per_dim_scale": (jax_attention.PerDimScaleLayer,
                        attention.PerDimScaleLayer, dict(dim=16),
                        lambda l, th, x: l.FProp(th, x),
                        lambda l, x: l.FProp(x), (2, 8, 2, 16)),
      "mha_einsum": mha(False),
      "mha_flash": mha(True),
  }


@pytest.mark.parametrize("name", sorted(_Cases()))
def test_layer_matches_reference_in_bf16(name):
  """Forward and the gradient of the inputs within a relative error norm
  of 1e-4 (values that passed bf16: one bf16 rounding moved by a float32
  sum in another order is 2^-8 of one element) or 1e-6 (the float32
  losses); the float32 port layer is the control."""
  jax_cls, port_cls, fields, jfn, tfn, shape = _Cases()[name]
  jl, theta, tl = _Pair(jax_cls, port_cls, 1, **fields)
  _, _, ctl = _Pair(jax_cls, port_cls, 1, fprop=False, **fields)
  rng = np.random.RandomState(2)
  x = rng.randn(*shape).astype(np.float32)
  if name == "per_dim_scale":   # its inputs arrive in the fprop dtype
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
  with jax.disable_jit():
    want, vjp = jax.vjp(lambda a: jfn(jl, theta, a), jnp.asarray(x))
    g = rng.randn(*want.shape).astype(np.float32)
    want_dx = vjp(jnp.asarray(g).astype(want.dtype))[0]
  outs = []
  for layer in (tl, ctl):
    xt = torch.tensor(x, requires_grad=True)
    out = tfn(layer, xt)
    out.backward(torch.as_tensor(g).to(out.dtype))
    outs.append((out, xt.grad))
  (got, dx), (c_out, c_dx) = outs
  assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16
                       else torch.float32)
  loss = "xent" in name   # float32 losses; every other value passed bf16
  for port, ctl, ref, tol in ((got, c_out, want, 1e-6 if loss else 1e-4),
                              (dx, c_dx, want_dx, 1e-4)):
    assert _RelNorm(port, ref) <= tol
    assert _RelNorm(ctl, ref) >= 10 * tol


def test_emb_lookup_and_rotary_match_reference_in_bf16():
  """The lookup (sqrt(d) rounded to bf16 first, as JAX's weak scalar) and
  the rotation (float32 inside, bf16 out)."""
  jl, theta, tl = _Pair(jax_layers.SharedEmbeddingSoftmaxLayer,
                        layers.SharedEmbeddingSoftmaxLayer, 3,
                        vocab_size=50, embedding_dim=32)
  ids = np.random.RandomState(3).randint(0, 50, (2, 8)).astype(np.int32)
  with jax.disable_jit():
    want = jl.EmbLookup(theta, jnp.asarray(ids))
  got = tl.EmbLookup(torch.as_tensor(ids))
  assert got.dtype == torch.bfloat16 and _RelMax(got, want) == 0.0
  # the float32 scalar would round elsewhere (the control)
  ctl = (tl.emb[torch.as_tensor(ids).long()].bfloat16() * math.sqrt(32))
  assert _RelMax(ctl, want) >= 10 * TOL
  rot_j = jax_layers.RotaryPositionalEmbeddingLayer.Params().Set(
      name="r", embedding_dim=16, fprop_dtype=jnp.bfloat16).Instantiate()
  rot_t = layers.RotaryPositionalEmbeddingLayer.Params().Set(
      embedding_dim=16, fprop_dtype=torch.bfloat16).Instantiate(device="cpu")
  x = np.random.RandomState(4).randn(2, 8, 2, 16).astype(np.float32)
  with jax.disable_jit():
    want = rot_j.FProp({}, jnp.asarray(x).astype(jnp.bfloat16))
  got = rot_t.FProp(torch.as_tensor(x).bfloat16())
  assert got.dtype == torch.bfloat16 and _RelMax(got, want) <= TOL
