"""The hybrid's training in lingvo_tpu_torch against the JAX reference, on the CPU.

- `GatedSSMLayer.FProp` (packed segments, a padded tail): the gradients
  of every weight and of the input against `jax.grad` of the reference
  layer with the same theta, float32, within atol 2e-5 x max(1,
  max|want|).
- The tiny hybrid LM (conftest `TinyLmParams(every_n=2)`, flat and as a
  repeat of [ssm, attention] blocks): the loss and metrics and the
  gradient of every theta leaf against `jax.value_and_grad`, at
  tests/test_torch_train.py's tolerance (atol 2e-5, rtol 1e-4).
- The layer at fprop_dtype=bfloat16 on a bfloat16 input against the
  reference run op by op (`jax.disable_jit()`): its bfloat16 output
  bitwise; the gradients of the weights, of the leaves it widens to
  float32 and of the input within a relative error norm of 1e-4 (bitwise
  here), the biases added in bfloat16 within 3e-2 (the reference sums
  their cotangents over tokens in bfloat16, tests/test_torch_bf16_train.py).
  The float32 layer, the control, is at least 1e-3 off.

The tiny LM at bfloat16: tests/test_torch_hybrid_bf16.py; the runtime on
DenseLmSsmHybridTiny: tests/test_torch_hybrid_executor.py.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lingvo_tpu.core import ssm as jax_ssm
from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import ssm

from tests import test_torch_train as tt
from tests.conftest import InstantiateLm, TinyLmParams
from tests.test_torch_ssm import _Noised, _PortParams

BF16 = torch.bfloat16
D, N, S, CHUNK = 16, 2, 4, 4
# the rank-1 leaves whose cotangents the reference sums over tokens in
# bfloat16 (biases added in the fprop dtype, layer norms)
VECTOR_LEAF = r"\.(b|b_v|b_gate|b_post|b_query|b_key|b_value|bias|scale|" \
              r"per_dim_scale)$"


def Rel(got, want):
  return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _Close(got, want, atol=2e-5):
  np.testing.assert_allclose(got, want, atol=atol * max(
      1.0, float(np.abs(want).max())), rtol=0)


# -- the layer -----------------------------------------------------------------


def _Layers(fprop=None):
  """(JAX layer, its noised theta, the port's layer with that theta)."""
  kw = dict(name="ssm", input_dim=D, hidden_dim=D, num_heads=N, state_dim=S,
            chunk_size=CHUNK)
  j_layer = jax_ssm.GatedSSMLayer.Params().Set(
      fprop_dtype=None if fprop is None else jnp.bfloat16, **kw).Instantiate()
  theta = _Noised(j_layer.InstantiateVariables(jax.random.PRNGKey(0)), 1,
                  0.3)
  port = ssm.GatedSSMLayer.Params().Set(fprop_dtype=fprop, **kw).Instantiate(
      device="cpu")
  convert.LoadJaxTheta(port, theta)
  return j_layer, theta, port


def _LayerInputs(dtype=np.float32):
  rng = np.random.RandomState(2)
  x = rng.randn(2, 11, D).astype(np.float32)
  cot = rng.randn(2, 11, D).astype(np.float32)
  paddings = np.zeros((2, 11), np.float32)
  paddings[1, 8:] = 1.0
  seg = np.ones((2, 11), np.int32)
  seg[0, 6:] = 2
  seg[1, 8:] = 0
  return x, cot, paddings, seg


def _JaxLayerGrads(j_layer, theta, x, cot, paddings, seg, dtype=jnp.float32):
  def Loss(th, xx):
    out, _ = j_layer.FProp(th, xx, paddings=jnp.asarray(paddings),
                           segment_ids=jnp.asarray(seg), causal=True)
    return jnp.sum(out.astype(jnp.float32) * jnp.asarray(cot)), out

  args = (jax.tree_util.tree_map(jnp.asarray, theta),
          jnp.asarray(x).astype(dtype))
  (_, out), (g_theta, g_x) = jax.value_and_grad(
      Loss, argnums=(0, 1), has_aux=True)(*args)
  grads = {k: np.asarray(v) for k, v in g_theta.FlattenItems()}
  grads["x"] = np.asarray(g_x.astype(jnp.float32))
  return out, grads


def _PortLayerGrads(port, x, cot, paddings, seg, dtype=torch.float32):
  for prm in port.parameters():
    prm.grad = None
  xx = torch.as_tensor(x).to(dtype).requires_grad_(True)
  out, _ = port.FProp(xx, paddings=torch.as_tensor(paddings),
                      segment_ids=torch.as_tensor(seg), causal=True)
  (out.float() * torch.as_tensor(cot)).sum().backward()
  grads = {k: v.grad.numpy() for k, v in port.named_parameters()}
  grads["x"] = xx.grad.float().numpy()
  return out, grads


def test_layer_grads_match_reference():
  j_layer, theta, port = _Layers()
  inputs = _LayerInputs()
  _, want = _JaxLayerGrads(j_layer, theta, *inputs)
  _, got = _PortLayerGrads(port, *inputs)
  assert sorted(got) == sorted(want) and len(want) == 14
  for k, w in want.items():
    assert np.abs(w).max() > 0, k
    _Close(got[k], w)


def test_layer_bf16_output_and_grads_match_reference_op_by_op():
  """The bfloat16 layer on a bfloat16 input: its output bitwise the
  reference's; the gradients of the weights, of the float32-widened
  leaves (a_log, b_dt, d_skip, norm_scale) and of the input within a
  relative error norm of 1e-4 (bitwise here), those of the biases added
  in bfloat16 within 3e-2. The float32 port layer on the same input, the
  control, is at least 1e-3 off in the output and every gradient held to
  1e-4."""
  j_layer, theta, port = _Layers(BF16)
  _, _, ctl = _Layers()
  inputs = _LayerInputs()
  with jax.disable_jit():
    out, want = _JaxLayerGrads(j_layer, theta, *inputs, dtype=jnp.bfloat16)
  assert out.dtype == jnp.bfloat16
  got_out, got = _PortLayerGrads(port, *inputs, dtype=BF16)
  ctl_out, ctl_got = _PortLayerGrads(ctl, *inputs, dtype=BF16)
  assert got_out.dtype == BF16 and ctl_out.dtype == torch.float32
  want_out = np.asarray(out.astype(jnp.float32))
  np.testing.assert_array_equal(got_out.float().detach().numpy(), want_out)
  assert Rel(ctl_out.detach().numpy(), want_out) >= 1e-3
  assert sorted(got) == sorted(want)
  for k, w in want.items():
    if re.search(VECTOR_LEAF, "." + k):
      assert Rel(got[k], w) <= 3e-2, k
    else:
      assert Rel(got[k], w) <= 1e-4, k
      assert Rel(ctl_got[k], w) >= 1e-3, k


# -- the tiny hybrid LM --------------------------------------------------------


def HybridLms(fprop=None, seed=3, **stack):
  """(JAX task, noised theta, the port's LM with it) of the conftest
  hybrid stack, at fprop_dtype `fprop` (None: float32) on both sides."""
  jax_fprop = None if fprop is None else jnp.bfloat16
  task, theta = InstantiateLm(TinyLmParams(every_n=2, fprop_dtype=jax_fprop,
                                           **stack), seed=seed)
  theta = _Noised(theta, seed=seed, scale=0.3)
  port = _PortParams(task.p).Set(fprop_dtype=fprop).Instantiate(device="cpu")
  convert.LoadJaxTheta(port, theta)
  return task, theta, port


def JaxLmGrads(task, theta, batch, jit=True):
  """(metrics, {leaf: gradient}) of the reference task's loss."""
  def Loss(th):
    metrics, _ = task.FProp(th, tt._ToJax(batch))
    return metrics.loss[0], metrics

  fn = jax.value_and_grad(Loss, has_aux=True)
  (_, jm), jgrads = (jax.jit(fn) if jit else fn)(
      jax.tree_util.tree_map(jnp.asarray, theta))
  return jm, {k: np.asarray(v) for k, v in jgrads.FlattenItems()}


def PortLmGrads(port, batch):
  tm, _ = port.FProp(tt._ToTorch(batch))
  tm.loss[0].backward()
  return tm, tt._PortGrads(port)


_LM_STACKS = {"flat": dict(), "repeat": dict(use_repeat=True, num_layers=4)}


@pytest.mark.parametrize("stack", sorted(_LM_STACKS))
def test_hybrid_lm_loss_and_grads_match_reference(stack):
  task, theta, port = HybridLms(**_LM_STACKS[stack])
  batch = tt._Batch()
  jm, want = JaxLmGrads(task, theta, batch)
  tm, got = PortLmGrads(port, batch)
  for k in ("loss", "log_pplx", "fraction_of_correct_next_step_preds",
            "num_predictions"):
    for i in (0, 1):
      tt._Close(float(torch.as_tensor(tm[k][i]).detach()), float(jm[k][i]),
                atol=1e-5)
  assert sorted(got) == sorted(want)
  assert sum(".w_b" in k or ".w_dt" in k for k in want) >= 2   # SSM leaves
  for k, g in got.items():
    tt._Close(g, want[k], atol=2e-5, rtol=1e-4)


