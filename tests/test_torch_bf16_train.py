"""Mixed-precision training (fprop_dtype=bfloat16) of the tiny LM against the JAX reference on the CPU.

The reference runs op by op (`jax.disable_jit()`), so every bf16 value is
rounded where its program rounds it. The conftest `TinyLmParams` repeat
stack with packed segments and padding, with the flash and fused-xent
switches off and on, at fprop_dtype bfloat16 on both sides; the control
is the same port model at float32.

- The loss and metrics within 1e-5 (they agree to float32 ulps); the
  control must miss by 10x.
- The gradient of every weight matrix within a relative error norm of
  1e-4 (bitwise here); the control must miss by 10x.
- The gradient of every vector leaf (biases, norm scales, the per-dim
  scale) within 3e-2 of the reference's own: these are sums over the
  batch's tokens of bf16 gradients, which the reference takes in
  bfloat16 in XLA's own order and the port in float32 (rounded once).
- So the vector leaves are also held to the reference's per-token bf16
  cotangents summed in float32, the port's order (`RankOneReference`):
  every element within one bf16 ulp, and the relative error norm over
  all vector leaves within 1e-3; the control must miss that by 10x and
  break the one-ulp bar in every leaf.
- `LoadJaxTheta` maps theta leaf for leaf with fprop_dtype set (weights
  stay float32); the serving entries take a bf16 task, and the bf16
  hybrid's GShardDecode continuations equal the reference's
  (tests/test_torch_bf16_serving*.py hold bf16 serving against the
  reference).
"""

import math
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lingvo_tpu.core import attention as jax_attention
from lingvo_tpu.core import checkpointer as jax_checkpointer
from lingvo_tpu.core.nested_map import NestedMap as JaxNestedMap
from lingvo_tpu.models.lm.params import synthetic_packed_input as jax_spi
from lingvo_tpu.runners import gshard_decode as jax_gshard
from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import checkpointer
from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
from lingvo_tpu_torch.runners import gshard_decode
from lingvo_tpu_torch.serving import engine

import tests.conftest as conftest
from tests import test_torch_train as tt
from tests.test_torch_legacy_serving import _Noised

VECTOR_LEAF = r"\.(b|b_\w+|bias|scale|per_dim_scale)$"   # rank-1 theta leaves


def BF16Lms(switches, seed=0, jax_fprop=jnp.bfloat16, port_fprop=None,
            **overrides):
  """`test_torch_train._Lms` with fprop_dtype set on each side."""
  tiny = conftest.TinyLmParams
  tt.TinyLmParams = lambda **kw: tiny(**kw).Set(fprop_dtype=jax_fprop)
  try:
    return tt._Lms(switches, seed=seed, fprop_dtype=port_fprop, **overrides)
  finally:
    tt.TinyLmParams = tiny


def _RelNorm(got, want):
  return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _PortRun(port, batch):
  tm, _ = port.FProp(tt._ToTorch(batch))
  tm.loss[0].backward()
  return tm, tt._PortGrads(port)


@pytest.mark.parametrize("switches", [False, True])
def test_bf16_fprop_loss_metrics_and_grads_match_reference(switches):
  task, theta, port = BF16Lms(switches, port_fprop=torch.bfloat16)
  _, _, ctl = BF16Lms(switches)
  batch = tt._Batch()

  def Loss(th):
    metrics, _ = task.FProp(th, tt._ToJax(batch))
    return metrics.loss[0], metrics

  with jax.disable_jit():
    (_, jm), jgrads = jax.value_and_grad(Loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, theta))
  tm, tgrads = _PortRun(port, batch)
  cm, cgrads = _PortRun(ctl, batch)
  for k in ("loss", "log_pplx", "fraction_of_correct_next_step_preds",
            "num_predictions"):
    want = float(jm[k][0])
    assert abs(float(torch.as_tensor(tm[k][0]).detach()) - want) <= 1e-5, k
    assert float(torch.as_tensor(tm[k][1])) == float(jm[k][1])
  assert abs(float(cm.loss[0].detach()) - float(jm.loss[0])) >= 1e-4
  jflat = {k: np.asarray(v) for k, v in jgrads.FlattenItems()}
  assert sorted(tgrads) == sorted(jflat)
  for k, want in jflat.items():
    assert tgrads[k].dtype == np.float32
    if re.search(VECTOR_LEAF, k):
      assert _RelNorm(tgrads[k], want) <= 3e-2, k
    else:
      assert _RelNorm(tgrads[k], want) <= 1e-4, k
      assert _RelNorm(cgrads[k], want) >= 1e-3, k


R_SOFTPLUS_0 = 1.442695041   # the reference PerDimScaleLayer's constant


def _ProbedPerDimScale(self, theta, inputs):
  """The reference `PerDimScaleLayer.FProp` with a zero `probe` leaf added
  to the scale once it is broadcast to every token: the probe's gradient
  is each token's bf16 cotangent of the scale, dy * q, before any sum."""
  th = self.CastTheta(theta)
  scale = (jax.nn.softplus(th.per_dim_scale)
           * (R_SOFTPLUS_0 / math.sqrt(self.p.dim))).astype(inputs.dtype)
  return inputs * (scale + th.probe.astype(inputs.dtype))


def _PerToken(theta, b, t):
  """theta with each vector leaf broadcast to one copy per token (the
  same values; the sum over tokens leaves the reference's program) and a
  zero per-token probe beside each per-dim scale."""
  out = JaxNestedMap()
  for k, v in theta.FlattenItems():
    v = np.asarray(v)
    lead = v.shape[:1] if ".body." in k else ()   # stacked layers
    if k.endswith("per_dim_scale.per_dim_scale"):
      heads = theta.GetItem(k.rsplit(".", 2)[0] + ".w_query").shape[-2]
      out.Set(k, v)
      out.Set(k.rsplit(".", 1)[0] + ".probe", np.zeros(
          lead + (b, t, heads, v.shape[-1]), np.float32))
    elif re.search(VECTOR_LEAF, k):
      rest = v.shape[len(lead):]
      out.Set(k, np.broadcast_to(v.reshape(lead + (1, 1) + rest),
                                 lead + (b, t) + rest).copy())
    else:
      out.Set(k, v)
  return out


def _Bf16(x):
  return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def RankOneReference(task, theta, batch):
  """(loss, {leaf: gradient}) of the JAX task, with every vector leaf's
  gradient the float32 sum over tokens of the reference's own per-token
  bf16 cotangents, rounded once to bf16 (the per-dim scale then goes
  through the reference's softplus and cast, op by op). The matrices'
  gradients are the reference's. Runs op by op."""
  b, t = batch.ids.shape
  orig = jax_attention.PerDimScaleLayer.FProp
  jax_attention.PerDimScaleLayer.FProp = _ProbedPerDimScale
  try:
    def Loss(th):
      metrics, _ = task.FProp(th, tt._ToJax(batch))
      return metrics.loss[0], metrics

    with jax.disable_jit():
      (loss, _), grads = jax.value_and_grad(Loss, has_aux=True)(
          jax.tree_util.tree_map(jnp.asarray, _PerToken(theta, b, t)))
  finally:
    jax_attention.PerDimScaleLayer.FProp = orig
  grads = {k: np.asarray(v) for k, v in grads.FlattenItems()}
  out = {}
  for k, v in theta.FlattenItems():
    tokens = (1, 2) if ".body." in k else (0, 1)
    if k.endswith("per_dim_scale.per_dim_scale"):
      cot = grads[k.rsplit(".", 1)[0] + ".probe"]   # [.., b, t, heads, h]
      heads = tokens[-1] + 1
      g = _Bf16(cot.sum(axis=tokens + (heads,), dtype=np.float32))
      dim = v.shape[-1]

      def Scale(w, dim=dim):
        return (jax.nn.softplus(w.astype(jnp.bfloat16))
                * (R_SOFTPLUS_0 / math.sqrt(dim))).astype(jnp.bfloat16)

      with jax.disable_jit():
        _, vjp = jax.vjp(Scale, jnp.asarray(v))
        out[k] = np.asarray(vjp(jnp.asarray(g, jnp.bfloat16))[0])
    elif re.search(VECTOR_LEAF, k):
      out[k] = _Bf16(grads[k].sum(axis=tokens, dtype=np.float32))
    else:
      out[k] = grads[k]
  return float(loss), out


@pytest.mark.parametrize("switches", [False, True])
def test_bf16_vector_leaf_grads_match_reference_cotangents(switches):
  task, theta, port = BF16Lms(switches, port_fprop=torch.bfloat16)
  _, _, ctl = BF16Lms(switches)
  batch = tt._Batch()
  loss, want = RankOneReference(task, theta, batch)
  tm, got = _PortRun(port, batch)
  _, ctl_got = _PortRun(ctl, batch)
  assert abs(float(tm.loss[0].detach()) - loss) <= 1e-5
  keys = [k for k in sorted(want) if re.search(VECTOR_LEAF, k)]
  assert len(keys) == 13
  for k in keys:
    bar = 2.0 ** -7 * np.abs(want[k]) + 1e-6 * np.abs(want[k]).max()
    assert np.all(np.abs(got[k] - want[k]) <= bar), k
    assert np.any(np.abs(ctl_got[k] - want[k]) > bar), k
  cat = lambda g: np.concatenate([g[k].ravel() for k in keys])
  assert _RelNorm(cat(got), cat(want)) <= 1e-3
  assert _RelNorm(cat(ctl_got), cat(want)) >= 1e-2


def test_load_jax_theta_with_fprop_dtype_keeps_float32_leaves():
  _, theta, port = BF16Lms(True, port_fprop=torch.bfloat16)
  flat = dict(theta.FlattenItems())
  got = dict(convert.ThetaToNumpy(port).FlattenItems())
  assert sorted(got) == sorted(flat)
  for k, v in flat.items():
    assert got[k].dtype == np.float32
    np.testing.assert_array_equal(got[k], np.asarray(v))
  assert all(p.dtype == torch.float32 for p in port.parameters())


def test_serving_entries_refuse_bf16_activations(tmp_path):
  """Both serving entries take the trained bf16 task (with bfloat16 pools
  and caches by default), and so does a stack with SSM mixers: the bf16
  DenseLmSsmHybridTiny's `GShardDecode` continuations (prefill chunks of
  3, 8 steps) from one noised theta, restored by each side's own
  checkpointer, equal the reference decoder's token for token."""
  _, _, port = BF16Lms(False, port_fprop=torch.bfloat16)
  eng = engine.ServingLoop(port, page_size=4, num_pages=8, max_batch=2,
                           max_seq_len=16, device="cpu")
  assert eng.Stats()["kv_cache_dtype"] == "bfloat16"
  out = eng.RunBatch(np.array([[3, 4, 5]], np.int32),
                     np.array([3], np.int32), max_new_tokens=2)
  assert out.shape == (1, 2)
  decoder = gshard_decode.GShardDecode(port, str(tmp_path),
                                       str(tmp_path / "out"))
  assert decoder._task is port
  task, theta = conftest.InstantiateLm(
      jax_spi.DenseLmSsmHybridTiny().Task().Set(fprop_dtype=jnp.bfloat16),
      seed=4)
  theta = _Noised(theta, seed=5, scale=0.3)
  state = task.CreateTrainState(jax.random.PRNGKey(3))
  state.theta = jax.tree_util.tree_map(jnp.asarray, theta)
  ckpt = jax_checkpointer.Checkpointer(str(tmp_path / "jax"))
  ckpt.Save(1, state, force=True)
  ckpt.Close()
  lm = spi.DenseLmSsmHybridTiny().Task().Set(
      fprop_dtype=torch.bfloat16).Instantiate(device="cpu")
  convert.LoadJaxTheta(lm, theta)
  assert checkpointer.Checkpointer(str(tmp_path / "port")).Save(
      1, lm, lm.CreateTrainState(), force=True)
  prompts = np.array([[5, 6, 7, 8, 9, 10, 11], [12, 13, 14, 15, 0, 0, 0],
                      [16, 0, 0, 0, 0, 0, 0]], np.int32)
  lens = np.array([7, 4, 1], np.int32)
  kw = dict(max_decode_steps=8, prefill_chunk_size=3)
  want = jax_gshard.GShardDecode(task, str(tmp_path / "jax"),
                                 str(tmp_path / "jax.jsonl"), **kw
                                 ).DecodeOnce(1, prompts, lens)
  got = gshard_decode.GShardDecode(
      spi.DenseLmSsmHybridTiny().Task().Set(
          fprop_dtype=torch.bfloat16).Instantiate(device="cpu"),
      str(tmp_path / "port"), str(tmp_path / "port.jsonl"), **kw
  ).DecodeOnce(1, prompts, lens)
  assert len({tuple(r["output_ids"]) for r in want}) > 1
  assert [r["output_ids"] for r in got] == [r["output_ids"] for r in want]
