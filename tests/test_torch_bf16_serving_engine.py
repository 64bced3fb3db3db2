"""The serving engine at fprop_dtype=bfloat16 in lingvo_tpu_torch against the JAX reference, on the CPU.

On DenseLmTiny at fprop_dtype=bfloat16 (noised theta, weights float32):
- The LM's teacher-forced logits through two `RaggedStep`s (the engine's
  program) against the reference run op by op (`jax.disable_jit()`):
  bfloat16 logits bitwise the reference's; the port at float32
  activations, the control, is more than 1e-3 off. (Prefill and
  ExtendStep: tests/test_torch_bf16_decode.py.)
- `ServingLoop` greedy streams in both step modes for kv_cache_dtype
  None (bfloat16 pools), 'float32' and 'int8', sampled streams
  (temperature / top-k, per-request seeds) and int8 weights: token for
  token the JAX engine's, with its `Stats()` counters, `kv_cache_dtype`,
  `kv_bytes_per_token` and `serve_int8_weights`.
- The engine serves a theta cast to bfloat16 once (`ServedTheta`): inside
  a step each layer's `CastTheta()` returns the bound bfloat16 tensors
  themselves (no copy), with the bits of the per-forward cast; an int8
  weight's scale is cast once too. `UpdateTheta` casts the new weights
  again and serves them.

The reference's engine runs jitted: its streams and the op-by-op ones
were equal in every case here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lingvo_tpu.core import ragged as jax_ragged
from lingvo_tpu.models.lm.params import synthetic_packed_input as jax_spi
from lingvo_tpu.serving import engine as jax_engine
from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import attention
from lingvo_tpu_torch.core import quant_utils
from lingvo_tpu_torch.core import ragged
from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
from lingvo_tpu_torch.serving import engine

from tests.conftest import InstantiateLm
from tests.test_torch_legacy_serving import _ENGINE_KW, _Noised, _Prompts

BF16 = torch.bfloat16
_COUNTS = ("steps", "decode_steps", "mixed_steps", "tokens_emitted",
           "prompt_tokens", "quantized_steps")
_SAMPLE = dict(temperature=1.5, top_k=5, sample_seed=3)


def _PortLm(theta, fprop=BF16, **fields):
  lm = spi.DenseLmTiny().Task().Set(fprop_dtype=fprop, **fields).Instantiate(
      device="cpu")
  convert.LoadJaxTheta(lm, theta)
  return lm


@pytest.fixture(scope="module")
def dense():
  """DenseLmTiny at fprop_dtype=bfloat16: the reference task, a noised
  theta, the port's LM with it."""
  task, theta = InstantiateLm(
      jax_spi.DenseLmTiny().Task().Set(fprop_dtype=jnp.bfloat16), seed=5)
  theta = _Noised(theta, seed=2, scale=0.3)
  return task, theta, _PortLm(theta)


def _Unrolled(kv_dtype):
  """DenseLmTiny at bfloat16 with an unrolled stack (x_layers) and
  `kv_dtype` caches on both sides, one noised theta."""
  fields = dict(use_repeat_layer=False, kv_cache_dtype=kv_dtype)
  task, theta = InstantiateLm(jax_spi.DenseLmTiny().Task().Set(
      fprop_dtype=jnp.bfloat16, **fields), seed=5)
  theta = _Noised(theta, seed=2, scale=0.3)
  return task, theta, _PortLm(theta, **fields)


def _Jnp(theta):
  """A numpy theta as jax arrays: what the reference's programs take (a
  numpy bfloat16 leaf would promote `1.0 + scale` to float32)."""
  return jax.tree_util.tree_map(jnp.asarray, theta)


def _KvDtypes(states):
  """The dtypes of the K/V pools or caches in decode states."""
  return {v.dtype for k, v in states.FlattenItems()
          if k.endswith((".key", ".value"))}


def _F32(x):
  if isinstance(x, torch.Tensor):
    return x.float().numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


def CheckLogits(got, want, ctl, live=None):
  """bfloat16 logits [..., V] bitwise the reference's (so is the greedy
  token); the float32 control more than 1e-3 x max|want| off. live: rows
  to compare."""
  assert got.dtype == BF16 and want.dtype == jnp.bfloat16
  got, want, ctl = _F32(got), _F32(want), _F32(ctl)
  if live is not None:
    got, want, ctl = got[live], want[live], ctl[live]
  np.testing.assert_array_equal(got, want)
  assert np.abs(ctl - want).max() > 1e-3 * np.abs(want).max()


def test_teacher_forced_ragged_logits_match_reference(dense):
  """Two packed steps of the engine's program (prefill rows, then decode
  and prefill rows over what the first wrote), bfloat16 pools."""
  task, theta, lm = dense
  ctl = _PortLm(theta, fprop=None)
  theta = _Jnp(theta)
  rng = np.random.RandomState(2)
  n_pages, b = 16, 3
  tables = rng.permutation(n_pages)[:b * 4].reshape(b, 4).astype(np.int32)
  js = task.InitPagedDecodeState(theta, n_pages + 1, 8, b)
  ts = lm.InitPagedDecodeState(n_pages + 1, 8, b)
  cs = ctl.InitPagedDecodeState(n_pages + 1, 8, b, "bfloat16")
  t_, j_ = torch.as_tensor, jnp.asarray
  with jax.disable_jit():
    for row_lens, q_pos in (([6, 9, 0], [0, 0, 1]), ([1, 4, 2], [6, 9, 0])):
      rows = jax_ragged.BuildRaggedRows(row_lens, q_pos, 16, 9)
      ids = rng.randint(1, 64, size=(1, 16)).astype(np.int32)
      jl, js = task.RaggedStep(theta, j_(ids), js, j_(tables),
                               jax_ragged.RaggedRows(*(j_(m) for m in rows)))
      trows = ragged.ToTorch(rows, "cpu")
      tl, ts = lm.RaggedStep(t_(ids), ts, t_(tables), trows)
      cl, cs = ctl.RaggedStep(t_(ids), cs, t_(tables), trows)
      CheckLogits(tl[0], jl[0], cl[0], np.asarray(rows.valid))


def _Serve(task, theta, lm, step_mode, kv_dtype=None, max_new=8, **kw):
  """(port streams, port engine, JAX streams, JAX engine)."""
  prompts, lens = _Prompts(task.p.vocab_size)
  j_eng = jax_engine.ServingLoop(task, theta, trace=False,
                                 step_mode=step_mode,
                                 kv_cache_dtype=kv_dtype, **_ENGINE_KW, **kw)
  want = j_eng.RunBatch(prompts, lens, max_new_tokens=max_new)
  eng = engine.ServingLoop(lm, device="cpu", step_mode=step_mode,
                           kv_cache_dtype=kv_dtype, **_ENGINE_KW, **kw)
  got = eng.RunBatch(prompts, lens, max_new_tokens=max_new)
  return got, eng, want, j_eng


def _AssertStats(eng, j_eng):
  stats, j_stats = eng.Stats(), j_eng.Stats()
  for key in _COUNTS + ("kv_cache_dtype", "kv_bytes_per_token",
                        "serve_int8_weights"):
    assert stats[key] == j_stats[key], key
  assert stats["kv_pages"]["in_use"] == 0
  return stats


@pytest.mark.parametrize("kv_dtype", [None, "float32", "int8"])
@pytest.mark.parametrize("step_mode", ["ragged", "legacy"])
def test_greedy_streams_match_reference(dense, step_mode, kv_dtype):
  task, theta, lm = dense
  got, eng, want, j_eng = _Serve(task, theta, lm, step_mode, kv_dtype)
  assert len(np.unique(want)) > 6   # not one echo per row
  np.testing.assert_array_equal(got, want)
  stats = _AssertStats(eng, j_eng)
  assert stats["kv_cache_dtype"] == (kv_dtype or "bfloat16")
  assert _KvDtypes(eng._states) == {
      getattr(torch, stats["kv_cache_dtype"])}


@pytest.mark.parametrize("step_mode", ["ragged", "legacy"])
def test_sampled_streams_match_reference(dense, step_mode):
  """Seeded temperature / top-k draws from the bfloat16 logits (widened
  first, as the reference's `astype(float32)`), per-request streams."""
  task, theta, lm = dense
  got, eng, want, j_eng = _Serve(task, theta, lm, step_mode, **_SAMPLE)
  np.testing.assert_array_equal(got, want)
  _AssertStats(eng, j_eng)
  greedy, *_ = _Serve(task, theta, lm, step_mode)
  assert (greedy != got).any()


@pytest.mark.parametrize("step_mode, kv_dtype", [("ragged", None),
                                                 ("legacy", "int8")])
def test_int8_weight_streams_match_reference(dense, step_mode, kv_dtype):
  """int8 weights under bfloat16 activations: the activations quantized
  from their widened values, the products' outputs rounded to bfloat16,
  the weight scales rounded to bfloat16 once."""
  task, theta, lm = dense
  got, eng, want, j_eng = _Serve(task, theta, lm, step_mode, kv_dtype,
                                 serve_int8_weights=True)
  np.testing.assert_array_equal(got, want)
  assert _AssertStats(eng, j_eng)["serve_int8_weights"] is True


def test_update_theta_recasts_the_served_weights(dense):
  """A swap between steps: the new weights are cast to bfloat16 once more
  and served; the streams equal a fresh engine's on the new weights from
  the step of the swap on (here the first)."""
  task, theta, _ = dense
  new_theta = _Noised(theta, seed=6, scale=0.3)
  prompts, lens = _Prompts(task.p.vocab_size)
  want = engine.ServingLoop(_PortLm(new_theta), device="cpu",
                            **_ENGINE_KW).RunBatch(prompts, lens,
                                                   max_new_tokens=6)
  lm = _PortLm(theta)
  eng = engine.ServingLoop(lm, device="cpu", **_ENGINE_KW)
  before = eng.RunBatch(prompts, lens, max_new_tokens=6)
  old = eng._served
  eng.UpdateTheta(_PortLm(new_theta).ThetaTree())
  assert eng._served is not old
  got = eng.RunBatch(prompts, lens, max_new_tokens=6)
  np.testing.assert_array_equal(got, want)
  assert (before != got).any()


@pytest.mark.parametrize("int8", [False, True])
def test_served_theta_is_cast_once(dense, int8):
  """Inside a step each layer's CastTheta() returns the bound bfloat16
  leaves themselves, call after call (no per-step copy), with the bits of
  the per-forward cast of the float32 weights."""
  _, theta, _ = dense
  lm = _PortLm(theta)
  eng = engine.ServingLoop(lm, device="cpu", serve_int8_weights=int8,
                           **_ENGINE_KW)
  layers = [m for m in lm.modules() if isinstance(
      m, attention.MultiHeadedAttention)]
  assert layers
  for layer in layers:
    per_step = layer.CastTheta()   # outside a step: the per-forward cast
    with eng._served.Active():
      first, again = layer.CastTheta(), layer.CastTheta()
    for name, leaf in first.FlattenItems():
      assert again.GetItem(name) is leaf, name
      if isinstance(leaf, quant_utils.Int8Weight):
        assert leaf.scale.dtype == BF16
        assert leaf._scale_vec.dtype == torch.float32
        continue
      assert leaf.dtype == BF16, name
      assert torch.equal(leaf.view(torch.int16),
                         per_step.GetItem(name).view(torch.int16)), name
    assert int8 == any(isinstance(leaf, quant_utils.Int8Weight)
                       for _, leaf in first.FlattenItems())
