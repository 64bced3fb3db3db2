"""Quantized KV serving of lingvo_tpu_torch against JAX: the engine and GShardDecode.

- `ServingLoop(kv_cache_dtype='int8' | 'bfloat16')` greedy streams on
  DenseLmTiny (noised theta), in ragged and in legacy step mode, are
  token-identical to the JAX `ServingLoop` with the same override, with
  the same step counts, `kv_cache_dtype`, `kv_bytes_per_token` and
  `quantized_steps`; the pool of 12 pages is smaller than the 16 pages
  the 6 requests take in all, so later requests reuse pages (and int8
  sidecars) that finished ones freed. An LM whose `kv_cache_dtype` param
  is set serves the same streams as the engine override.
- An attention/SSM hybrid with int8 pools: the same against JAX; the SSM
  slot states stay float32.
- `GShardDecode` on DenseLmTiny with a bfloat16 and an int8 cache (the
  `kv_cache_dtype` param; paged read, page 4): continuations equal the
  JAX decoder's from the same checkpointed theta, with the reference's
  `kv_cache_dtype` and `kv_bytes_per_token` telemetry.
"""

import numpy as np
import pytest
import torch

from lingvo_tpu.core import attention as jax_attention
from lingvo_tpu.models.lm.params import synthetic_packed_input as jax_spi
from lingvo_tpu.runners import gshard_decode as jax_gshard
from lingvo_tpu.serving import engine as jax_engine
from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import attention
from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
from lingvo_tpu_torch.runners import gshard_decode
from lingvo_tpu_torch.serving import engine

from tests.conftest import InstantiateLm, TinyLmParams
from tests.test_torch_gshard_decode import (_LENS, _PROMPTS, _STEPS,
                                            checkpoints)  # noqa: F401
from tests.test_torch_legacy_serving import (_ENGINE_KW, _Noised,
                                             _PortParams, _Prompts)

_COUNTS = ("steps", "decode_steps", "mixed_steps", "tokens_emitted",
           "prompt_tokens", "quantized_steps")
_KW = dict(_ENGINE_KW, num_pages=12)   # fewer pages than the requests use


@pytest.fixture(scope="module")
def dense_lm_tiny():
  """DenseLmTiny: the reference's task with a noised theta, and the
  port's carrying the same theta."""
  task, theta = InstantiateLm(jax_spi.DenseLmTiny().Task(), seed=5)
  theta = _Noised(theta, seed=2, scale=0.3)
  lm = spi.DenseLmTiny().Task().Instantiate(device="cpu")
  convert.LoadJaxTheta(lm, theta)
  return task, theta, lm


def _ServeBoth(task, theta, lm, dtype, step_mode, max_new=8, **kw):
  """(port streams, port Stats, JAX streams, JAX Stats)."""
  prompts, lens = _Prompts(task.p.vocab_size)
  j_eng = jax_engine.ServingLoop(task, theta, trace=False,
                                 step_mode=step_mode, kv_cache_dtype=dtype,
                                 **_KW)
  want = j_eng.RunBatch(prompts, lens, max_new_tokens=max_new)
  eng = engine.ServingLoop(lm, device="cpu", step_mode=step_mode,
                           kv_cache_dtype=dtype, **_KW, **kw)
  got = eng.RunBatch(prompts, lens, max_new_tokens=max_new)
  return got, eng.Stats(), want, j_eng.Stats()


@pytest.mark.parametrize("step_mode", ["ragged", "legacy"])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_streams_match_reference(dtype, step_mode, dense_lm_tiny):
  task, theta, lm = dense_lm_tiny
  got, stats, want, j_stats = _ServeBoth(task, theta, lm, dtype, step_mode)
  assert len(np.unique(want)) > 6   # not one echo per row
  np.testing.assert_array_equal(got, want)
  for key in _COUNTS + ("kv_cache_dtype", "kv_bytes_per_token"):
    assert stats[key] == j_stats[key], key
  assert stats["kv_cache_dtype"] == dtype
  assert stats["quantized_steps"] == (stats["steps"] if dtype == "int8"
                                      else 0)
  assert stats["paged_path"] == ("plain-int8" if dtype == "int8" else
                                 "plain")
  assert j_stats["paged_path"] == ("xla-int8" if dtype == "int8" else "xla")
  assert stats["kv_pages"]["in_use"] == 0
  assert stats["scheduler"]["finished"] == 6
  # the requests' pages in all outnumber the pool's: some were reused
  _, lens = _Prompts(task.p.vocab_size)
  assert sum(-(-(n + 8) // 8) for n in lens) > _KW["num_pages"]
  assert stats["kv_pages"]["page_bytes"] == 8 * stats["kv_bytes_per_token"]


def test_lm_param_serves_like_the_engine_override(dense_lm_tiny):
  """kv_cache_dtype set on the LM (every attention layer) instead of the
  engine: the same pools and the same streams, in both step modes."""
  task, theta, lm = dense_lm_tiny
  p = spi.DenseLmTiny().Task().Set(kv_cache_dtype="int8")
  lm8 = p.Instantiate(device="cpu")
  lm8.load_state_dict(lm.state_dict())
  prompts, lens = _Prompts(task.p.vocab_size)
  for step_mode in ("ragged", "legacy"):
    eng = engine.ServingLoop(lm8, device="cpu", step_mode=step_mode, **_KW)
    assert eng.Stats()["kv_cache_dtype"] == "int8"
    assert eng._states.body.self_atten.key.dtype == torch.int8
    over = engine.ServingLoop(lm, device="cpu", step_mode=step_mode,
                              kv_cache_dtype="int8", **_KW)
    np.testing.assert_array_equal(
        eng.RunBatch(prompts, lens, max_new_tokens=6),
        over.RunBatch(prompts, lens, max_new_tokens=6))


def test_hybrid_int8_streams_match_reference():
  task, theta = InstantiateLm(TinyLmParams(every_n=2), seed=3)
  theta = _Noised(theta)
  lm = _PortParams(task.p).Instantiate(device="cpu")
  convert.LoadJaxTheta(lm, theta)
  got, stats, want, j_stats = _ServeBoth(task, theta, lm, "int8", "ragged",
                                         max_new=6)
  np.testing.assert_array_equal(got, want)
  for key in _COUNTS + ("kv_cache_dtype", "kv_bytes_per_token", "mixers"):
    assert stats[key] == j_stats[key], key
  leaves = dict(lm.InitPagedDecodeState(5, 8, 2, "int8").FlattenItems())
  assert {str(v.dtype) for k, v in leaves.items() if k.endswith("state")} == {
      "torch.float32"}
  assert {str(v.dtype) for k, v in leaves.items() if k.endswith(".key")} == {
      "torch.int8"}


def _Tiny(jax_side, dtype):
  """DenseLmTiny with a paged read (page 4) and `dtype` caches."""
  mod, atten = (jax_spi, jax_attention) if jax_side else (spi, attention)
  p = mod.DenseLmTiny().Task().Set(kv_cache_dtype=dtype)
  p.atten_tpl = atten.MultiHeadedAttention.Params().Set(decode_page_size=4)
  if jax_side:
    task = p.Instantiate()
    task.FinalizePaths()
    return task
  lm = p.Instantiate(device="cpu")
  lm.InstantiateVariables(torch.Generator("cpu").manual_seed(9))
  return lm


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_gshard_decode_continuations_match_reference(dtype, checkpoints):
  root, port_dir, _ = checkpoints
  want = jax_gshard.GShardDecode(
      _Tiny(True, dtype), str(root / "jax"), str(root / f"jax_{dtype}.jsonl"),
      max_decode_steps=_STEPS, prefill_chunk_size=3).DecodeOnce(
          1, _PROMPTS, _LENS)
  got = gshard_decode.GShardDecode(
      _Tiny(False, dtype), port_dir, str(root / f"port_{dtype}.jsonl"),
      max_decode_steps=_STEPS, prefill_chunk_size=3).DecodeOnce(
          1, _PROMPTS, _LENS)
  assert len({tuple(r["output_ids"]) for r in want}) > 1
  assert [r["output_ids"] for r in got] == [r["output_ids"] for r in want]
  tel, ref = got[0]["telemetry"], want[0]["telemetry"]
  for key in ("kv_cache_dtype", "kv_bytes_per_token"):
    assert tel[key] == ref[key], key
  assert tel["kv_cache_dtype"] == dtype
