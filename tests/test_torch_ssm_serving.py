"""The serving engine over the SSM-hybrid stacks against JAX.

- `ServingLoop.RunBatch` greedy streams token-identical to the JAX
  `ServingLoop` for the hybrid (attention every 2nd layer, noised theta)
  and the pageless pure-SSM engine, with the mixer census, the state-slot
  pool and the scheduler's `needs_kv_pages` equal to the reference's.
- The page price `kv_bytes_per_token` counts only the attention layers'
  K/V and equals the reference's `quant/kv.StackKvCensus`.
- Pageless admission, `StateSlotPool`, and the `DenseLmSsmHybrid` widths.

The models are the ones tests/test_torch_ssm.py holds step for step
against JAX (its `hybrids` fixture).
"""

import numpy as np
import pytest

from lingvo_tpu.models.lm.params import synthetic_packed_input as jax_spi
from lingvo_tpu.observe import schema as observe_schema
from lingvo_tpu.quant import kv as jax_kv
from lingvo_tpu.serving import engine as jax_engine
from lingvo_tpu_torch.core import ssm
from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
from lingvo_tpu_torch.serving import engine
from lingvo_tpu_torch.serving import kv_cache

from tests.test_torch_ssm import _STACKS, hybrids  # noqa: F401 (fixture)

_PROMPT_LENS = [3, 11, 17, 6, 9, 1]
_ENGINE_KW = dict(page_size=8, num_pages=24, max_batch=4, max_seq_len=32,
                  prefill_chunk=8)


def _Prompts(vocab, seed=1):
  rng = np.random.RandomState(seed)
  prompts = np.zeros((len(_PROMPT_LENS), max(_PROMPT_LENS)), np.int32)
  for i, n in enumerate(_PROMPT_LENS):
    prompts[i, :n] = rng.randint(1, vocab, size=n)
  return prompts, np.asarray(_PROMPT_LENS, np.int32)


@pytest.mark.parametrize("stack", ["flat", "pure_ssm"])
def test_run_batch_greedy_streams_token_identical(stack, hybrids):
  task, theta, lm = hybrids[stack]
  prompts, lens = _Prompts(task.p.vocab_size)
  j_eng = jax_engine.ServingLoop(task, theta, trace=False, **_ENGINE_KW)
  want = j_eng.RunBatch(prompts, lens, max_new_tokens=8)
  assert len(np.unique(want)) > len(_PROMPT_LENS)   # not one echo per row
  eng = engine.ServingLoop(lm, device="cpu", **_ENGINE_KW)
  got = eng.RunBatch(prompts, lens, max_new_tokens=8)
  np.testing.assert_array_equal(got, want)
  stats, j_stats = eng.Stats(), j_eng.Stats()
  assert stats["mixers"] == j_stats["mixers"] == j_eng.mixers
  assert stats["paged_path"] == ("ssm" if stack == "pure_ssm" else "plain")
  assert (j_stats["paged_path"] == "ssm") == (stack == "pure_ssm")
  assert stats["kv_bytes_per_token"] == j_stats["kv_bytes_per_token"]
  assert stats["state_slots"] == j_stats["state_slots"]
  assert stats["state_slots"]["in_use"] == 0   # released on retirement
  assert stats["state_slots"]["peak_in_use"] == _ENGINE_KW["max_batch"]
  assert stats["scheduler"]["needs_kv_pages"] == (stack != "pure_ssm")
  assert stats["kv_pages"] == {k: j_stats["kv_pages"][k]
                               for k in stats["kv_pages"]}
  assert set(stats) <= (observe_schema.ENGINE_STATS_REQUIRED
                        | observe_schema.ENGINE_STATS_OPTIONAL)
  assert set(stats["scheduler"]) <= set(observe_schema.SCHEDULER_STATS_KEYS)


@pytest.mark.parametrize("stack", sorted(_STACKS))
def test_kv_bytes_per_token_prices_only_attention(stack, hybrids):
  """The page price equals the reference's StackKvCensus: 2 N H float32
  per attention layer and token, nothing for the SSM slot states (which
  the old sum over every state leaf divided by the pool slots charged)."""
  task, _, lm = hybrids[stack]
  eng = engine.ServingLoop(lm, device="cpu", **_ENGINE_KW)
  census = jax_kv.StackKvCensus(task)
  assert eng.kv_bytes_per_token == census["kv_bytes_per_token"]
  assert eng.mixers["num_attention"] == census["attention_layers"]
  p = task.p
  per_layer = 2 * p.model_dim * 4
  assert eng.kv_bytes_per_token == per_layer * eng.mixers["num_attention"]
  assert eng.alloc.page_bytes == _ENGINE_KW["page_size"] * (
      eng.kv_bytes_per_token)
  all_leaves = sum(x.numel() * x.element_size()
                   for x in eng._states.Flatten())
  pool_slots = (_ENGINE_KW["num_pages"] + 1) * _ENGINE_KW["page_size"]
  assert all_leaves // pool_slots > eng.kv_bytes_per_token


def test_pure_ssm_admits_pageless(hybrids):
  """With a pool of one page, the pure-SSM stack still admits the whole
  batch at once: admission is bounded by slots, the allocator is never
  charged."""
  _, _, lm = hybrids["pure_ssm"]
  eng = engine.ServingLoop(lm, device="cpu", page_size=4, num_pages=1,
                           max_batch=3, max_seq_len=16, prefill_chunk=4)
  for i in range(3):
    eng.Submit([5 + i, 6, 7, 8], 4, eos_id=None)
  eng.StepOnce()
  stats = eng.Stats()
  assert stats["scheduler"]["slots_live"] == 3
  assert stats["kv_pages"]["in_use"] == 0
  assert stats["state_slots"]["in_use"] == 3


def test_state_slot_pool():
  pool = kv_cache.StateSlotPool(2, 100)
  pool.Acquire("a", 1)
  with pytest.raises(AssertionError):
    pool.Acquire("b", 1)
  assert pool.num_in_use == 1 and pool.num_free == 1
  assert pool.Release("a") and not pool.Release("a")
  assert pool.Stats() == {"num_slots": 2, "bytes_per_slot": 100, "in_use": 0,
                          "free": 2, "peak_in_use": 1,
                          "state_bytes_in_use": 0}


@pytest.mark.parametrize("name", ["DenseLmSsmHybrid", "DenseLmSsmHybridTiny"])
def test_hybrid_configs_match_the_reference(name):
  """The served configurations at the reference's widths."""
  def Fields(p):
    return (p.model_dim, p.num_layers, p.num_heads, p.hidden_dim,
            p.vocab_size, p.mixer_atten_every_n, p.mixer_tpl.state_dim,
            p.mixer_tpl.chunk_size, p.use_repeat_layer, p.use_rotary)
  p = getattr(spi, name)().Task()
  assert Fields(p) == Fields(getattr(jax_spi, name)().Task())
  if name == "DenseLmSsmHybrid":
    assert Fields(p)[:8] == (1024, 12, 16, 4096, 32000, 6, 64, 64)
  else:
    tiny = p.Instantiate(device="cpu")
    assert isinstance(tiny.stack.body[0].x_layers[0].self_atten.atten,
                      ssm.GatedSSMLayer)
