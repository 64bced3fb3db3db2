"""The legacy serving step mode of lingvo_tpu_torch against JAX.

- `TransformerLm.PagedStep` at C > 1 (a mixed prefill step: rows at
  several prompt offsets, a decode row, an idle row) and then C = 1 (a
  decode step) matches the reference's logits at the valid columns and
  its KV pools and SSM slot states, on the conftest tiny LM as a repeat
  stack, a stack of distinct layers, an attention/SSM hybrid and a pure
  SSM stack (float32, atol/rtol 1e-4: two layers of projections, rotary
  and the tied head accumulate the per-op differences). `PagedStep`
  dispatches per mixer, so the SSM layers serve through their own step.
- The scheduler's `BuildStep` / `CommitStep`, device-free, give the same
  [B, C] steps, block tables, events and stats as the reference's.
- `ServingLoop(step_mode='legacy')` greedy streams on DenseLmTiny are
  token-identical to the JAX `ServingLoop(step_mode='legacy')` streams
  and to the port's ragged engine's streams, with the same step counts
  as the reference; the pure SSM stack serves in legacy mode too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lingvo_tpu.serving import engine as jax_engine
from lingvo_tpu.serving import kv_cache as jax_kv_cache
from lingvo_tpu.serving import scheduler as jax_scheduler
from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import ssm
from lingvo_tpu_torch.models.lm import layers as lm_layers
from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
from lingvo_tpu_torch.serving import engine
from lingvo_tpu_torch.serving import kv_cache
from lingvo_tpu_torch.serving import scheduler

from tests.conftest import InstantiateLm, TinyLmParams


def _Noised(theta, seed=0, scale=0.5):
  """theta as numpy with seeded noise on every leaf: a fresh model echoes
  one token per stream, which would make stream identity a weak check."""
  rng = np.random.RandomState(seed)
  return jax.tree_util.tree_map(
      lambda x: np.asarray(x) + scale * rng.randn(*x.shape).astype(np.float32),
      theta)


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
    "repeat": dict(),
    "stacked": dict(use_repeat_layer=False),
    "hybrid": dict(every_n=2),
    "pure_ssm": dict(every_n=0),
}


@pytest.fixture(scope="module")
def stacks():
  """{stack: (JAX task, noised theta, the port's LM)} over _STACKS."""
  out = {}
  for name, kw in _STACKS.items():
    task, theta = InstantiateLm(TinyLmParams(**kw), seed=3)
    theta = _Noised(theta)
    lm = _PortParams(task.p).Instantiate(device="cpu")
    convert.LoadJaxTheta(lm, theta)
    out[name] = (task, theta, lm)
  return out


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


@pytest.mark.parametrize("stack", sorted(_STACKS))
def test_paged_step_matches_reference(stack, stacks):
  """A mixed [3, 5] step (prefill from 0, a row mid-prompt, an idle row),
  then a decode-only [3, 1] step over what it wrote."""
  task, theta, lm = stacks[stack]
  page, n_pages, b = 4, 16, 3
  rng = np.random.RandomState(1)
  tables = rng.permutation(n_pages)[:b * 4].reshape(b, 4).astype(np.int32)
  j_states = task.InitPagedDecodeState(theta, n_pages + 1, page, b)
  t_states = lm.InitPagedDecodeState(n_pages + 1, page, b)
  for c, q_pos, in_len in ((5, [0, 4, 0], [5, 3, 0]),
                           (1, [5, 7, 0], [1, 1, 0])):
    ids = rng.randint(0, task.p.vocab_size, size=(b, c)).astype(np.int32)
    args = [np.asarray(a, np.int32) for a in (tables, q_pos, in_len)]
    j_logits, j_states = jax.jit(task.PagedStep)(
        theta, jnp.asarray(ids), j_states, *(jnp.asarray(a) for a in args))
    t_logits, t_states = lm.PagedStep(
        torch.as_tensor(ids), t_states, *(torch.as_tensor(a) for a in args))
    valid = np.arange(c)[None] < np.asarray(in_len)[:, None]
    np.testing.assert_allclose(t_logits.numpy()[valid],
                               np.asarray(j_logits)[valid],
                               atol=1e-4, rtol=1e-4)
    _AssertStatesClose(j_states, t_states)


@pytest.mark.parametrize("chunk", [3, 8])
def test_scheduler_legacy_steps_match_reference(chunk):
  """Same requests and fabricated draws: the same [B, C] steps, block
  tables, events and stats as the reference scheduler, step for step,
  under pool pressure."""
  rng = np.random.RandomState(chunk)
  reqs = [(rng.randint(0, 50, size=rng.randint(1, 20)).tolist(),
           int(rng.randint(1, 6)), 7 if i % 3 == 0 else None)
          for i in range(9)]
  j = jax_scheduler.Scheduler(3, jax_kv_cache.PageAllocator(12, 4), 8, chunk)
  t = scheduler.Scheduler(3, kv_cache.PageAllocator(12, 4), 8)
  for i, (prompt, max_new, eos) in enumerate(reqs):
    j.Submit(jax_scheduler.Request(i, prompt, max_new, eos))
    t.Submit(scheduler.Request(i, prompt, max_new, eos))
  steps = 0
  while j.HasWork():
    assert t.HasWork()
    assert [s.id for s in j.Admit()] == [s.id for s in t.Admit()]
    jb, tb = j.BuildStep(), t.BuildStep(chunk)
    for name in ("ids", "q_pos", "in_len"):
      np.testing.assert_array_equal(getattr(jb, name), getattr(tb, name))
    np.testing.assert_array_equal(j.block_tables, t.block_tables)
    assert (jb.mixed, jb.prompt_tokens) == (tb.mixed, tb.prompt_tokens)
    sampled = rng.randint(0, 10, size=jb.ids.shape).astype(np.int32)
    assert j.CommitStep(jb, sampled) == t.CommitStep(tb, sampled)
    steps += 1
  assert not t.HasWork() and steps > len(reqs)
  t_stats, j_stats = t.Stats(), j.Stats()
  assert {k: j_stats[k] for k in t_stats} == t_stats
  assert t.BuildStep(chunk) is None


_PROMPT_LENS = [3, 11, 17, 6, 9, 1]
_ENGINE_KW = dict(page_size=8, num_pages=24, max_batch=4, max_seq_len=32,
                  prefill_chunk=8)


def _Prompts(vocab, seed=1):
  rng = np.random.RandomState(seed)
  prompts = np.zeros((len(_PROMPT_LENS), max(_PROMPT_LENS)), np.int32)
  for i, n in enumerate(_PROMPT_LENS):
    prompts[i, :n] = rng.randint(1, vocab, size=n)
  return prompts, np.asarray(_PROMPT_LENS, np.int32)


@pytest.fixture(scope="module")
def dense_lm_tiny():
  """DenseLmTiny: the reference's task with a noised theta, and the
  port's DenseLmTiny task carrying the same theta."""
  from lingvo_tpu.models.lm.params import synthetic_packed_input as jax_spi
  task, theta = InstantiateLm(jax_spi.DenseLmTiny().Task(), seed=5)
  theta = _Noised(theta, seed=2, scale=0.3)
  lm = spi.DenseLmTiny().Task().Instantiate(device="cpu")
  convert.LoadJaxTheta(lm, theta)
  return task, theta, lm


def test_legacy_streams_match_reference_and_ragged(dense_lm_tiny):
  task, theta, lm = dense_lm_tiny
  prompts, lens = _Prompts(task.p.vocab_size)
  j_eng = jax_engine.ServingLoop(task, theta, trace=False,
                                 step_mode="legacy", **_ENGINE_KW)
  want = j_eng.RunBatch(prompts, lens, max_new_tokens=8)
  assert len(np.unique(want)) > len(_PROMPT_LENS)   # not one echo per row
  eng = engine.ServingLoop(lm, device="cpu", step_mode="legacy", **_ENGINE_KW)
  got = eng.RunBatch(prompts, lens, max_new_tokens=8)
  np.testing.assert_array_equal(got, want)
  ragged = engine.ServingLoop(lm, device="cpu", **_ENGINE_KW).RunBatch(
      prompts, lens, max_new_tokens=8)
  np.testing.assert_array_equal(got, ragged)
  stats, j_stats = eng.Stats(), j_eng.Stats()
  for key in ("steps", "decode_steps", "mixed_steps", "tokens_emitted",
              "prompt_tokens"):
    assert stats[key] == j_stats[key], key
  assert stats["mixed_steps"] > 0 and stats["decode_steps"] > 0
  assert stats["paged_path"] == "plain"
  assert stats["kv_pages"]["in_use"] == 0


def test_pure_ssm_stack_serves_in_legacy_mode(stacks):
  """The pageless stack through PagedStep: the same streams as the
  reference's legacy engine and the port's ragged engine."""
  task, theta, lm = stacks["pure_ssm"]
  prompts, lens = _Prompts(task.p.vocab_size, seed=3)
  want = jax_engine.ServingLoop(
      task, theta, trace=False, step_mode="legacy", **_ENGINE_KW).RunBatch(
          prompts, lens, max_new_tokens=6)
  eng = engine.ServingLoop(lm, device="cpu", step_mode="legacy", **_ENGINE_KW)
  got = eng.RunBatch(prompts, lens, max_new_tokens=6)
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, engine.ServingLoop(
      lm, device="cpu", **_ENGINE_KW).RunBatch(prompts, lens,
                                               max_new_tokens=6))
  assert eng.Stats()["paged_path"] == "ssm"
