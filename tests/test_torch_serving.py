"""The served LM and the serving engine of lingvo_tpu_torch against JAX.

- `TransformerLm.RaggedStep` logits and updated KV pools match the
  reference on the conftest `TinyLmParams` repeat stack (float32, atol
  1e-4 / rtol 1e-4: 2 layers of projections, rotary and the tied head
  accumulate the per-op differences).
- `ServingLoop.RunBatch` greedy streams are token-identical to the JAX
  `ServingLoop.RunBatch` on the same prompts, and the async front door
  gives the same streams.
- `convert.LoadJaxTheta` consumes every reference leaf exactly once.
- Entry points never fall back to the CPU unasked, unported features
  raise, and the port imports neither jax nor lingvo_tpu.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lingvo_tpu.core import ragged as jax_ragged
from lingvo_tpu.observe import schema as observe_schema
from lingvo_tpu.serving import engine as jax_engine
from lingvo_tpu.serving import kv_cache as jax_kv_cache
from lingvo_tpu.serving import scheduler as jax_scheduler
from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import ragged
from lingvo_tpu_torch.models.lm import layers as lm_layers
from lingvo_tpu_torch.models.lm.params import synthetic_packed_input
from lingvo_tpu_torch.serving import engine
from lingvo_tpu_torch.serving import kv_cache
from lingvo_tpu_torch.serving import scheduler

from tests.conftest import InstantiateLm, TinyLmParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _PortParams(jax_p):
  """The port's TransformerLm Params with the reference's model fields."""
  return lm_layers.TransformerLm.Params().Set(
      name=jax_p.name, vocab_size=jax_p.vocab_size,
      model_dim=jax_p.model_dim, num_layers=jax_p.num_layers,
      num_heads=jax_p.num_heads, hidden_dim=jax_p.hidden_dim,
      use_rotary=jax_p.use_rotary, use_repeat_layer=jax_p.use_repeat_layer)


def _ThetaNp(theta):
  return jax.tree_util.tree_map(np.asarray, theta)


@pytest.fixture(scope="module")
def served_theta(tiny_lm):
  """The tiny LM's theta with seeded noise on every leaf: the freshly
  initialized model echoes one token per stream, which would make stream
  identity a weak check; these weights give varied greedy streams."""
  rng = np.random.RandomState(0)
  return jax.tree_util.tree_map(
      lambda x: np.asarray(x) + 0.5 * rng.randn(*x.shape).astype(np.float32),
      tiny_lm[1])


@pytest.fixture(scope="module")
def port_lm(tiny_lm, served_theta):
  lm = _PortParams(tiny_lm[0].p).Instantiate(device="cpu")
  convert.LoadJaxTheta(lm, served_theta)
  return lm


@pytest.fixture(scope="module")
def stacked_lm():
  """The same tiny LM with distinct (stacked) layers instead of a repeat."""
  task, theta = InstantiateLm(TinyLmParams(use_repeat_layer=False), seed=3)
  port = _PortParams(task.p).Instantiate(device="cpu")
  convert.LoadJaxTheta(port, _ThetaNp(theta))
  return task, theta, port


@pytest.mark.parametrize("stack", ["repeat", "stacked"])
def test_ragged_step_matches_reference(stack, tiny_lm, served_theta, port_lm,
                                       request):
  """Two steps through the stack: a prefill-heavy pack, then a pack that
  reads the pools the first one wrote."""
  if stack == "repeat":
    task, theta = tiny_lm[0], served_theta
    assert task.p.use_repeat_layer
  else:
    task, theta, port_lm = request.getfixturevalue("stacked_lm")
  page, n_pages, b = 8, 16, 3
  rng = np.random.RandomState(0)
  tables = rng.permutation(n_pages)[:b * 4].reshape(b, 4).astype(np.int32)
  j_states = task.InitPagedDecodeState(theta, n_pages + 1, page, b)
  t_states = port_lm.InitPagedDecodeState(n_pages + 1, page, b)
  for row_lens, q_pos in (([6, 9, 0], [0, 0, 1]), ([1, 4, 2], [6, 9, 0])):
    rows = jax_ragged.BuildRaggedRows(row_lens, q_pos, 16, 9)
    ids = rng.randint(0, task.p.vocab_size, size=(1, 16)).astype(np.int32)
    j_logits, j_states = task.RaggedStep(
        theta, jnp.asarray(ids), j_states, jnp.asarray(tables),
        jax_ragged.RaggedRows(*(jnp.asarray(m) for m in rows)))
    with torch.no_grad():
      t_logits, t_states = port_lm.RaggedStep(
          torch.as_tensor(ids), t_states, torch.as_tensor(tables),
          ragged.ToTorch(rows, "cpu"))
    valid = np.asarray(rows.valid)
    np.testing.assert_allclose(np.asarray(j_logits)[0, valid],
                               t_logits[0, torch.as_tensor(valid)].numpy(),
                               atol=1e-4, rtol=1e-4)
    # same pool tree; the last page of each pool is the trash page
    # (padding writes in an unspecified order)
    j_items = dict(j_states.FlattenItems())
    t_items = dict(t_states.FlattenItems())
    assert sorted(j_items) == sorted(t_items)
    for k, j_pool in j_items.items():
      j_pool, t_pool = np.asarray(j_pool), t_items[k].numpy()
      assert j_pool.shape == t_pool.shape
      np.testing.assert_allclose(j_pool[..., :-1, :, :, :],
                                 t_pool[..., :-1, :, :, :],
                                 atol=1e-4, rtol=1e-4)


_PROMPT_LENS = [3, 11, 17, 6, 9, 1]


def _Prompts(vocab, seed=1):
  rng = np.random.RandomState(seed)
  prompts = np.zeros((len(_PROMPT_LENS), max(_PROMPT_LENS)), np.int32)
  for i, n in enumerate(_PROMPT_LENS):
    prompts[i, :n] = rng.randint(1, vocab, size=n)
  return prompts, np.asarray(_PROMPT_LENS, np.int32)


_ENGINE_KW = dict(page_size=8, num_pages=24, max_batch=4, max_seq_len=32,
                  prefill_chunk=8)


@pytest.fixture(scope="module")
def jax_streams(tiny_lm, served_theta):
  task = tiny_lm[0]
  prompts, lens = _Prompts(task.p.vocab_size)
  eng = jax_engine.ServingLoop(task, served_theta, trace=False, **_ENGINE_KW)
  out = eng.RunBatch(prompts, lens, max_new_tokens=8)
  assert len(np.unique(out)) > len(_PROMPT_LENS)   # not one echo per row
  return out


def test_run_batch_greedy_streams_token_identical(tiny_lm, port_lm,
                                                  jax_streams):
  prompts, lens = _Prompts(tiny_lm[0].p.vocab_size)
  eng = engine.ServingLoop(port_lm, device="cpu", **_ENGINE_KW)
  out = eng.RunBatch(prompts, lens, max_new_tokens=8)
  np.testing.assert_array_equal(out, jax_streams)
  stats = eng.Stats()
  assert stats["scheduler"]["finished"] == len(_PROMPT_LENS)
  assert stats["tokens_emitted"] == 8 * len(_PROMPT_LENS)
  assert stats["prompt_tokens"] == sum(_PROMPT_LENS)
  assert stats["mixed_steps"] > 0 and stats["decode_steps"] > 0
  assert stats["kv_pages"]["in_use"] == 0   # every page came back
  # the port's Stats() keys are a subset of the reference's schema
  assert set(stats) <= (observe_schema.ENGINE_STATS_REQUIRED
                        | observe_schema.ENGINE_STATS_OPTIONAL)
  assert set(stats["scheduler"]) <= set(observe_schema.SCHEDULER_STATS_KEYS)


@pytest.mark.parametrize("budget", [4, 16])
def test_scheduler_matches_reference(budget):
  """The fifo scheduler, device-free: the same requests and the same
  fabricated draws give the same packs, block tables, events and stats
  as the reference scheduler, step for step, under pool pressure."""
  rng = np.random.RandomState(budget)
  reqs = [(rng.randint(0, 50, size=rng.randint(1, 20)).tolist(),
           int(rng.randint(1, 6)), 7 if i % 3 == 0 else None)
          for i in range(9)]
  j = jax_scheduler.Scheduler(3, jax_kv_cache.PageAllocator(12, 4), 8, 4)
  t = scheduler.Scheduler(3, kv_cache.PageAllocator(12, 4), 8)
  for i, (prompt, max_new, eos) in enumerate(reqs):
    j.Submit(jax_scheduler.Request(i, prompt, max_new, eos))
    t.Submit(scheduler.Request(i, prompt, max_new, eos))
  steps = 0
  while j.HasWork():
    assert t.HasWork()
    assert [s.id for s in j.Admit()] == [s.id for s in t.Admit()]
    jb = j.BuildRaggedStep(3 + budget, budget)
    tb = t.BuildRaggedStep(3 + budget, budget)
    np.testing.assert_array_equal(jb.tok_ids, tb.tok_ids)
    for a, b in zip(jb.rows_desc, tb.rows_desc):
      np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(j.block_tables, t.block_tables)
    assert (jb.mixed, jb.prompt_tokens) == (tb.mixed, tb.prompt_tokens)
    sampled = rng.randint(0, 10, size=3 + budget).astype(np.int32)
    assert j.CommitRaggedStep(jb, sampled) == t.CommitRaggedStep(tb, sampled)
    steps += 1
  assert not t.HasWork() and steps > len(reqs)
  t_stats, j_stats = t.Stats(), j.Stats()
  assert {k: j_stats[k] for k in t_stats} == t_stats
  assert t.alloc.Stats() == {k: j.alloc.Stats()[k] for k in t.alloc.Stats()}


def test_async_streams_match_run_batch(tiny_lm, port_lm, jax_streams):
  prompts, lens = _Prompts(tiny_lm[0].p.vocab_size)
  eng = engine.ServingLoop(port_lm, device="cpu", **_ENGINE_KW).Start()
  try:
    handles = [eng.Submit(prompts[i, :n], 8, eos_id=None)
               for i, n in enumerate(lens)]
    streamed = list(handles[0].Tokens(timeout=60))   # token by token
    streams = [h.Result(timeout=60) for h in handles]
    assert streamed == streams[0]
  finally:
    eng.Stop()
  assert eng._thread is None
  np.testing.assert_array_equal(np.asarray(streams), jax_streams)


def test_load_jax_theta_consumes_every_leaf_once(tiny_lm):
  task, theta = tiny_lm
  lm = _PortParams(task.p).Instantiate(device="cpu")
  with torch.no_grad():
    for prm in lm.parameters():
      prm.fill_(float("nan"))
  loaded = convert.LoadJaxTheta(lm, _ThetaNp(theta))
  # each repeat leaf is consumed once per layer slice, every other once
  n = task.p.num_layers
  unstacked = [p.replace(f"body[{i}]", "body") for p in loaded
               for i in range(n) if f"body[{i}]" in p]
  others = [p for p in loaded if "body[" not in p]
  leaves = [k for k, _ in theta.FlattenItems()]
  assert sorted(others + sorted(set(unstacked))) == sorted(leaves)
  assert all(unstacked.count(k) == n for k in set(unstacked))
  assert len(loaded) == len(list(lm.parameters()))
  assert all(torch.isfinite(prm).all() for prm in lm.parameters())


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_jax_theta_rejects_bad_theta(tiny_lm, fault):
  task, theta = tiny_lm
  lm = _PortParams(task.p).Instantiate(device="cpu")
  bad = _ThetaNp(theta)
  if fault == "missing":
    del bad["final_ln"]["bias"]
  elif fault == "extra":
    bad["final_ln"]["gain"] = np.zeros((task.p.model_dim,), np.float32)
  else:
    bad["emb"]["emb"] = bad["emb"]["emb"][:, :-1]
  with pytest.raises(ValueError):
    convert.LoadJaxTheta(lm, bad)


def test_entry_points_raise_without_cuda():
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default device is valid")
  p = synthetic_packed_input.DenseLmTiny().Task()
  with pytest.raises(RuntimeError, match="CUDA"):
    p.Instantiate()
  lm = p.Instantiate(device="cpu")
  with pytest.raises(RuntimeError, match="CUDA"):
    engine.ServingLoop(lm, page_size=8, num_pages=8, max_batch=2,
                       max_seq_len=16)


@pytest.mark.parametrize("kw, match", [
    (dict(spec=object()), "speculative"),
    (dict(prefix_cache=True), "prefix cache"),
    (dict(scheduler_mode="priority"), "priority"),
    (dict(step_mode="legacy", spec=object()), "speculative"),
])
def test_unported_engine_features_raise(kw, match):
  lm = synthetic_packed_input.DenseLmTiny().Task().Instantiate(device="cpu")
  with pytest.raises(NotImplementedError, match=match):
    engine.ServingLoop(lm, page_size=8, num_pages=8, max_batch=2,
                       max_seq_len=16, device="cpu", **kw)


@pytest.mark.parametrize("field, value", [
    ("num_experts", 4), ("bidirectional", True)])
def test_unported_model_features_raise(field, value):
  p = synthetic_packed_input.DenseLmTiny().Task().Set(**{field: value})
  with pytest.raises(NotImplementedError):
    p.Instantiate(device="cpu")


def _FieldTwins(seed, **fields):
  """(reference task, noised theta, port LM) of TinyLmParams with
  `fields` set on both sides."""
  task, theta = InstantiateLm(TinyLmParams(**fields), seed=seed)
  rng = np.random.RandomState(seed)
  theta = jax.tree_util.tree_map(
      lambda x: np.asarray(x) + 0.5 * rng.randn(*x.shape).astype(np.float32),
      theta)
  port = _PortParams(task.p).Set(**fields).Instantiate(device="cpu")
  convert.LoadJaxTheta(port, theta)
  return task, theta, port


def _CompareServing(task, theta, port):
  """One packed RaggedStep's logits, then the engine's greedy streams,
  against the reference's."""
  rng = np.random.RandomState(4)
  tables = rng.permutation(16)[:12].reshape(3, 4).astype(np.int32)
  rows = jax_ragged.BuildRaggedRows([6, 9, 1], [0, 0, 3], 16, 9)
  ids = rng.randint(0, task.p.vocab_size, size=(1, 16)).astype(np.int32)
  j_logits, _ = task.RaggedStep(
      theta, jnp.asarray(ids), task.InitPagedDecodeState(theta, 17, 8, 3),
      jnp.asarray(tables),
      jax_ragged.RaggedRows(*(jnp.asarray(m) for m in rows)))
  with torch.no_grad():
    t_logits, _ = port.RaggedStep(
        torch.as_tensor(ids), port.InitPagedDecodeState(17, 8, 3),
        torch.as_tensor(tables), ragged.ToTorch(rows, "cpu"))
  valid = np.asarray(rows.valid)
  np.testing.assert_allclose(np.asarray(j_logits)[0, valid],
                             t_logits[0, torch.as_tensor(valid)].numpy(),
                             atol=1e-4, rtol=1e-4)
  prompts, lens = _Prompts(task.p.vocab_size)
  want = jax_engine.ServingLoop(task, theta, trace=False,
                                **_ENGINE_KW).RunBatch(prompts, lens,
                                                       max_new_tokens=8)
  got = engine.ServingLoop(port, device="cpu", **_ENGINE_KW).RunBatch(
      prompts, lens, max_new_tokens=8)
  np.testing.assert_array_equal(got, want)
  return t_logits


def test_sampled_softmax_task_serves_through_its_untied_head():
  """A sampled-softmax task serves through the head it trained, the
  untied [V, D] table and its bias, as the reference's does: the packed
  step's logits and the engine's streams match the reference's."""
  task, theta, port = _FieldTwins(5, softmax_num_sampled=8)
  assert "sampled_softmax" in theta
  logits = _CompareServing(task, theta, port)
  with torch.no_grad():
    tied = port.emb.Logits(torch.zeros(1, 32))
  assert logits.shape[-1] == tied.shape[-1] == task.p.vocab_size


@pytest.mark.parametrize("field, value, match", [
    ("atten_dropout_prob", 0.1, "attention dropout")])
def test_unservable_attention_configs_raise(field, value, match):
  """Configs the reference serves through its gather-dense fallback: the
  port serves them there too. Attention dropout is the identity with no
  step seed, so the packed step's logits and the engine's streams match
  the reference's (the engine classifies the path as 'dense')."""
  task, theta, port = _FieldTwins(6, **{field: value})
  eng = engine.ServingLoop(port, device="cpu", **_ENGINE_KW)
  assert eng.paged_path == "dense", match
  _CompareServing(task, theta, port)


def test_dense_lm_1b_widths():
  """The served configuration at the reference's published widths."""
  p = synthetic_packed_input.DenseLm1B().Task()
  assert (p.model_dim, p.num_layers, p.num_heads, p.hidden_dim,
          p.vocab_size, p.softmax_logits_soft_max, p.use_rotary,
          p.use_repeat_layer) == (2048, 24, 16, 8192, 32000, 30.0, True,
                                  True)


def test_port_imports_neither_jax_nor_lingvo_tpu():
  code = (
      "import pkgutil, sys, lingvo_tpu_torch\n"
      "for m in pkgutil.walk_packages(lingvo_tpu_torch.__path__, "
      "'lingvo_tpu_torch.'):\n"
      "  __import__(m.name)\n"
      "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
      "       or k == 'lingvo_tpu' or k.startswith('lingvo_tpu.')]\n"
      "print(len([k for k in sys.modules if k.startswith('lingvo_tpu_torch')]))\n"
      "assert not bad, bad\n")
  env = dict(os.environ, PYTHONPATH=REPO)
  res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
  assert res.returncode == 0, res.stderr
  assert int(res.stdout.strip().splitlines()[-1]) >= 72
