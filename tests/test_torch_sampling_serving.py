"""Sampling and the engine's host surface of lingvo_tpu_torch against JAX.

On DenseLmTiny (noised theta, CPU):
- `ServingLoop(temperature=0.8, top_k=5, sample_seed=3)` streams equal
  the JAX `ServingLoop`'s token for token, ragged and legacy, with the
  default seeds (the request ids) and with explicit `Submit(seed=...)`;
  the hybrid attention/SSM stack too. A request's stream depends on its
  seed alone, not on its slot or neighbours.
- `Cancel` of a queued and of a mid-flight request at the same step on
  both sides: the other streams equal, the cancelled handles finish with
  "cancelled", slots and pages come back, and the `Stats()` counters
  agree; `Stop(drain=False)` cancels what is left.
- `UpdateTheta` between steps, with float and int8 weights: the streams
  equal the reference engine's after the same swap at the same step; with
  `persist_prefix=True` and no prefix cache the swap happens as the
  reference's does.
- `prefill_token_budget` 4 and 12: streams and `Stats()` counters.
- A sampled step draws only the rows it commits: at most `max_batch`
  rows a ragged step (of its T packed tokens) and at most B a legacy
  step (of its B x C columns), counted by `SampleTokens.rows_drawn`.
"""

import jax
import numpy as np
import pytest
import torch

from lingvo_tpu.models.lm.params import synthetic_packed_input as jax_spi
from lingvo_tpu.serving import engine as jax_engine
from lingvo_tpu_torch import convert
from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
from lingvo_tpu_torch.ops import sample_tokens
from lingvo_tpu_torch.serving import engine

from tests.conftest import InstantiateLm
from tests.test_torch_ssm import hybrids  # noqa: F401 (fixture)

_PROMPT_LENS = [3, 11, 17, 6, 9, 1]
_ENGINE_KW = dict(page_size=8, num_pages=24, max_batch=4, max_seq_len=32,
                  prefill_chunk=8)
_SAMPLE = dict(temperature=0.8, top_k=5, sample_seed=3)
_COUNTS = ("steps", "decode_steps", "mixed_steps", "tokens_emitted",
           "prompt_tokens")


def _Noised(theta, seed, scale=0.3):
  rng = np.random.RandomState(seed)
  return jax.tree_util.tree_map(
      lambda x: np.asarray(x) + scale * rng.randn(*x.shape).astype(np.float32),
      theta)


def _PortLm(theta):
  lm = spi.DenseLmTiny().Task().Instantiate(device="cpu")
  convert.LoadJaxTheta(lm, theta)
  return lm


@pytest.fixture(scope="module")
def dense():
  """DenseLmTiny: the reference task, a noised theta, the port's LM."""
  task, theta = InstantiateLm(jax_spi.DenseLmTiny().Task(), seed=5)
  theta = _Noised(theta, seed=2)
  return task, theta, _PortLm(theta)


def _Prompts(vocab, seed=1):
  rng = np.random.RandomState(seed)
  return [rng.randint(1, vocab, size=n).tolist() for n in _PROMPT_LENS]


def _Drive(eng, prompts, max_new=8, seeds=None, at_step=None):
  """Submits every prompt (eos off), steps the engine inline until it is
  idle and returns the handles. at_step: {step: fn(handles)} run before
  that step (0-based)."""
  handles = [eng.Submit(p, max_new, eos_id=None,
                        seed=None if seeds is None else seeds[i])
             for i, p in enumerate(prompts)]
  step = 0
  while eng.sched.HasWork():
    if at_step and step in at_step:
      at_step[step](handles)
    eng.StepOnce()
    step += 1
  return handles


def _Streams(handles):
  return [h.Result(timeout=0) for h in handles]


def _AssertCounts(eng, j_eng, extra=()):
  stats, j_stats = eng.Stats(), j_eng.Stats()
  for key in _COUNTS + tuple(extra):
    assert stats[key] == j_stats[key], key
  for key in ("admitted", "finished", "cancelled"):
    assert stats["scheduler"][key] == j_stats["scheduler"][key], key
  assert stats["kv_pages"]["in_use"] == j_stats["kv_pages"]["in_use"] == 0
  return stats


@pytest.mark.parametrize("explicit_seeds", [False, True])
@pytest.mark.parametrize("step_mode", ["ragged", "legacy"])
def test_sampled_streams_match_reference(dense, step_mode, explicit_seeds):
  task, theta, lm = dense
  prompts = _Prompts(task.p.vocab_size)
  seeds = [11, 2**31 - 1, 0, 7, 11, 123456] if explicit_seeds else None
  kw = dict(_ENGINE_KW, step_mode=step_mode, **_SAMPLE)
  j_eng = jax_engine.ServingLoop(task, theta, trace=False, **kw)
  want = _Streams(_Drive(j_eng, prompts, seeds=seeds))
  eng = engine.ServingLoop(lm, device="cpu", **kw)
  got = _Streams(_Drive(eng, prompts, seeds=seeds))
  assert got == want
  _AssertCounts(eng, j_eng)
  # sampling shows: the streams are not the greedy ones
  greedy = _Streams(_Drive(engine.ServingLoop(
      lm, device="cpu", step_mode=step_mode, **_ENGINE_KW), prompts))
  assert got != greedy
  if explicit_seeds:   # requests 0 and 4 share a seed, not a prompt
    assert got[0] != got[4]


@pytest.mark.parametrize("step_mode", ["ragged", "legacy"])
def test_sampled_steps_draw_only_the_rows_they_commit(dense, step_mode):
  """Each sampled step draws one row per slot with input (at most
  max_batch, never the ragged step's T tokens nor the legacy step's B x C
  columns), in one call; every committed token is one of them."""
  task, _, lm = dense
  prompts = _Prompts(task.p.vocab_size)
  kw = dict(_ENGINE_KW, step_mode=step_mode, **_SAMPLE)
  eng = engine.ServingLoop(lm, device="cpu", **kw)
  st = sample_tokens.SampleTokens
  uploads = []   # the step's one sampling upload: seed, position, row

  def Folds(*args, fn=eng._Folds):
    uploads.append(fn(*args))
    return uploads[-1]

  eng._Folds = Folds
  handles = [eng.Submit(p, 8, eos_id=None) for p in prompts]
  drawn, emitted = [], []
  while eng.sched.HasWork():
    st.widest = 0
    before = st.rows_drawn
    emitted.append(eng.StepOnce())
    drawn.append(st.rows_drawn - before)
    assert st.widest == drawn[-1]   # one draw a step
    assert uploads[-1].dtype == torch.int32
    assert tuple(uploads[-1].shape) == (drawn[-1], 3)
  b = _ENGINE_KW["max_batch"]
  assert all(e <= d <= b for d, e in zip(drawn, emitted))
  assert max(drawn) == b            # a full batch draws every slot
  if step_mode == "ragged":
    assert eng._ragged_t > b        # and not the packed tokens
  assert sum(emitted) == 8 * len(prompts) == sum(
      len(h.Result(timeout=0)) for h in handles)


def test_a_stream_depends_on_its_seed_alone(dense):
  """The same request with the same seed, alone and third among
  neighbours in another slot, gives the same stream; another seed
  another stream."""
  task, _, lm = dense
  prompts = _Prompts(task.p.vocab_size)
  kw = dict(_ENGINE_KW, **_SAMPLE)
  alone = _Streams(_Drive(engine.ServingLoop(lm, device="cpu", **kw),
                          prompts[2:3], seeds=[99]))[0]
  crowd = _Streams(_Drive(engine.ServingLoop(lm, device="cpu", **kw),
                          prompts[::-1], seeds=[1, 2, 3, 99, 5, 6]))
  assert crowd[3] == alone
  other = _Streams(_Drive(engine.ServingLoop(lm, device="cpu", **kw),
                          prompts[2:3], seeds=[98]))[0]
  assert other != alone


@pytest.mark.parametrize("step_mode", ["ragged", "legacy"])
def test_hybrid_sampled_streams_match_reference(hybrids, step_mode):
  task, theta, lm = hybrids["flat"]
  prompts = _Prompts(task.p.vocab_size)
  kw = dict(_ENGINE_KW, step_mode=step_mode, **_SAMPLE)
  j_eng = jax_engine.ServingLoop(task, theta, trace=False, **kw)
  want = _Streams(_Drive(j_eng, prompts))
  eng = engine.ServingLoop(lm, device="cpu", **kw)
  assert _Streams(_Drive(eng, prompts)) == want
  stats = _AssertCounts(eng, j_eng)
  assert stats["state_slots"]["in_use"] == 0


@pytest.mark.parametrize("step_mode", ["ragged", "legacy"])
def test_cancel_matches_reference(dense, step_mode):
  """Six requests on four slots: before step 3, request 5 (still queued)
  and request 2 (mid-flight) are cancelled on both sides."""
  task, theta, lm = dense
  prompts = _Prompts(task.p.vocab_size)
  kw = dict(_ENGINE_KW, step_mode=step_mode, **_SAMPLE)

  def Run(eng):
    def Cancel(handles):
      assert handles[4].Cancel() and handles[1].Cancel()
      assert not handles[1].Cancel()    # already cancelled
    return _Drive(eng, prompts, max_new=12, at_step={3: Cancel})

  j_eng = jax_engine.ServingLoop(task, theta, trace=False, **kw)
  want = Run(j_eng)
  eng = engine.ServingLoop(lm, device="cpu", **kw)
  got = Run(eng)
  assert _Streams(got) == _Streams(want)
  assert [h.finish_reason for h in got] == [h.finish_reason for h in want]
  assert [h.finish_reason for h in got].count("cancelled") == 2
  assert got[4].Result(timeout=0) == [] and got[1].done
  assert not eng.Cancel(got[0].id) and not eng.Cancel(12345)
  stats = _AssertCounts(eng, j_eng)
  assert stats["scheduler"]["cancelled"] == 2
  assert stats["scheduler"]["slots_live"] == 0
  assert stats["kv_pages"]["free"] == _ENGINE_KW["num_pages"]


def test_stop_without_drain_cancels_what_is_left(dense):
  task, _, lm = dense
  eng = engine.ServingLoop(lm, device="cpu", **dict(_ENGINE_KW, **_SAMPLE))
  eng.Start()
  try:
    handles = [eng.Submit(p, 12, eos_id=None)
               for p in _Prompts(task.p.vocab_size)]
    handles[0].Result(timeout=60)   # one finished request
  finally:
    eng.Stop(drain=False, timeout=60)
  assert eng._thread is None and not eng.sched.HasWork()
  assert all(h.done for h in handles)
  assert handles[0].finish_reason == "length"
  reasons = [h.finish_reason for h in handles]
  assert set(reasons) <= {"length", "cancelled"} and "cancelled" in reasons
  stats = eng.Stats()
  assert stats["kv_pages"]["in_use"] == 0
  assert stats["scheduler"]["slots_live"] == 0


@pytest.mark.parametrize("int8", [False, True])
def test_update_theta_matches_reference(dense, int8):
  """The weights are swapped before step 4 on both sides; in-flight
  requests go on under the new ones."""
  task, theta, _ = dense
  new_theta = _Noised(theta, seed=6)
  prompts = _Prompts(task.p.vocab_size)
  kw = dict(_ENGINE_KW, serve_int8_weights=int8, **_SAMPLE)
  j_eng = jax_engine.ServingLoop(task, theta, trace=False, **kw)
  want = _Streams(_Drive(j_eng, prompts, at_step={
      4: lambda _: j_eng.UpdateTheta(new_theta)}))
  lm = _PortLm(theta)   # the swap writes into the task's parameters
  new_tree = _PortLm(new_theta).ThetaTree()
  eng = engine.ServingLoop(lm, device="cpu", **kw)
  got = _Streams(_Drive(eng, prompts, at_step={
      4: lambda _: eng.UpdateTheta(new_tree)}))
  assert got == want
  _AssertCounts(eng, j_eng)
  # without the swap the streams differ: the new weights were served
  unswapped = _Streams(_Drive(engine.ServingLoop(_PortLm(theta), device="cpu",
                                                 **kw), prompts))
  assert unswapped != got
  bad = _PortLm(new_theta).ThetaTree()
  del bad["final_ln"]
  with pytest.raises(ValueError, match="final_ln"):
    eng.UpdateTheta(bad)


@pytest.mark.parametrize("step_mode", ["ragged", "legacy"])
def test_update_theta_with_persist_prefix_matches_reference(dense,
                                                            step_mode):
  """persist_prefix=True belongs to a prefix cache; with none (the
  reference's default, and the port's only engine) the swap happens and
  the flag has no effect: the streams equal the reference engine's after
  the same swap, and the port's swap without the flag."""
  task, theta, _ = dense
  new_theta = _Noised(theta, seed=6)
  prompts = _Prompts(task.p.vocab_size)
  kw = dict(_ENGINE_KW, step_mode=step_mode, **_SAMPLE)
  j_eng = jax_engine.ServingLoop(task, theta, trace=False, **kw)
  assert j_eng.prefix_cache is None
  want = _Streams(_Drive(j_eng, prompts, at_step={
      3: lambda _: j_eng.UpdateTheta(new_theta, persist_prefix=True)}))
  new_tree = _PortLm(new_theta).ThetaTree()
  got = {}
  for persist in (True, None):
    eng = engine.ServingLoop(_PortLm(theta), device="cpu", **kw)
    got[persist] = _Streams(_Drive(eng, prompts, at_step={
        3: lambda _, e=eng, f=persist: e.UpdateTheta(new_tree,
                                                     persist_prefix=f)}))
    _AssertCounts(eng, j_eng)
  assert got[True] == want == got[None]


def test_update_theta_whose_int8_rewrite_fails_stops_the_steps(dense,
                                                               monkeypatch):
  """A failed int8 rewrite leaves the engine no float fallback: every step
  raises, taking nothing from the queue, until an UpdateTheta succeeds;
  then the streams are those of a swap that succeeded at that step."""
  task, theta, _ = dense
  prompts = _Prompts(task.p.vocab_size)
  kw = dict(_ENGINE_KW, serve_int8_weights=True, **_SAMPLE)
  new_tree = _PortLm(_Noised(theta, seed=6)).ThetaTree()
  ref = engine.ServingLoop(_PortLm(theta), device="cpu", **kw)
  want = _Streams(_Drive(ref, prompts, at_step={
      2: lambda _: ref.UpdateTheta(new_tree)}))

  def Fail(tree):
    raise MemoryError("no room for the int8 copy")

  eng = engine.ServingLoop(_PortLm(theta), device="cpu", **kw)
  handles = [eng.Submit(p, 8, eos_id=None) for p in prompts]
  eng.StepOnce()
  eng.StepOnce()
  with monkeypatch.context() as m:
    m.setattr(engine.quant_weights, "Int8ServingTheta", Fail)
    with pytest.raises(MemoryError):
      eng.UpdateTheta(new_tree)
  for _ in range(2):
    with pytest.raises(RuntimeError, match="int8 rewrite"):
      eng.StepOnce()
  assert eng.Stats()["steps"] == 2
  eng.UpdateTheta(new_tree)
  while eng.sched.HasWork():
    eng.StepOnce()
  assert _Streams(handles) == want


@pytest.mark.parametrize("budget", [4, 12])
def test_prefill_token_budget_matches_reference(dense, budget):
  task, theta, lm = dense
  prompts = _Prompts(task.p.vocab_size)
  kw = dict(_ENGINE_KW, prefill_token_budget=budget, **_SAMPLE)
  j_eng = jax_engine.ServingLoop(task, theta, trace=False, **kw)
  want = _Streams(_Drive(j_eng, prompts))
  eng = engine.ServingLoop(lm, device="cpu", **kw)
  assert _Streams(_Drive(eng, prompts)) == want
  assert (eng._ragged_t, eng._ragged_wmax) == (
      j_eng._ragged_t, j_eng._ragged_wmax) == (4 + budget, budget)
  _AssertCounts(eng, j_eng)
