"""The paged steps' gather-dense fallback against JAX.

A layer the paged kernels do not serve (here a logit cap; on the card
also a shape outside the kernels' limits) reads each row's pages gathered
into its logical cache through the einsum path, as the reference does
(`lingvo_tpu/core/attention.py` `PagedStep` / `RaggedStep`).

- `MultiHeadedAttention.PagedStep` with `atten_logit_cap` 5: a mixed
  [3, 5] step (a prefill from 0, a row mid-prompt, an idle row), then a
  [3, 1] decode step over what it wrote; `RaggedStep`: a pack of two
  prefill chunks and an idle row, then a pack of decode rows, a tree row
  (real `anc_lo` / `anc_hi` masks) and padding tokens. float32, bfloat16
  and int8 pools. Theta and inputs are dyadic (`_Dyadic`), so every
  projection is exact and the pools (int8 scales included) are bitwise the
  reference's jitted steps'; outputs within 2e-5 (the tanh and softmax of
  two libraries), padding outputs included.
- `ServingLoop` on a capped DenseLmTiny (noised theta) in both step modes
  over float32, int8 and bfloat16 pools, and on a capped attention/SSM
  hybrid: streams token-identical to the reference engine's, `paged_path`
  'dense' and `dense_fallback_steps` equal to the reference's (every
  step).
- At fprop_dtype=bfloat16 (bfloat16 pools): the capped DenseLmTiny's
  teacher-forced logits through two `RaggedStep`s and two `PagedStep`s
  (a mixed step, then a decode step) bitwise the reference's run op by
  op (`jax.disable_jit()`: under jit XLA keeps float32 inside the fused
  cap, which no eager program reproduces, and the jitted engine's greedy
  streams differ from both in near-ties); the engine in both step modes
  reports 'dense' and counts every step.
- Dropout still raises in the fallback, as in FProp: it is not ported.
- `cuda` cases (skipped here; JAX is imported only inside `_Jax`, so the
  card's machine, which has none, runs them alone): the capped layer's
  steps on the card against the CPU (the gate decided before any launch:
  no paged kernel runs), an uncapped layer on the card launching its
  kernel, and head dim 96, outside the block-decode kernel's head dims, in
  the legacy engine: 'dense' on the card, streams equal to the CPU's
  block-decode read:

    python -m pytest tests/test_torch_dense_fallback.py -m cuda
"""

import types

import numpy as np
import pytest
import torch

from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import attention
from lingvo_tpu_torch.core import ragged
from lingvo_tpu_torch.core import ssm
from lingvo_tpu_torch.models.lm import layers as lm_layers
from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
from lingvo_tpu_torch.ops import block_decode
from lingvo_tpu_torch.ops import ragged_block_attend
from lingvo_tpu_torch.serving import engine

from tests.conftest import InstantiateLm, TinyLmParams
from tests.test_torch_ssm_decode import _CardTwin

ATOL = 2e-5
CAP = 5.0
_DTYPES = ["float32", "bfloat16", "int8"]
_PROMPT_LENS = [3, 11, 17, 6, 9, 1]
_ENGINE_KW = dict(page_size=8, num_pages=24, max_batch=4, max_seq_len=32,
                  prefill_chunk=8)


def _Jax():
  """The reference's modules, imported here only."""
  import jax
  import jax.numpy as jnp
  from lingvo_tpu.core import attention as jax_attention
  from lingvo_tpu.core import ragged as jax_ragged
  from lingvo_tpu.models.lm.params import synthetic_packed_input as jax_spi
  from lingvo_tpu.serving import engine as jax_engine
  return types.SimpleNamespace(jax=jax, jnp=jnp, attention=jax_attention,
                               ragged=jax_ragged, spi=jax_spi,
                               engine=jax_engine)


def _Dyadic(shape, rng, denom, top):
  return (rng.randint(-top, top + 1, size=shape) / denom).astype(np.float32)


def _Noised(theta, seed=0, scale=0.5):
  """theta as numpy with seeded noise on every leaf: a fresh model echoes
  one token per stream."""
  rng = np.random.RandomState(seed)
  return _Jax().jax.tree_util.tree_map(
      lambda x: np.asarray(x) + scale * rng.randn(*x.shape).astype(np.float32),
      theta)


def _Prompts(vocab, seed=1):
  rng = np.random.RandomState(seed)
  prompts = np.zeros((len(_PROMPT_LENS), max(_PROMPT_LENS)), np.int32)
  for i, n in enumerate(_PROMPT_LENS):
    prompts[i, :n] = rng.randint(1, vocab, size=n)
  return prompts, np.asarray(_PROMPT_LENS, np.int32)


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


def _Bits(x):
  """A float array's bits (bfloat16 widened exactly to float32 first)."""
  if isinstance(x, torch.Tensor):
    x = x.float().numpy() if x.is_floating_point() else x.numpy()
  else:
    jnp = _Jax().jnp
    x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
  return x.view(np.int32) if x.dtype == np.float32 else x


def _AssertPoolsBitwise(j_states, t_states):
  """Every pool and sidecar bitwise the reference's, dtypes included, but
  the trash page (padding writes land there in no set order)."""
  j_items = dict(j_states.FlattenItems())
  t_items = dict(t_states.FlattenItems())
  assert sorted(t_items) == sorted(j_items)
  for key, t_leaf in t_items.items():
    j_leaf = j_items[key]
    assert str(t_leaf.dtype).removeprefix("torch.") == str(j_leaf.dtype), key
    np.testing.assert_array_equal(_Bits(t_leaf)[:-1], _Bits(j_leaf)[:-1],
                                  err_msg=key)


def _Layers(dtype, seed=0):
  """The reference's capped MultiHeadedAttention and the port's (N 2,
  H 16, no rotary: its sines would make the projections inexact), with
  one theta of multiples of 1/16 in [-1, 1]."""
  j = _Jax()
  kw = dict(name="atten", input_dim=32, hidden_dim=32, num_heads=2,
            kv_cache_dtype=dtype, atten_logit_cap=CAP)
  layer = j.attention.MultiHeadedAttention.Params().Set(**kw).Instantiate()
  theta = layer.InstantiateVariables(j.jax.random.PRNGKey(seed))
  rng = np.random.RandomState(seed)
  theta = j.jax.tree_util.tree_map(
      lambda x: _Dyadic(np.shape(x), rng, 16, 16), theta)
  port = attention.MultiHeadedAttention.Params().Set(**kw).Instantiate(
      device="cpu")
  convert.LoadJaxTheta(port, theta)
  assert not layer.BlockDecodeEligible(4)
  assert not port.BlockDecodeEligible(4)
  return layer, theta, port


@pytest.mark.parametrize("dtype", _DTYPES)
def test_paged_step_fallback_matches_reference(dtype):
  j = _Jax()
  layer, theta, port = _Layers(dtype)
  page, n_pages, b = 4, 16, 3
  rng = np.random.RandomState(1)
  tables = rng.permutation(n_pages)[:b * 4].reshape(b, 4).astype(np.int32)
  j_states = layer.InitPagedStates(theta, n_pages + 1, page,
                                   kv_cache_dtype=dtype)
  t_states = port.InitPagedStates(n_pages + 1, page, kv_cache_dtype=dtype)
  step = j.jax.jit(layer.PagedStep)
  for c, q_pos, in_len in ((5, [0, 4, 0], [5, 3, 0]),
                           (1, [5, 7, 0], [1, 1, 0])):
    x = _Dyadic((b, c, 32), rng, 8, 8)
    args = [np.asarray(a, np.int32) for a in (tables, q_pos, in_len)]
    j_out, j_states = step(theta, j.jnp.asarray(x), j_states,
                           *(j.jnp.asarray(a) for a in args))
    t_out, t_states = port.PagedStep(torch.as_tensor(x), t_states,
                                     *(torch.as_tensor(a) for a in args))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL)
    _AssertPoolsBitwise(j_states, t_states)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_ragged_step_fallback_matches_reference(dtype):
  """Pack 1: prefill chunks of 6 and 9, an idle row, padding. Pack 2:
  decode rows, a tree row of 4 (columns 1 and 2 children of column 0,
  column 3 of column 1), padding."""
  j = _Jax()
  layer, theta, port = _Layers(dtype, seed=1)
  page, n_pages, b = 8, 16, 3
  rng = np.random.RandomState(2)
  tables = rng.permutation(n_pages)[:b * 4].reshape(b, 4).astype(np.int32)
  j_states = layer.InitPagedStates(theta, n_pages + 1, page,
                                   kv_cache_dtype=dtype)
  t_states = port.InitPagedStates(n_pages + 1, page, kv_cache_dtype=dtype)
  step = j.jax.jit(layer.RaggedStep)
  for row_lens, q_pos, parents in (([6, 9, 0], [0, 0, 1], None),
                                   ([1, 4, 1], [6, 9, 0], {1: [-1, -1, 0]})):
    rows = j.ragged.BuildRaggedRows(row_lens, q_pos, 16, 9, parents)
    if parents:
      assert (np.asarray(rows.anc_lo) != -1).any()
    x = _Dyadic((1, 16, 32), rng, 8, 8)
    j_out, j_states = step(
        theta, j.jnp.asarray(x), j_states, j.jnp.asarray(tables),
        j.ragged.RaggedRows(*(j.jnp.asarray(m) for m in rows)))
    t_out, t_states = port.RaggedStep(torch.as_tensor(x), t_states,
                                      torch.as_tensor(tables),
                                      ragged.ToTorch(rows, "cpu"))
    assert not np.asarray(rows.valid).all()   # padding tokens ride along
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL)
    _AssertPoolsBitwise(j_states, t_states)


def test_dropout_still_raises_in_the_fallback():
  """Attention dropout sends the paged steps to the gather-dense fallback,
  where, with no step seed (serving), it is the identity: a mixed [2, 4]
  and a decode [2, 1] `PagedStep` match the jitted reference's outputs
  and pools, as the same layer without dropout does."""
  j = _Jax()
  fields = dict(input_dim=16, num_heads=2, use_rotary_position_emb=True)
  ref = j.attention.MultiHeadedAttention.Params().Set(
      name="a", atten_dropout_prob=0.1, **fields).Instantiate()
  theta = _Noised(ref.InstantiateVariables(j.jax.random.PRNGKey(0)))
  port = attention.MultiHeadedAttention.Params().Set(
      name="a", atten_dropout_prob=0.1, **fields).Instantiate(device="cpu")
  plain = attention.MultiHeadedAttention.Params().Set(
      name="a", **fields).Instantiate(device="cpu")
  convert.LoadJaxTheta(port, theta)
  convert.LoadJaxTheta(plain, theta)
  assert not port.BlockDecodeEligible(8) and plain.BlockDecodeEligible(8)
  rng = np.random.RandomState(2)
  tables = np.array([[0, 1], [2, 3]], np.int32)
  k0 = rng.randn(5, 8, 2, 8).astype(np.float32)
  v0 = rng.randn(5, 8, 2, 8).astype(np.float32)
  from lingvo_tpu.core.nested_map import NestedMap as JaxNestedMap
  j_states = JaxNestedMap(key=j.jnp.asarray(k0), value=j.jnp.asarray(v0))
  states = [port.InitPagedStates(5, 8), plain.InitPagedStates(5, 8)]
  for st in states:
    st.key.copy_(torch.as_tensor(k0))
    st.value.copy_(torch.as_tensor(v0))
  step = j.jax.jit(ref.PagedStep)
  for c, q_pos, in_len in ((4, [0, 3], [4, 2]), (1, [4, 5], [1, 1])):
    x = _Dyadic((2, c, 16), rng, 8, 8)
    qp = np.asarray(q_pos, np.int32)
    il = np.asarray(in_len, np.int32)
    j_out, j_states = step(theta, j.jnp.asarray(x), j_states,
                           j.jnp.asarray(tables), j.jnp.asarray(qp),
                           j.jnp.asarray(il))
    outs = [layer.PagedStep(torch.as_tensor(x), st, torch.as_tensor(tables),
                            torch.as_tensor(qp), torch.as_tensor(il))[0]
            for layer, st in zip((port, plain), states)]
    keep = np.arange(c)[None] < il[:, None]
    for out in outs:
      np.testing.assert_allclose(out.numpy()[keep], np.asarray(j_out)[keep],
                                 atol=ATOL)
    np.testing.assert_allclose(states[0].key.numpy()[:-1],
                               np.asarray(j_states.key)[:-1], atol=ATOL)


# -- the engine ----------------------------------------------------------------


def _Capped(p, atten_lib):
  p.atten_tpl = atten_lib.MultiHeadedAttention.Params().Set(
      atten_logit_cap=CAP)
  return p


@pytest.fixture(scope="module")
def capped_lms():
  """{name: (reference task, noised theta, the port's LM)}: DenseLmTiny,
  the attention/SSM hybrid and DenseLmTiny at fprop_dtype=bfloat16, all
  with the logit cap."""
  j = _Jax()
  out = {}
  task, theta = InstantiateLm(_Capped(j.spi.DenseLmTiny().Task(),
                                      j.attention), seed=5)
  theta = _Noised(theta, seed=2, scale=0.3)
  lm = _Capped(spi.DenseLmTiny().Task(), attention).Instantiate(device="cpu")
  convert.LoadJaxTheta(lm, theta)
  out["dense"] = (task, theta, lm)
  task, theta = InstantiateLm(
      _Capped(TinyLmParams(every_n=2), j.attention), seed=3)
  theta = _Noised(theta)
  lm = _Capped(_PortParams(task.p), attention).Instantiate(device="cpu")
  convert.LoadJaxTheta(lm, theta)
  out["hybrid"] = (task, theta, lm)
  # at fprop_dtype=bfloat16: bfloat16 pools, the dense products at
  # `_Atten`'s promotion; the reference takes jax arrays (a numpy bf16
  # leaf would promote `1.0 + scale` to float32 in its LayerNorm)
  task, theta = InstantiateLm(_Capped(j.spi.DenseLmTiny().Task().Set(
      fprop_dtype=j.jnp.bfloat16), j.attention), seed=5)
  theta = _Noised(theta, seed=2, scale=0.3)
  lm = _Capped(spi.DenseLmTiny().Task().Set(fprop_dtype=torch.bfloat16),
               attention).Instantiate(device="cpu")
  convert.LoadJaxTheta(lm, theta)
  out["dense_bf16"] = (task, j.jax.tree_util.tree_map(j.jnp.asarray, theta),
                       lm)
  return out


@pytest.mark.parametrize("model, step_mode, dtype", [
    ("dense", "ragged", None), ("dense", "legacy", None),
    ("dense", "ragged", "int8"), ("dense", "legacy", "int8"),
    ("dense", "ragged", "bfloat16"), ("hybrid", "ragged", None)])
def test_engine_streams_match_reference(model, step_mode, dtype, capped_lms):
  task, theta, lm = capped_lms[model]
  prompts, lens = _Prompts(task.p.vocab_size)
  kw = dict(_ENGINE_KW, step_mode=step_mode, kv_cache_dtype=dtype)
  j_eng = _Jax().engine.ServingLoop(task, theta, trace=False, **kw)
  want = j_eng.RunBatch(prompts, lens, max_new_tokens=8)
  # the streams differ between rows and within them
  assert len({tuple(r) for r in want}) > 1 and (want != want[:, :1]).any()
  eng = engine.ServingLoop(lm, device="cpu", **kw)
  got = eng.RunBatch(prompts, lens, max_new_tokens=8)
  np.testing.assert_array_equal(got, want)
  stats, j_stats = eng.Stats(), j_eng.Stats()
  assert stats["paged_path"] == j_stats["paged_path"] == "dense"
  for key in ("steps", "decode_steps", "mixed_steps", "tokens_emitted",
              "quantized_steps", "dense_fallback_steps"):
    assert stats[key] == j_stats[key], key
  assert stats["dense_fallback_steps"] == stats["steps"] > 0
  assert stats["kv_pages"]["in_use"] == 0


@pytest.mark.parametrize("step", ["RaggedStep", "PagedStep"])
def test_bf16_steps_bitwise_eager_reference(step, capped_lms):
  j = _Jax()
  task, theta, lm = capped_lms["dense_bf16"]
  rng = np.random.RandomState(2)
  tables = rng.permutation(16)[:12].reshape(3, 4).astype(np.int32)
  js = task.InitPagedDecodeState(theta, 17, 8, 3)
  ts = lm.InitPagedDecodeState(17, 8, 3)
  assert {v.dtype for v in ts.Flatten()} == {torch.bfloat16}
  if step == "RaggedStep":
    calls = [(jr, ragged.ToTorch(jr, "cpu"), 16) for jr in (
        j.ragged.BuildRaggedRows([6, 9, 0], [0, 0, 1], 16, 9),
        j.ragged.BuildRaggedRows([1, 4, 2], [6, 9, 0], 16, 9))]
  else:
    calls = [((np.array([0, 4, 0]), np.array([5, 3, 0])), None, 5),
             ((np.array([5, 7, 0]), np.array([1, 1, 0])), None, 1)]
  for desc, rows, width in calls:
    if step == "RaggedStep":
      ids = rng.randint(1, 128, size=(1, width)).astype(np.int32)
      j_args = (j.ragged.RaggedRows(*(j.jnp.asarray(m) for m in desc)),)
      t_args = (rows,)
      live = np.asarray(desc.valid)[None]
    else:
      ids = rng.randint(1, 128, size=(3, width)).astype(np.int32)
      j_args = tuple(j.jnp.asarray(a.astype(np.int32)) for a in desc)
      t_args = tuple(torch.as_tensor(a.astype(np.int32)) for a in desc)
      live = np.arange(width)[None] < desc[1][:, None]
    with j.jax.disable_jit():
      j_logits, js = getattr(task, step)(
          theta, j.jnp.asarray(ids), js, j.jnp.asarray(tables), *j_args)
    t_logits, ts = getattr(lm, step)(torch.as_tensor(ids), ts,
                                     torch.as_tensor(tables), *t_args)
    assert t_logits.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _Bits(t_logits)[live], _Bits(j_logits)[live], err_msg=step)


def test_bf16_engine_reports_the_fallback(capped_lms):
  _, _, lm = capped_lms["dense_bf16"]
  prompts, lens = _Prompts(lm.p.vocab_size)
  for mode in ("ragged", "legacy"):
    eng = engine.ServingLoop(lm, device="cpu", step_mode=mode, **_ENGINE_KW)
    eng.RunBatch(prompts, lens, max_new_tokens=4)
    stats = eng.Stats()
    assert stats["paged_path"] == "dense"
    assert stats["dense_fallback_steps"] == stats["steps"] > 0


def test_uncapped_engine_counts_no_fallback(capped_lms):
  """The same engine without the cap takes the paged path and counts no
  fallback step."""
  task, _, _ = capped_lms["dense"]
  lm = spi.DenseLmTiny().Task().Instantiate(device="cpu")
  eng = engine.ServingLoop(lm, device="cpu", **_ENGINE_KW)
  prompts, lens = _Prompts(task.p.vocab_size)
  eng.RunBatch(prompts[:2], lens[:2], max_new_tokens=2)
  stats = eng.Stats()
  assert stats["paged_path"] == "plain"
  assert stats["dense_fallback_steps"] == 0 < stats["steps"]


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: the gates read the paged kernels' "
                "limits only for a layer on the card")


def _Launches():
  return (block_decode.BlockDecode.launches,
          ragged_block_attend.RaggedAttend.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("cap, dtype", [
    (CAP, "float32"), (CAP, "bfloat16"), (CAP, "int8"), (0.0, "float32"),
    (0.0, "int8")])
def test_steps_on_card_match_cpu(cuda, cap, dtype):
  """A mixed [3, 5] then a decode [3, 1] PagedStep and two packed
  RaggedSteps (a tree row among them) on the card against the CPU, on
  `dtype` pools, within 1e-5 (pools within 1e-5 too). Capped, the gate
  sends every step to the fallback before any launch: no paged kernel
  runs. Uncapped, the same layer launches the kernels: one block-decode
  launch for the decode step, one ragged launch a packed step (a
  bfloat16 pool's kernels are held to the plain versions on dyadic
  inputs elsewhere, tests/test_torch_decode_attend.py)."""
  p = attention.MultiHeadedAttention.Params().Set(
      name="atten", input_dim=32, hidden_dim=32, num_heads=2,
      kv_cache_dtype=dtype, atten_logit_cap=cap)
  cpu, card = _CardTwin(p)
  assert card.BlockDecodeEligible(4) == (cap == 0)
  rng = np.random.RandomState(5)
  tables = torch.as_tensor(
      rng.permutation(16)[:12].reshape(3, 4).astype(np.int32))
  before = _Launches()
  for step in ("PagedStep", "RaggedStep"):
    s_cpu = cpu.InitPagedStates(17, 4 if step == "PagedStep" else 8)
    s_card = card.InitPagedStates(17, 4 if step == "PagedStep" else 8)
    if step == "PagedStep":
      calls = [((3, 5, 32), (tables, torch.tensor([0, 4, 0]),
                              torch.tensor([5, 3, 0]))),
               ((3, 1, 32), (tables, torch.tensor([5, 7, 0]),
                              torch.tensor([1, 1, 0])))]
    else:
      calls = [((1, 16, 32), (tables, ragged.BuildRaggedRows(
          [6, 9, 0], [0, 0, 1], 16, 9))), ((1, 16, 32), (
              tables, ragged.BuildRaggedRows([1, 4, 1], [6, 9, 0], 16, 9,
                                             {1: [-1, -1, 0]})))]
    for shape, args in calls:
      x = torch.as_tensor(rng.randn(*shape).astype(np.float32))
      if step == "PagedStep":
        on = lambda dev: [a.to(torch.int32).to(dev) for a in args]
      else:
        on = lambda dev: [args[0].to(dev), ragged.ToTorch(args[1], dev)]
      want, s_cpu = getattr(cpu, step)(x, s_cpu, *on("cpu"))
      got, s_card = getattr(card, step)(x.cuda(), s_card, *on("cuda"))
      torch.cuda.synchronize()
      assert float((got.cpu() - want).abs().max()) <= 1e-5, step
    for key in s_cpu:
      diff = (s_card[key].cpu().float() - s_cpu[key].float())[:-1]
      assert float(diff.abs().max()) <= 1e-5, (step, key)
  after = _Launches()
  want = (0, 0) if cap else (1, 2)
  assert (after[0] - before[0], after[1] - before[1]) == want


@pytest.mark.cuda
def test_head_dim_96_legacy_engine_takes_the_fallback_on_card(cuda):
  """DenseLmTiny at d 192 with 2 heads of 96 (not a block-decode head
  dim): the legacy engine on the card is 'dense' (every step counted,
  no paged kernel launched), the CPU engine 'plain' (the block-decode
  read); greedy streams equal. The ragged kernel takes head dim 96: the
  ragged engine on the card is 'cuda'."""
  p = spi.DenseLmTiny().Task().Set(model_dim=192, num_heads=2,
                                   hidden_dim=384)
  cpu, card = _CardTwin(p)
  prompts, lens = _Prompts(p.vocab_size)
  kw = dict(_ENGINE_KW, step_mode="legacy")
  want = engine.ServingLoop(cpu, device="cpu", **kw).RunBatch(
      prompts, lens, max_new_tokens=8)
  eng = engine.ServingLoop(card, **kw)
  before = _Launches()
  got = eng.RunBatch(prompts, lens, max_new_tokens=8)
  np.testing.assert_array_equal(got, want)
  assert _Launches() == before
  stats = eng.Stats()
  assert stats["paged_path"] == "dense"
  assert stats["dense_fallback_steps"] == stats["steps"] > 0
  assert engine.ServingLoop(card, **_ENGINE_KW).paged_path == "cuda"
