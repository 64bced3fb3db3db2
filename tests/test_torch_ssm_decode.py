"""The SSM mixer's incremental decode (GShardDecode contract) against JAX.

- `GatedSSMLayer.Prefill` over a whole left-padded sequence equals the
  port's `FProp` bit for bit at the valid steps and the reference's
  `Prefill` within 2e-5; a chunked `Prefill` (chunks of 5 and 6 with
  chunk_size 4, so the scan carries a state into a partial chunk) then
  three `ExtendStep`s, with left paddings, match the reference's outputs
  and states within 2e-5. Both write the state in place.
- `TransformerLm.InitDecodeState` / `Prefill` / `ExtendStep` of
  `DenseLmSsmHybridTiny` as a repeat of two [ssm, attention] bodies (with
  the paged flash-decode read, decode_page_size 4) and unrolled, and of
  its pure-SSM stack (`mixer_atten_every_n=0`) as a repeat and unrolled:
  logits within 1e-4 and every state leaf (SSM states and KV caches)
  within 1e-4 of the reference's (three layers of projections and the
  tied head accumulate the per-op differences, as in the attention-only
  decode test).
- `GShardDecode.DecodeOnce` on the same stacks token for token against
  the reference's `GShardDecode` from one noised theta (JAX restores it
  through its orbax checkpointer, the port through its own): greedy with
  prefill chunks of 3, seeded sampling (T 0.8, top_k 5) and
  `use_legacy_prime`, over float32 and int8 KV caches. The telemetry's KV
  census equals the reference's (a pure-SSM stack: kv_cache_dtype None,
  kv_bytes_per_token 0); decode_state_bytes_per_seq is the port's state
  tensors, the reference's the same plus its int32 time_step leaves (4
  bytes a layer, over the batch), and a pure-SSM stack's does not grow
  with max_decode_steps.
- `cuda` cases (skipped here; JAX is imported only inside `_Jax`, so the
  card's machine, which has none, runs them alone): the layer's chunked
  `Prefill` (the scan kernel, a carried s0 after the first chunk) and
  `ExtendStep` on the card against the CPU, and the hybrid stack's
  decode (scan and flash-decode kernels) against the CPU, with exact
  launch counts:

    python -m pytest tests/test_torch_ssm_decode.py -m cuda
"""

import types

import numpy as np
import pytest
import torch

from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import attention
from lingvo_tpu_torch.core import checkpointer
from lingvo_tpu_torch.core import ssm
from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
from lingvo_tpu_torch.ops import flash_decode
from lingvo_tpu_torch.ops import ssd_scan
from lingvo_tpu_torch.runners import gshard_decode

ATOL = 2e-5
D, N, S, CHUNK = 16, 2, 4, 4


def _Jax():
  """The reference's modules, imported here only."""
  import jax
  import jax.numpy as jnp
  from lingvo_tpu.core import attention as jax_attention
  from lingvo_tpu.core import checkpointer as jax_checkpointer
  from lingvo_tpu.core import ssm as jax_ssm
  from lingvo_tpu.models.lm.params import synthetic_packed_input as jax_spi
  from lingvo_tpu.runners import gshard_decode as jax_gshard
  return types.SimpleNamespace(
      jax=jax, jnp=jnp, attention=jax_attention,
      checkpointer=jax_checkpointer, ssm=jax_ssm, spi=jax_spi,
      gshard=jax_gshard)


def _Noised(theta, seed=0, scale=0.5):
  """theta as numpy with seeded noise on every leaf: freshly initialized
  biases and norms are constants, and a fresh model echoes one token per
  stream."""
  rng = np.random.RandomState(seed)
  return _Jax().jax.tree_util.tree_map(
      lambda x: np.asarray(x) + scale * rng.randn(*x.shape).astype(np.float32),
      theta)


@pytest.fixture(scope="module")
def layers():
  """(the reference's GatedSSMLayer, its noised theta, the port's layer
  with that theta): N 2 heads, S 4, chunk 4."""
  j = _Jax()
  kw = dict(name="ssm", input_dim=D, hidden_dim=D, num_heads=N, state_dim=S,
            chunk_size=CHUNK)
  j_layer = j.ssm.GatedSSMLayer.Params().Set(**kw).Instantiate()
  theta = _Noised(j_layer.InstantiateVariables(j.jax.random.PRNGKey(0)), 1,
                  0.3)
  t_layer = ssm.GatedSSMLayer.Params().Set(**kw).Instantiate(device="cpu")
  convert.LoadJaxTheta(t_layer, theta)
  return j_layer, theta, t_layer


# -- the layer -----------------------------------------------------------------


def _LeftPads(lens, width):
  """[B, width] float32 cache paddings: row i's first width - lens[i]
  slots are pad (a right-aligned prompt)."""
  slot = np.arange(width)[None]
  return (slot < width - np.asarray(lens)[:, None]).astype(np.float32)


def test_prefill_whole_sequence_matches_fprop(layers):
  jnp = _Jax().jnp
  j_layer, theta, t_layer = layers
  rng = np.random.RandomState(11)
  x = rng.randn(2, 11, D).astype(np.float32)
  paddings = _LeftPads([11, 8], 11)
  j_out, j_states = j_layer.Prefill(theta, jnp.asarray(x),
                                    j_layer.InitStates(theta, 2, 11),
                                    jnp.asarray(paddings))
  states = t_layer.InitStates(2, 11)
  assert states.time_step == 0 and not states.state.any()
  leaf = states.state
  t_out, t_states = t_layer.Prefill(torch.as_tensor(x), states,
                                    torch.as_tensor(paddings))
  assert t_states.state is leaf and t_states.time_step == 11
  np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL)
  np.testing.assert_allclose(leaf.numpy(), np.asarray(j_states.state),
                             atol=ATOL)
  with torch.no_grad():
    f_out, _ = t_layer.FProp(torch.as_tensor(x),
                             paddings=torch.as_tensor(paddings), causal=True)
  valid = torch.as_tensor(paddings) == 0
  assert torch.equal(t_out[valid], f_out[valid])


def test_chunked_prefill_then_extend_steps_match_reference(layers):
  """A right-aligned batch of 3 (prompts 11, 7, 2 in 11 slots) primed by
  chunks of 5 and 6, then three ExtendSteps."""
  jnp = _Jax().jnp
  j_layer, theta, t_layer = layers
  rng = np.random.RandomState(12)
  total = 14
  paddings = _LeftPads([11, 7, 2], 11)
  paddings = np.pad(paddings, ((0, 0), (0, total - 11)))
  j_pad, t_pad = jnp.asarray(paddings), torch.as_tensor(paddings)
  j_states = j_layer.InitStates(theta, 3, total)
  t_states = t_layer.InitStates(3, total)
  leaf = t_states.state
  for width, method in ((5, "Prefill"), (6, "Prefill"), (1, "ExtendStep"),
                        (1, "ExtendStep"), (1, "ExtendStep")):
    x = rng.randn(3, width, D).astype(np.float32)
    j_out, j_states = getattr(j_layer, method)(theta, jnp.asarray(x),
                                               j_states, j_pad)
    t_out, t_states = getattr(t_layer, method)(torch.as_tensor(x), t_states,
                                               t_pad)
    assert t_states.state is leaf   # written in place
    assert t_states.time_step == int(j_states.time_step)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL,
                               err_msg=method)
    np.testing.assert_allclose(leaf.numpy(), np.asarray(j_states.state),
                               atol=ATOL, err_msg=method)
  # the first row's state moved away from zero, the pad-only start of the
  # last row left it at zero through the first chunk's pad slots
  assert float(np.abs(leaf[0].numpy()).max()) > 0.1


# -- the stacks ----------------------------------------------------------------

# DenseLmSsmHybridTiny (d 64, 4 heads, S 16, chunk 8) and its variants
_STACKS = {
    "hybrid_repeat": dict(num_layers=4, page=4),
    "hybrid_flat": dict(use_repeat_layer=False),
    "pure_ssm": dict(mixer_atten_every_n=0),
    "pure_ssm_flat": dict(mixer_atten_every_n=0, use_repeat_layer=False),
}


def _Params(spi_mod, atten_mod, stack, kv=None):
  kw = dict(_STACKS[stack])
  page = kw.pop("page", 0)
  p = spi_mod.DenseLmSsmHybridTiny().Task().Set(kv_cache_dtype=kv, **kw)
  if page:
    p.atten_tpl = atten_mod.MultiHeadedAttention.Params().Set(
        decode_page_size=page)
  return p


def _JaxTask(stack, kv=None):
  j = _Jax()
  task = _Params(j.spi, j.attention, stack, kv).Instantiate()
  task.FinalizePaths()
  return task


def _PortLm(stack, kv=None, theta=None):
  lm = _Params(spi, attention, stack, kv).Instantiate(device="cpu")
  if theta is not None:
    convert.LoadJaxTheta(lm, theta)
  return lm


@pytest.fixture(scope="module")
def thetas():
  """{stack: its noised reference theta}."""
  key = _Jax().jax.random.PRNGKey(4)
  return {stack: _Noised(_JaxTask(stack).InstantiateVariables(key), seed=5,
                         scale=0.3) for stack in _STACKS}


def _AssertDecodeStatesClose(j_states, t_states):
  j_items = {k: v for k, v in j_states.FlattenItems()
             if not k.endswith("time_step")}
  t_items = {k: v for k, v in t_states.FlattenItems()
             if isinstance(v, torch.Tensor)}
  assert sorted(j_items) == sorted(t_items)
  assert any(k.endswith(".state") for k in t_items)
  for key, t_leaf in t_items.items():
    np.testing.assert_allclose(t_leaf.numpy(), np.asarray(j_items[key]),
                               atol=1e-4, rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("stack", sorted(_STACKS))
def test_lm_decode_matches_reference(stack, thetas):
  """A right-aligned batch of 3 (prompts 10, 6, 1 in 10 slots) primed by
  Prefill chunks of 6 and 4 (live_len trimmed), then four ExtendSteps on
  fixed ids: logits and every state leaf."""
  j = _Jax()
  jax, jnp = j.jax, j.jnp
  theta = thetas[stack]
  task, lm = _JaxTask(stack), _PortLm(stack, theta=theta)
  rng = np.random.RandomState(13)
  total = 16
  paddings = np.pad(_LeftPads([10, 6, 1], 10), ((0, 0), (0, total - 10)))
  j_pad, t_pad = jnp.asarray(paddings), torch.as_tensor(paddings)
  j_states = task.InitDecodeState(theta, 3, total)
  t_states = lm.InitDecodeState(3, total)
  leaves = [x for x in t_states.Flatten() if isinstance(x, torch.Tensor)]
  ids = rng.randint(1, task.p.vocab_size, size=(3, 14)).astype(np.int32)
  for start, width in ((0, 6), (6, 4)):
    chunk = ids[:, start:start + width]
    j_logits, j_states = jax.jit(task.Prefill, static_argnums=4)(
        theta, jnp.asarray(chunk), j_states, j_pad, start + width)
    t_logits, t_states = lm.Prefill(torch.as_tensor(chunk), t_states,
                                    cache_paddings=t_pad,
                                    live_len=start + width)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=1e-4)
  for t in range(10, 14):
    j_logits, j_states = jax.jit(task.ExtendStep)(
        theta, jnp.asarray(ids[:, t:t + 1]), j_states, j_pad)
    t_logits, t_states = lm.ExtendStep(torch.as_tensor(ids[:, t:t + 1]),
                                       t_states, cache_paddings=t_pad)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=1e-4)
  _AssertDecodeStatesClose(j_states, t_states)
  # every tensor leaf is the one InitDecodeState made: the stacks keep
  # their states in place, a repeat's slices included
  now = [x for x in t_states.Flatten() if isinstance(x, torch.Tensor)]
  assert len(now) == len(leaves) and all(a is b for a, b in zip(now, leaves))
  assert all(ts == 14 for ts in t_states.Flatten() if isinstance(ts, int))


# -- GShardDecode ----------------------------------------------------------------

_PROMPTS = np.array([[5, 6, 7, 8, 9, 10, 11], [12, 13, 14, 15, 0, 0, 0],
                     [16, 0, 0, 0, 0, 0, 0]], np.int32)
_LENS = np.array([7, 4, 1], np.int32)
_STEPS = 8   # bucket 16 + 8 = 24 slots: 6 pages of 4


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, thetas):
  """{stack: (JAX train dir, port train dir)}: each stack's noised theta
  saved at step 1 by the JAX orbax checkpointer and by the port's."""
  j = _Jax()
  root = tmp_path_factory.mktemp("ssm_gshard")
  out = {}
  for stack, theta in thetas.items():
    task = _JaxTask(stack)
    state = task.CreateTrainState(j.jax.random.PRNGKey(3))
    state.theta = j.jax.tree_util.tree_map(j.jnp.asarray, theta)
    jax_dir, port_dir = str(root / f"{stack}_jax"), str(root / stack)
    ckpt = j.checkpointer.Checkpointer(jax_dir)
    ckpt.Save(1, state, force=True)
    ckpt.Close()
    lm = _PortLm(stack, theta=theta)
    assert checkpointer.Checkpointer(port_dir).Save(
        1, lm, lm.CreateTrainState(), force=True)
    out[stack] = (jax_dir, port_dir)
  return out


_MODES = {
    "greedy": dict(prefill_chunk_size=3),
    "sampled": dict(temperature=0.8, top_k=5),
    "legacy": dict(use_legacy_prime=True),
}


@pytest.mark.parametrize("stack, mode, kv", [
    ("hybrid_repeat", "greedy", None), ("hybrid_repeat", "sampled", "int8"),
    ("hybrid_repeat", "legacy", None), ("hybrid_flat", "greedy", "int8"),
    ("hybrid_flat", "sampled", None), ("hybrid_flat", "legacy", "int8"),
    ("pure_ssm", "greedy", None), ("pure_ssm", "sampled", "int8"),
    ("pure_ssm_flat", "legacy", None)])
def test_decode_once_matches_reference(stack, mode, kv, checkpoints,
                                       tmp_path):
  jax_dir, port_dir = checkpoints[stack]
  want = _Jax().gshard.GShardDecode(
      _JaxTask(stack, kv), jax_dir, str(tmp_path / "jax.jsonl"),
      max_decode_steps=_STEPS, **_MODES[mode]).DecodeOnce(1, _PROMPTS, _LENS)
  got = gshard_decode.GShardDecode(
      _PortLm(stack, kv), port_dir, str(tmp_path / "port.jsonl"),
      max_decode_steps=_STEPS, **_MODES[mode]).DecodeOnce(1, _PROMPTS, _LENS)
  assert len({tuple(r["output_ids"]) for r in want}) > 1
  assert [r["output_ids"] for r in got] == [r["output_ids"] for r in want]
  tel, ref = got[0]["telemetry"], want[0]["telemetry"]
  for key in ("prompt_tokens", "decode_tokens", "kv_cache_dtype",
              "kv_bytes_per_token", "serve_int8_weights", "step_programs"):
    assert tel[key] == ref[key], key
  ssm_only = stack.startswith("pure_ssm")
  assert tel["kv_cache_dtype"] == (None if ssm_only else kv or "float32")
  assert (tel["kv_bytes_per_token"] == 0) == ssm_only
  # the reference also counts one int32 time_step per layer (the port's
  # is a host int)
  layers = _JaxTask(stack).p.num_layers
  b = len(_LENS)
  assert ref["decode_state_bytes_per_seq"] == (
      tel["decode_state_bytes_per_seq"] * b + 4 * layers) // b


@pytest.mark.parametrize("stack", ["pure_ssm", "hybrid_flat"])
def test_decode_state_flat_for_ssm_grows_for_attention(stack, checkpoints,
                                                       tmp_path):
  """The O(1) property through GShardDecode: a pure-SSM stack's decode
  state per sequence does not depend on max_decode_steps; the hybrid's
  grows by exactly its attention layer's K and V."""
  _, port_dir = checkpoints[stack]
  lm = _PortLm(stack)
  per_seq = {}
  for steps in (4, 20):
    decoder = gshard_decode.GShardDecode(lm, port_dir,
                                         str(tmp_path / f"{steps}.jsonl"),
                                         max_decode_steps=steps)
    decoder.DecodeOnce(1, _PROMPTS, _LENS)
    per_seq[steps] = decoder._last_telemetry["decode_state_bytes_per_seq"]
  p = lm.p
  n_ssm = p.num_layers - (p.num_layers // p.mixer_atten_every_n
                          if p.mixer_atten_every_n else 0)
  state = n_ssm * p.model_dim * p.mixer_tpl.state_dim * 4
  if stack == "pure_ssm":
    assert per_seq[4] == per_seq[20] == state
  else:
    assert per_seq[20] - per_seq[4] == 16 * 2 * p.model_dim * 4
    assert per_seq[4] == state + (16 + 4) * 2 * p.model_dim * 4


def test_decode_states_are_the_ssm_layers_own(thetas):
  """The pure-SSM stack's decode state: one [B, N, H, S] float32 matrix
  per layer (stacked [L, ...] under a repeat) and a host-int time_step,
  whatever max_len."""
  lm = _PortLm("pure_ssm", theta=thetas["pure_ssm"])
  p = lm.p
  for max_len in (8, 1024):
    states = lm.InitDecodeState(2, max_len)
    (state,) = [x for x in states.Flatten() if isinstance(x, torch.Tensor)]
    assert state.shape == (p.num_layers, 2, p.num_heads,
                           p.model_dim // p.num_heads, p.mixer_tpl.state_dim)
    assert state.dtype == torch.float32 and state.is_contiguous()
    assert [x for x in states.Flatten() if not isinstance(x, torch.Tensor)] == [0]


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: the SSD-scan and flash-decode kernels")


def _CardTwin(p, seed=1):
  """p instantiated on the CPU (seeded weights) and on the card, same
  weights."""
  cpu = p.Instantiate(device="cpu")
  cpu.InstantiateVariables(torch.Generator("cpu").manual_seed(seed))
  card = p.Instantiate(device="cuda")
  card.load_state_dict(cpu.state_dict())
  return cpu, card


def _Close(got, want, tol, what):
  err = float((got.cpu() - want).abs().max())
  bar = tol * max(1.0, float(want.abs().max()))
  assert err <= bar, f"{what}: {err} > {bar}"


@pytest.mark.cuda
def test_layer_decode_on_card_matches_cpu(cuda):
  """The mixer at the hybrid's head dim (4 heads of 16, S 16, chunk 8):
  a right-aligned batch of 3 primed by Prefill chunks of 20 and 12 (the
  scan kernel; the second from the carried state), then 3 ExtendSteps.
  Outputs and the state within 2e-5 x max(1, max|want|) of the CPU's
  (float32 sums in other orders, carried from chunk to chunk); exactly
  one scan launch a Prefill; the state written in place."""
  cpu, card = _CardTwin(ssm.GatedSSMLayer.Params().Set(
      name="ssm", input_dim=64, num_heads=4, state_dim=16, chunk_size=8))
  rng = np.random.RandomState(21)
  total = 35
  paddings = np.pad(_LeftPads([32, 17, 3], 32), ((0, 0), (0, total - 32)))
  s_cpu, s_card = cpu.InitStates(3, total), card.InitStates(3, total)
  leaf = s_card.state
  launches = ssd_scan.SsdScan.launches
  for width, method in ((20, "Prefill"), (12, "Prefill"), (1, "ExtendStep"),
                        (1, "ExtendStep"), (1, "ExtendStep")):
    x = torch.as_tensor(rng.randn(3, width, 64).astype(np.float32))
    want, s_cpu = getattr(cpu, method)(x, s_cpu, torch.as_tensor(paddings))
    got, s_card = getattr(card, method)(
        x.cuda(), s_card, torch.as_tensor(paddings).cuda())
    torch.cuda.synchronize()
    assert s_card.state is leaf and s_card.time_step == s_cpu.time_step
    _Close(got, want, 2e-5, method)
    _Close(leaf, s_cpu.state, 2e-5, f"{method} state")
  assert ssd_scan.SsdScan.launches == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("stack", ["hybrid_repeat", "pure_ssm_flat"])
def test_stack_decode_on_card_matches_cpu(cuda, stack):
  """DenseLmSsmHybridTiny as a repeat of two [ssm, attention] bodies with
  the paged flash-decode read (page 4), and its unrolled pure-SSM stack:
  Prefill chunks of 6 and 4 then 4 ExtendSteps, logits within 1e-4 of
  the CPU's; one scan launch per SSM layer and chunk, one flash-decode
  launch per attention layer and step, nothing else."""
  p = _Params(spi, attention, stack)
  cpu, card = _CardTwin(p)
  total = 16
  paddings = torch.as_tensor(
      np.pad(_LeftPads([10, 6, 1], 10), ((0, 0), (0, total - 10))))
  ids = torch.as_tensor(np.random.RandomState(13).randint(
      1, p.vocab_size, size=(3, 14)).astype(np.int32))
  s_cpu, s_card = cpu.InitDecodeState(3, total), card.InitDecodeState(3, total)
  counts = (ssd_scan.SsdScan.launches, flash_decode.FlashDecode.launches)
  for start, width in ((0, 6), (6, 4)):
    chunk = ids[:, start:start + width]
    want, s_cpu = cpu.Prefill(chunk, s_cpu, cache_paddings=paddings,
                              live_len=start + width)
    got, s_card = card.Prefill(chunk.cuda(), s_card,
                               cache_paddings=paddings.cuda(),
                               live_len=start + width)
    _Close(got, want, 1e-4, f"Prefill at {start}")
  for t in range(10, 14):
    want, s_cpu = cpu.ExtendStep(ids[:, t:t + 1], s_cpu,
                                 cache_paddings=paddings)
    got, s_card = card.ExtendStep(ids[:, t:t + 1].cuda(), s_card,
                                  cache_paddings=paddings.cuda())
    _Close(got, want, 1e-4, f"ExtendStep at {t}")
  n_atten = (p.num_layers // p.mixer_atten_every_n
             if p.mixer_atten_every_n else 0)
  n_ssm = p.num_layers - n_atten
  assert (ssd_scan.SsdScan.launches - counts[0],
          flash_decode.FlashDecode.launches - counts[1]) == (2 * n_ssm,
                                                              4 * n_atten)
