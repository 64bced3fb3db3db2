"""Incremental decode and GShardDecode of lingvo_tpu_torch against JAX.

- `TransformerLm.Prefill` (chunked, with live_len) and `ExtendStep` on a
  right-aligned ragged batch with `cache_paddings` match the reference's
  logits at every step and its written caches, with `decode_page_size` 4
  (the paged flash-decode read) on a repeat stack and 0 (the dense read)
  on a stack of distinct layers (float32, atol 1e-4: two layers of
  projections, rotary and the tied head accumulate the per-op
  differences).
- `Prefill(live_len=...)` is held to what the reference's own test
  asserts (tests/test_decode_fast_path.py, the trimmed two-chunk prefill):
  the trimmed read equals the full-cache read within 2e-5 and the written
  caches are identical. Here they are bitwise equal.
- `GShardDecode.DecodeOnce` continuations on DenseLmTiny equal the JAX
  decoder's from the same theta: JAX restores it through its orbax
  `Checkpointer`, the port through its own (`core/checkpointer.py`); with
  the paged read and chunked prefill, the dense read and one-pass
  prefill, and `use_legacy_prime`. The records carry the reference's
  telemetry keys. Bucketing shares one decode setup across prompt widths.
- The port's checkpointer: cadence, retention, restore-or-init, a round
  trip of weights and optimizer state.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lingvo_tpu.core import attention as jax_attention
from lingvo_tpu.core import checkpointer as jax_checkpointer
from lingvo_tpu.models.lm import layers as jax_lm
from lingvo_tpu.models.lm.params import synthetic_packed_input as jax_spi
from lingvo_tpu.observe import schema as observe_schema
from lingvo_tpu.runners import gshard_decode as jax_gshard
from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import attention
from lingvo_tpu_torch.core import checkpointer
from lingvo_tpu_torch.core import py_utils
from lingvo_tpu_torch.models.lm import layers as lm_layers
from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
from lingvo_tpu_torch.ops import flash_decode
from lingvo_tpu_torch.runners import gshard_decode


def _Noised(theta, seed=0, scale=0.5):
  """theta as numpy with seeded noise on every leaf: a fresh model echoes
  one token per stream, which would make continuations a weak check."""
  rng = np.random.RandomState(seed)
  return jax.tree_util.tree_map(
      lambda x: np.asarray(x) + scale * rng.randn(*x.shape).astype(np.float32),
      theta)


def _TinyLm(use_repeat_layer=True, decode_page_size=0):
  """The reference's tiny LM (as its decode tests build it) and the
  port's, carrying the same noised theta."""
  kw = dict(name="lm", vocab_size=64, model_dim=32, num_layers=2,
            num_heads=2, hidden_dim=64, use_repeat_layer=use_repeat_layer,
            use_rotary=True)
  jp = jax_lm.TransformerLm.Params().Set(**kw)
  tp = lm_layers.TransformerLm.Params().Set(**kw)
  if decode_page_size:
    jp.atten_tpl = jax_attention.MultiHeadedAttention.Params().Set(
        decode_page_size=decode_page_size)
    tp.atten_tpl = attention.MultiHeadedAttention.Params().Set(
        decode_page_size=decode_page_size)
  task = jp.Instantiate()
  task.FinalizePaths()
  theta = _Noised(task.InstantiateVariables(jax.random.PRNGKey(0)))
  lm = tp.Instantiate(device="cpu")
  convert.LoadJaxTheta(lm, theta)
  return task, theta, lm


def _Caches(states):
  """{path: array} of the K/V cache leaves."""
  return {k: np.asarray(v) for k, v in states.FlattenItems()
          if k.endswith(("key", "value"))}


@pytest.mark.parametrize("page, use_repeat_layer", [(4, True), (0, False)])
def test_prefill_and_extend_step_match_reference(page, use_repeat_layer):
  """Right-aligned prompts of lengths 8 and 5 (slots 0..2 of row 1 padded)
  primed in chunks of 3 with live_len, then 4 greedy ExtendSteps fed the
  reference's draws: logits at every step, caches at the live slots."""
  task, theta, lm = _TinyLm(use_repeat_layer, page)
  b, p_len, t_max = 2, 8, 4
  total = p_len + t_max                    # 3 pages of 4
  ids = np.random.RandomState(1).randint(1, 64, size=(b, p_len)).astype(
      np.int32)
  lens = np.array([8, 5])
  pad = (np.arange(total)[None] < (p_len - lens)[:, None]).astype(np.float32)
  j_pad, t_pad = jnp.asarray(pad), torch.as_tensor(pad)
  j_states = task.InitDecodeState(theta, b, total)
  t_states = lm.InitDecodeState(b, total)
  prefill = jax.jit(task.Prefill, static_argnames=("live_len",))
  for start in range(0, p_len, 3):
    chunk = ids[:, start:start + 3]
    live = start + chunk.shape[1]
    j_logits, j_states = prefill(theta, jnp.asarray(chunk), j_states,
                                 cache_paddings=j_pad, live_len=live)
    t_logits, t_states = lm.Prefill(torch.as_tensor(chunk), t_states,
                                    cache_paddings=t_pad, live_len=live)
    rows = np.arange(start, live)[None] >= (p_len - lens)[:, None]
    np.testing.assert_allclose(t_logits.numpy()[rows],
                               np.asarray(j_logits)[rows], atol=1e-4)
  ext = jax.jit(lambda i, s: task.ExtendStep(theta, i, s,
                                             cache_paddings=j_pad))
  launches = flash_decode.FlashDecode.launches
  nxt = np.argmax(np.asarray(j_logits)[:, -1], -1).astype(np.int32)
  for _ in range(t_max):
    j_out, j_states = ext(jnp.asarray(nxt[:, None]), j_states)
    t_out, t_states = lm.ExtendStep(torch.as_tensor(nxt[:, None]), t_states,
                                    cache_paddings=t_pad)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-4)
    np.testing.assert_array_equal(t_out.numpy().argmax(-1),
                                  np.asarray(j_out).argmax(-1))
    nxt = np.argmax(np.asarray(j_out), -1).astype(np.int32)
  assert flash_decode.FlashDecode.launches == launches   # CPU: plain
  live = (np.arange(total)[None] >= (p_len - lens)[:, None])[..., None, None]
  j_caches, t_caches = _Caches(j_states), _Caches(t_states)
  assert sorted(j_caches) == sorted(t_caches)
  for k, j_cache in j_caches.items():
    np.testing.assert_allclose(t_caches[k] * live, j_cache * live, atol=1e-4,
                               err_msg=k)
  steps = {v for k, v in t_states.FlattenItems() if k.endswith("time_step")}
  assert steps == {total}


@pytest.mark.parametrize("p_len, cut, total", [(6, 4, 24), (200, 130, 300)])
def test_trimmed_prefill_matches_full_cache_read(p_len, cut, total):
  """The reference test's assertion, held against the port: a two-chunk
  prefill whose reads are trimmed to live_len gives the one-pass full
  read's logits within 2e-5, and writes identical caches (the second
  case spans several read tiles)."""
  _, _, lm = _TinyLm()
  b = 2
  ids = torch.as_tensor(np.random.RandomState(1).randint(
      1, 64, size=(b, p_len)).astype(np.int32))
  full_states = lm.InitDecodeState(b, total)
  full, full_states = lm.Prefill(ids, full_states)
  trim_states = lm.InitDecodeState(b, total)
  la, trim_states = lm.Prefill(ids[:, :cut], trim_states, live_len=cut)
  lb, trim_states = lm.Prefill(ids[:, cut:], trim_states, live_len=p_len)
  trimmed = torch.cat([la, lb], dim=1)
  np.testing.assert_allclose(full.numpy(), trimmed.numpy(), atol=2e-5)
  for (k, fl), (_, tl) in zip(full_states.FlattenItems(),
                              trim_states.FlattenItems()):
    if isinstance(fl, torch.Tensor):
      np.testing.assert_array_equal(fl.numpy(), tl.numpy(), err_msg=k)
    else:
      assert fl == tl == p_len, k


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_tile_read_bits_do_not_depend_on_the_chunk_length(storage):
  """`_TileAttend`, the prefill's cache read: rows 4-5 of a 6-query chunk
  get bitwise the state of the same two queries read as a chunk of 2, on
  float32 tiles, bfloat16 tiles widened to float32 and int8 tiles
  dequantized (what `_ReadCache` hands it), over two tiles of 128 slots
  with their online softmax. This is what makes a trimmed prefill equal
  the full read bit for bit."""
  from lingvo_tpu_torch.quant import kv as kv_quant
  rng = np.random.RandomState(3)
  b, n, h, tile = 2, 4, 16, 128
  k = torch.as_tensor(rng.randn(b, 2 * tile, n, h).astype(np.float32))
  v = torch.as_tensor(rng.randn(b, 2 * tile, n, h).astype(np.float32))
  if storage == "bfloat16":
    k, v = k.bfloat16().float(), v.bfloat16().float()
  elif storage == "int8":
    k, v = (kv_quant.DequantKv(*kv_quant.QuantizeKv(x)) for x in (k, v))
  q = torch.as_tensor(rng.randn(b, 6, n, h).astype(np.float32))
  qpos = torch.arange(150, 156)

  def Read(qs, pos):
    c = qs.shape[1]
    m = torch.full((b, c, n, 1), -1.0e30)
    l = torch.zeros((b, c, n, 1))
    acc = torch.zeros((b, c, n, h))
    for start in (0, tile):
      slot = torch.arange(start, start + tile)
      keep = (slot[None, :] <= pos[:, None])[None, :, None, :]
      sl = slice(start, start + tile)
      m, l, acc = attention._TileAttend(qs, k[:, sl], v[:, sl], keep, m, l,
                                        acc)
    return m, l, acc

  full = Read(q, qpos)
  pair = Read(q[:, 4:6].contiguous(), qpos[4:6])
  for a, e in zip(full, pair):
    np.testing.assert_array_equal(a[:, 4:6].numpy(), e.numpy())


def test_ineligible_cache_takes_the_dense_read():
  """A cache that is not a whole number of pages reads densely."""
  _, _, lm = _TinyLm(decode_page_size=4)
  assert not lm.stack.body[0].self_atten.atten.PagedDecodeEligible(15)
  states = lm.InitDecodeState(2, 15)
  logits, _ = lm.ExtendStep(torch.ones((2, 1), dtype=torch.int32), states)
  assert logits.shape == (2, 64) and torch.isfinite(logits).all()


# -- GShardDecode ------------------------------------------------------------

_PROMPTS = np.array([[5, 6, 7, 8, 9, 10, 11], [12, 13, 14, 15, 0, 0, 0],
                     [16, 0, 0, 0, 0, 0, 0]], np.int32)
_LENS = np.array([7, 4, 1], np.int32)
_STEPS = 8   # bucket 16 + 8 = 24 slots: 6 pages of 4


def _JaxTiny(page):
  p = jax_spi.DenseLmTiny().Task()
  if page:
    p.atten_tpl = jax_attention.MultiHeadedAttention.Params().Set(
        decode_page_size=page)
  task = p.Instantiate()
  task.FinalizePaths()
  return task


def _PortTiny(page, seed=9):
  p = spi.DenseLmTiny().Task()
  if page:
    p.atten_tpl = attention.MultiHeadedAttention.Params().Set(
        decode_page_size=page)
  lm = p.Instantiate(device="cpu")
  lm.InstantiateVariables(torch.Generator("cpu").manual_seed(seed))
  return lm


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
  """DenseLmTiny's noised theta saved at step 1 by the JAX orbax
  checkpointer and by the port's; the JAX decoder's records (paged read,
  prefill chunks of 3)."""
  root = tmp_path_factory.mktemp("gshard")
  task = _JaxTiny(4)
  state = task.CreateTrainState(jax.random.PRNGKey(3))
  theta = _Noised(state.theta, seed=4, scale=0.3)
  state.theta = jax.tree_util.tree_map(jnp.asarray, theta)
  jax_dir = str(root / "jax")
  ckpt = jax_checkpointer.Checkpointer(jax_dir)
  ckpt.Save(1, state, force=True)
  ckpt.Close()
  want = jax_gshard.GShardDecode(
      task, jax_dir, str(root / "jax.jsonl"), max_decode_steps=_STEPS,
      prefill_chunk_size=3).DecodeOnce(1, _PROMPTS, _LENS)
  lm = _PortTiny(4)
  convert.LoadJaxTheta(lm, theta)
  port_dir = str(root / "port")
  assert checkpointer.Checkpointer(port_dir).Save(
      1, lm, lm.CreateTrainState(), force=True)
  return root, port_dir, want


@pytest.mark.parametrize("page, chunk, legacy", [
    (4, 3, False), (0, 0, False), (4, 0, True)])
def test_decode_once_matches_reference(checkpoints, page, chunk, legacy):
  root, port_dir, want = checkpoints
  assert len({tuple(r["output_ids"]) for r in want}) > 1
  out = str(root / f"port_{page}_{chunk}_{legacy}.jsonl")
  decoder = gshard_decode.GShardDecode(
      _PortTiny(page), port_dir, out, max_decode_steps=_STEPS,
      prefill_chunk_size=chunk, use_legacy_prime=legacy)
  got = decoder.DecodeOnce(1, _PROMPTS, _LENS)
  assert [r["output_ids"] for r in got] == [r["output_ids"] for r in want]
  assert [r["prompt_ids"] for r in got] == [r["prompt_ids"] for r in want]
  assert all(r["checkpoint_step"] == 1 for r in got)
  with open(out) as f:
    assert [json.loads(line) for line in f] == got
  tel, ref = got[0]["telemetry"], want[0]["telemetry"]
  assert tuple(tel) == observe_schema.GSHARD_TELEMETRY_KEYS
  assert gshard_decode.GSHARD_TELEMETRY_KEYS == (
      observe_schema.GSHARD_TELEMETRY_KEYS)
  for key in ("prompt_tokens", "decode_tokens", "kv_cache_dtype",
              "kv_bytes_per_token", "serve_int8_weights", "prefix_cache",
              "step_programs", "preemptions"):
    assert tel[key] == ref[key], key
  # K and V of 2 layers x 24 slots x d 64 in float32; the reference also
  # counts its two int32 time_step leaves (8 bytes over 3 rows), the
  # port's time_step is a host int
  assert tel["decode_state_bytes_per_seq"] == 2 * 2 * 24 * 64 * 4
  assert ref["decode_state_bytes_per_seq"] == (2 * 2 * 24 * 64 * 4 * 3 + 8) // 3
  assert tel["prefill_s"] > 0 and tel["decode_s"] > 0


def test_bucketing_shares_one_decode_fn(checkpoints):
  """Widths 4 and 7 both bucket to 16: one decode setup, continuations
  identical to exact-width setups."""
  root, port_dir, _ = checkpoints
  lm = _PortTiny(0)
  a, b = _PROMPTS[1:2, :4], _PROMPTS[:1]
  decoder = gshard_decode.GShardDecode(lm, port_dir, str(root / "b.jsonl"),
                                      max_decode_steps=4)
  r1 = decoder.DecodeOnce(1, a, [4])
  r2 = decoder.DecodeOnce(1, b, [7])
  assert list(decoder._decode_fns) == [(16, 4)]
  exact = gshard_decode.GShardDecode(lm, port_dir, str(root / "e.jsonl"),
                                     max_decode_steps=4, len_buckets=(4, 7))
  assert exact.DecodeOnce(1, a, [4])[0]["output_ids"] == r1[0]["output_ids"]
  assert exact.DecodeOnce(1, b, [7])[0]["output_ids"] == r2[0]["output_ids"]
  assert sorted(exact._decode_fns) == [(4, 4), (7, 4)]
  assert r2[0]["telemetry"]["step_programs"] == 2


def test_run_decodes_new_checkpoints_until_finished(checkpoints, tmp_path):
  root, port_dir, want = checkpoints
  lm = _PortTiny(0)
  train_dir = str(tmp_path / "train")
  ckpt = checkpointer.Checkpointer(train_dir)
  lm_src = _PortTiny(0)
  checkpointer.Checkpointer(port_dir).Restore(lm_src, step=1)
  ckpt.Save(5, lm_src, force=True)
  open(os.path.join(train_dir, "FINISHED"), "w").close()
  out = str(tmp_path / "run.jsonl")
  gshard_decode.GShardDecode(lm, train_dir, out, max_decode_steps=_STEPS,
                             poll_interval_secs=0.01).Run(_PROMPTS, _LENS)
  with open(out) as f:
    recs = [json.loads(line) for line in f]
  assert [r["checkpoint_step"] for r in recs] == [5, 5, 5]
  assert [r["output_ids"] for r in recs] == [r["output_ids"] for r in want]


@pytest.mark.parametrize("kw, match", [
    (dict(serve_port=0), "ROADMAP item 11")])
def test_unported_options_raise(kw, match, tmp_path):
  with pytest.raises(NotImplementedError, match=match):
    gshard_decode.GShardDecode(_PortTiny(0), str(tmp_path), "x.jsonl", **kw)


def test_right_align_and_buckets():
  out = gshard_decode.GShardDecode._RightAlign(_PROMPTS, _LENS, width=9)
  np.testing.assert_array_equal(
      out, jax_gshard.GShardDecode._RightAlign(_PROMPTS, _LENS, width=9))
  for bad in ([7, 4], [7, 4, 8], [7, -1, 1]):
    with pytest.raises(ValueError, match="prompt_lens"):
      gshard_decode.GShardDecode._RightAlign(_PROMPTS, np.asarray(bad))
  buckets = (16, 32, 64)
  assert [py_utils.RoundUpToBucket(n, buckets) for n in (0, 1, 16, 17, 64,
                                                          65)] == [
                                                              16, 16, 16, 32,
                                                              64, 65]
  with pytest.raises(ValueError):
    py_utils.RoundUpToBucket(-1, buckets)


# -- the checkpointer ----------------------------------------------------------


def test_checkpointer_round_trip(tmp_path):
  """Weights and optimizer state survive a save and a restore into a
  differently initialized task; max_to_keep drops the oldest steps; no
  temporary directory is left; restore-or-init without checkpoints."""
  src = _PortTiny(0, seed=1)
  state = src.CreateTrainState()
  for slot in state.opt_states[0].slots.values():
    for v in slot.values():
      v.normal_()
  state.step = 7
  ckpt = checkpointer.Checkpointer(str(tmp_path), save_interval_steps=5,
                                   max_to_keep=2)
  assert ckpt.LatestStep() is None
  dst = _PortTiny(0, seed=2)
  fresh = dst.CreateTrainState()
  assert ckpt.Restore(dst, state=fresh) == (fresh, 0)
  assert not ckpt.Save(3, src, state)            # off the cadence
  for step in (5, 10, 15):
    assert ckpt.Save(step, src, state)
  assert not ckpt.Save(15, src, state)           # already saved
  assert ckpt.Save(16, src, state, force=True)
  assert ckpt.Steps() == [15, 16] and ckpt.LatestStep() == 16
  assert sorted(os.listdir(tmp_path)) == ["ckpt_00000015", "ckpt_00000016"]
  restored, step = ckpt.Restore(dst, state=fresh)
  assert step == 16 and restored.step == 7
  for (k, a), (_, b) in zip(src.state_dict().items(),
                            dst.state_dict().items()):
    torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
  for (k, a), (_, b) in zip(checkpointer._OptItems(state),
                            checkpointer._OptItems(fresh)):
    torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
  with pytest.raises(FileNotFoundError):
    ckpt.Restore(dst, step=5)
  ckpt.Close()


def test_checkpointer_wall_clock_cadence(tmp_path):
  ckpt = checkpointer.Checkpointer(str(tmp_path), save_interval_seconds=3600)
  assert not ckpt.ShouldSave(1)
  ckpt = checkpointer.Checkpointer(str(tmp_path), save_interval_seconds=0)
  assert ckpt.ShouldSave(1)
  with pytest.raises(ValueError, match="max_to_keep"):
    checkpointer.Checkpointer(str(tmp_path), max_to_keep=0)
