"""Batch decode (`GShardDecode`, `Prefill` / `ExtendStep`) at fprop_dtype=bfloat16 in lingvo_tpu_torch against the JAX reference, on the CPU.

On DenseLmTiny at fprop_dtype=bfloat16 (weights float32):
- The LM's teacher-forced logits, step by step through `Prefill` and
  `ExtendStep`, against the reference run op by op (`jax.disable_jit()`),
  for kv_cache_dtype None (bfloat16 caches), 'float32' and 'int8':
  bfloat16 logits bitwise the reference's, so the greedy tokens too; the
  port at float32 activations, the control, is more than 1e-3 off. A
  float32 or int8 cache's dense reads give the attention layers float32
  outputs and the residual stream turns float32, as in the reference;
  the reference's repeat stack cannot carry that through its jitted scan,
  so those two run the unrolled stack on both sides.
- `GShardDecode` from a port checkpoint (bfloat16 caches, paged read),
  greedy, sampled and with int8 weights: continuations equal the JAX
  decoder's, run op by op, from the same theta (the jitted decoder keeps
  float32 inside its fusions and differs from both in one row), with the
  reference's telemetry; the theta is cast to bfloat16 once per restored
  step. With a float32 or int8 cache the port decodes a repeat stack the
  reference cannot, with the reference's KV census.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lingvo_tpu.core import attention as jax_attention
from lingvo_tpu.models.lm.params import synthetic_packed_input as jax_spi
from lingvo_tpu.quant import kv as jax_kv
from lingvo_tpu.runners import gshard_decode as jax_gshard
from lingvo_tpu_torch.core import attention
from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
from lingvo_tpu_torch.runners import gshard_decode

from tests.test_torch_bf16_serving_engine import (BF16, CheckLogits, _F32,
                                                  _Jnp, _KvDtypes, _PortLm,
                                                  _Unrolled,
                                                  dense)  # noqa: F401
from tests.test_torch_gshard_decode import (_LENS, _PROMPTS,
                                            checkpoints)  # noqa: F401

_STEPS = 4   # continuations of 4 tokens: the op-by-op reference is slow


@pytest.mark.parametrize("kv_dtype", [None, "float32", "int8"])
def test_teacher_forced_decode_logits_match_reference(dense, kv_dtype):
  """Right-aligned prompts primed by two Prefill chunks, then ExtendSteps
  fed the reference's greedy tokens (the dense read), with the reference
  op by op. A float32 or int8 cache's dense reads give the
  attention layers float32 outputs and the residual stream turns float32,
  as in the reference; its repeat stack cannot carry that through its
  scan (the jitted reference raises), so these run the unrolled stack."""
  task, theta, lm = dense if kv_dtype is None else _Unrolled(kv_dtype)
  ctl = _PortLm(theta, fprop=None, kv_cache_dtype=kv_dtype,
                use_repeat_layer=kv_dtype is None)
  theta = _Jnp(theta)
  b, p_len, steps = 2, 6, 4
  total = p_len + steps
  ids = np.random.RandomState(1).randint(1, 64, size=(b, p_len)).astype(
      np.int32)
  pad = (np.arange(total)[None] < np.array([[0], [2]])).astype(np.float32)
  t_, j_ = torch.as_tensor, jnp.asarray
  js = task.InitDecodeState(theta, b, total)
  ts, cs = lm.InitDecodeState(b, total), ctl.InitDecodeState(b, total)
  assert _KvDtypes(ts) == {getattr(torch, kv_dtype or "bfloat16")}
  with jax.disable_jit():
    for start in (0, 3):
      chunk = ids[:, start:start + 3]
      jl, js = task.Prefill(theta, j_(chunk), js, cache_paddings=j_(pad),
                            live_len=start + 3)
      tl, ts = lm.Prefill(t_(chunk), ts, cache_paddings=t_(pad),
                          live_len=start + 3)
      cl, cs = ctl.Prefill(t_(chunk), cs, cache_paddings=t_(pad),
                           live_len=start + 3)
      live = np.arange(start, start + 3)[None] >= np.array([[0], [2]])
      CheckLogits(tl, jl, cl, live)
    nxt = np.argmax(_F32(jl)[:, -1], -1).astype(np.int32)
    for _ in range(steps):
      jl, js = task.ExtendStep(theta, j_(nxt[:, None]), js,
                               cache_paddings=j_(pad))
      tl, ts = lm.ExtendStep(t_(nxt[:, None]), ts, cache_paddings=t_(pad))
      cl, cs = ctl.ExtendStep(t_(nxt[:, None]), cs, cache_paddings=t_(pad))
      CheckLogits(tl, jl, cl)
      nxt = np.argmax(_F32(jl), -1).astype(np.int32)




def _JaxBf16Tiny():
  p = jax_spi.DenseLmTiny().Task().Set(fprop_dtype=jnp.bfloat16)
  p.atten_tpl = jax_attention.MultiHeadedAttention.Params().Set(
      decode_page_size=4)
  task = p.Instantiate()
  task.FinalizePaths()
  return task


def _PortBf16Tiny(kv_dtype=None):
  p = spi.DenseLmTiny().Task().Set(fprop_dtype=BF16, kv_cache_dtype=kv_dtype)
  p.atten_tpl = attention.MultiHeadedAttention.Params().Set(
      decode_page_size=4)
  lm = p.Instantiate(device="cpu")
  lm.InstantiateVariables(torch.Generator("cpu").manual_seed(9))
  return lm


@pytest.mark.parametrize("kw", [{}, dict(temperature=1.5, top_k=5),
                                dict(serve_int8_weights=True)],
                         ids=["greedy", "sampled", "int8_weights"])
def test_gshard_decode_matches_reference(kw, checkpoints):
  """Continuations of DenseLmTiny at bfloat16 (bfloat16 caches, paged
  read, page 4; prefill chunks of 8) from the float32 checkpoints of step
  1: the port's from its own checkpointer, the reference's from orbax, op
  by op (the jitted decoder keeps float32 inside its fusions and differs
  in one row's continuation)."""
  root, port_dir, _ = checkpoints
  name = next(iter(kw), "greedy")
  with jax.disable_jit():
    jd = jax_gshard.GShardDecode(
        _JaxBf16Tiny(), str(root / "jax"), str(root / f"jax_bf16_{name}"),
        max_decode_steps=_STEPS, prefill_chunk_size=8, **kw)
    want = jd.DecodeOnce(1, _PROMPTS, _LENS)
  decoder = gshard_decode.GShardDecode(
      _PortBf16Tiny(), port_dir, str(root / f"port_bf16_{name}"),
      max_decode_steps=_STEPS, prefill_chunk_size=8, **kw)
  got = decoder.DecodeOnce(1, _PROMPTS, _LENS)
  assert len({tuple(r["output_ids"]) for r in want}) > 1
  assert [r["output_ids"] for r in got] == [r["output_ids"] for r in want]
  tel, ref = got[0]["telemetry"], want[0]["telemetry"]
  for key in ("kv_cache_dtype", "kv_bytes_per_token", "serve_int8_weights"):
    assert tel[key] == ref[key], key
  assert tel["kv_cache_dtype"] == "bfloat16"
  # the served theta is built once per restored step
  served = decoder._served
  assert served[0] == 1 and served[1] is not None
  decoder.DecodeOnce(1, _PROMPTS, _LENS)
  assert decoder._served is served


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_gshard_decode_dense_caches(kv_dtype, checkpoints):
  """A float32 or int8 cache under bfloat16 activations: the dense reads
  turn the residual stream float32 (the reference's promotion, held in
  test_teacher_forced_decode_logits_match_reference on the unrolled
  stack). The reference's repeat stack cannot carry that through its
  jitted scan (ROADMAP §3, deliberate divergences); the port's decodes
  whole continuations, with the reference's KV census."""
  root, port_dir, _ = checkpoints
  got = gshard_decode.GShardDecode(
      _PortBf16Tiny(kv_dtype), port_dir, str(root / f"port_bf16_{kv_dtype}"),
      max_decode_steps=_STEPS, prefill_chunk_size=8).DecodeOnce(
          1, _PROMPTS, _LENS)
  ref_task = _JaxBf16Tiny()
  out = np.array([r["output_ids"] for r in got])
  assert out.shape == (len(_LENS), _STEPS)
  assert ((out >= 0) & (out < ref_task.p.vocab_size)).all()
  census = jax_kv.StackKvCensus(ref_task, kv_dtype)
  tel = got[0]["telemetry"]
  assert tel["kv_cache_dtype"] == census["kv_cache_dtype"] == kv_dtype
  assert tel["kv_bytes_per_token"] == census["kv_bytes_per_token"]
