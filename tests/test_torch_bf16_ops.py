"""The bf16 halves of the flash-attention and fused-xent plain versions against the JAX reference on the CPU.

The plain versions are the CPU path and the bf16 kernels' yardsticks on
the card, so they must round where the reference rounds.

- The bf16 flash plain versions (the Pallas twins) against the reference
  `FlashAttention(interpret=True)` with four reference key blocks (t 256,
  block 64), forward and `jax.vjp`: out and the gradients differ in at
  most 1e-3 of their elements by more than 1e-5 x max|want| (`_Share`:
  float32 sums in other orders can move a bf16 rounding), lse within
  2e-5; controls: p left unrounded, and p rounded at 16-key block maxima,
  must differ in ten times as many. The `_XlaAttention` twin (the CPU path
  below 2^21 elements) against the reference's small-shape lowering, with
  the Pallas twin (p rounded unnormalised) as its control; the CPU path
  picks its lowering by the reference's off-TPU rule.
- bf16 fused xent under both reference lowerings: statistics within
  1e-5, argmax equal, gradients within the `_Share` bar; float32 inputs of
  the same values (dz left unrounded) as the control.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lingvo_tpu.ops import flash_attention as jax_fa
from lingvo_tpu.ops import fused_xent as jax_fx
from lingvo_tpu_torch.ops import flash_attention as fa
from lingvo_tpu_torch.ops import fused_xent as fx

from tests.test_torch_bf16_layers import SHARE, _Share

# -- the bf16 flash plain versions against the interpreted Pallas kernel ------

B, T, N, H, BLOCK = 1, 256, 2, 32, 64


def _Dyadic(x, step):
  return np.round(x / step) * step


def _FlashInputs(seed, t=T):
  """Dyadic q and k (q.k exact in any order), v, do; segments 1 | 2 at 100
  and a padding tail from 230 (id 0)."""
  rng = np.random.RandomState(seed)
  q, k = (_Dyadic(rng.randn(B, t, N, H), 1 / 8).astype(np.float32)
          for _ in range(2))
  v, do = (rng.randn(B, t, N, H).astype(np.float32) for _ in range(2))
  seg = np.ones((B, t), np.int32)
  seg[0, 100 * t // T:] = 2
  seg[0, 230 * t // T:] = 0
  return q, k, v, do, seg


def _Bf(x):
  return torch.as_tensor(x).bfloat16()


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_pallas_twins_match_interpreted_kernel(causal):
  q, k, v, do, seg = _FlashInputs(0)
  jb = lambda x: jnp.asarray(x).astype(jnp.bfloat16)
  flat = lambda x: jb(x).transpose(0, 2, 1, 3).reshape(B * N, T, H)
  out_j, lse_j = jax_fa._FlashForward(flat(q), flat(k), flat(v),
                                      jnp.asarray(seg), BLOCK, BLOCK, causal,
                                      True)
  out_j = np.asarray(out_j.astype(jnp.float32)).reshape(
      B, N, T, H).transpose(0, 2, 1, 3)
  lse_j = np.asarray(lse_j[..., 0]).reshape(B, N, T)
  _, vjp = jax.vjp(lambda *a: jax_fa.FlashAttention(
      *a, causal=causal, segment_ids=jnp.asarray(seg), block_q=BLOCK,
      block_k=BLOCK, interpret=True), jb(q), jb(k), jb(v))
  grads_j = vjp(jb(do))
  tseg = torch.as_tensor(seg)
  out_t, lse_t = fa.FlashForward(_Bf(q), _Bf(k), _Bf(v), tseg, causal,
                                 BLOCK)
  assert out_t.dtype == torch.bfloat16
  assert _Share(out_t, out_j) <= SHARE
  assert float(np.abs(lse_t.numpy() - lse_j).max()) <= 2e-5
  leaves = [_Bf(x).requires_grad_(True) for x in (q, k, v)]
  fa._FlashFunction.apply(*leaves, tseg, causal, BLOCK).backward(_Bf(do))
  for gj, leaf in zip(grads_j, leaves):
    assert _Share(leaf.grad, gj) <= SHARE
  # controls: p unrounded (float32 inputs of the same values), and p
  # rounded against 16-key block maxima instead of 64-key ones
  unrounded = fa._PallasForward(*(_Bf(x).float() for x in (q, k, v)), tseg,
                                causal, BLOCK)[0]
  tile_max = fa._PallasForward(_Bf(q), _Bf(k), _Bf(v), tseg, causal, 16)[0]
  assert _Share(unrounded.bfloat16(), out_j) >= 10 * SHARE
  assert _Share(tile_max, out_j) >= 10 * SHARE


def test_bf16_xla_twin_matches_reference_small_shape_lowering():
  """Below 2^21 elements both sides take the `_XlaAttention` twin (p
  normalised, then rounded); the Pallas twin is the control."""
  t = 32
  q, k, v, do, seg = _FlashInputs(1, t=t)
  assert jax_fa.SelectedLowering(t, N, H) == "xla"
  jb = lambda x: jnp.asarray(x).astype(jnp.bfloat16)
  with jax.disable_jit():
    out_j, vjp = jax.vjp(lambda *a: jax_fa.FlashAttention(
        *a, causal=True, segment_ids=jnp.asarray(seg)), jb(q), jb(k), jb(v))
    grads_j = vjp(jb(do))
  tseg = torch.as_tensor(seg)
  leaves = [_Bf(x).requires_grad_(True) for x in (q, k, v)]
  assert fa.SelectedLowering(leaves[0]) == "xla-twin"
  out_t = fa.FlashAttention(*leaves, causal=True, segment_ids=tseg)
  out_t.backward(_Bf(do))
  assert _Share(out_t, out_j) <= SHARE
  for gj, leaf in zip(grads_j, leaves):
    assert _Share(leaf.grad, gj) <= SHARE
  control = fa._PallasForward(_Bf(q), _Bf(k), _Bf(v), tseg, True,
                              fa.FitBlock(t))[0]
  assert _Share(control, out_j) >= 10 * SHARE


def test_cpu_lowering_follows_the_reference_off_tpu_rule():
  big = torch.empty(1, 1024, 16, 128, dtype=torch.bfloat16)
  small = torch.empty(1, 1000, 16, 128, dtype=torch.bfloat16)
  assert fa.XLA_FALLBACK_MAX_ELEMS == jax_fa._XLA_FALLBACK_MAX_ELEMS
  assert fa.SelectedLowering(big.to("meta")) == "kernel"   # not on the CPU
  assert fa.SelectedLowering(big) == "pallas-twin"
  assert fa.SelectedLowering(small) == "xla-twin"
  assert fa.SelectedLowering(torch.zeros(1, 1024, 16, 128)) == "xla-twin"
  assert jax_fa.SelectedLowering(1024, 16, 128) == "pallas-interpret"
  assert jax_fa.SelectedLowering(1000, 16, 128) == "xla"
  assert [fa.FitBlock(t) for t in (1024, 2048, 320, 1536)] == [
      1024, 1024, 320, 512]


# -- bf16 fused xent ------------------------------------------------------------


@pytest.mark.parametrize("lowering", ["xla", "pallas"])
def test_bf16_fused_xent_matches_reference(lowering):
  """x and the table in bf16, a ragged tail (V 100, block 24), cap and
  label smoothing: the statistics are float32 and the backward rounds dz
  to bf16 before its products, as the reference's `_CoreBwd`."""
  m, d, vocab = 48, 32, 100
  rng = np.random.RandomState(5)
  x = rng.randn(m, d).astype(np.float32)
  w = (rng.randn(vocab, d) / 4).astype(np.float32)
  labels = rng.randint(0, vocab, m).astype(np.int32)
  jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)

  def Jax(x, w):
    o = jax_fx.FusedXent(x, w, jnp.asarray(labels), block_size=24,
                         logits_soft_max=30.0, label_smoothing=0.1,
                         lowering=lowering, interpret=True)
    return o.per_example_xent.sum() + 0.3 * o.label_log_prob.sum(), o

  (_, out_j), grads_j = jax.value_and_grad(Jax, argnums=(0, 1),
                                           has_aux=True)(jb(x), jb(w))

  def Port(xt, wt):
    o = fx.FusedXent(xt, wt, torch.as_tensor(labels), block_size=24,
                     logits_soft_max=30.0, label_smoothing=0.1)
    (o.per_example_xent.sum() + 0.3 * o.label_log_prob.sum()).backward()
    return o

  leaves = [_Bf(a).requires_grad_(True) for a in (x, w)]
  out_t = Port(*leaves)
  for name in ("per_example_xent", "label_log_prob", "lse"):
    assert getattr(out_t, name).dtype == torch.float32
    assert float(np.abs(getattr(out_t, name).detach().numpy()
                        - np.asarray(getattr(out_j, name))).max()) <= 1e-5
  np.testing.assert_array_equal(out_t.argmax.numpy(),
                                np.asarray(out_j.argmax))
  for gj, leaf in zip(grads_j, leaves):
    assert leaf.grad.dtype == torch.bfloat16
    assert _Share(leaf.grad, gj) <= SHARE
  ctl = [_Bf(a).float().requires_grad_(True) for a in (x, w)]
  Port(*ctl)
  for gj, leaf in zip(grads_j, ctl):
    assert _Share(leaf.grad, gj) >= 10 * SHARE
