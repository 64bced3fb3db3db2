"""lingvo_tpu_torch flash attention against the JAX reference on the CPU.

- The plain `FlashAttention` (the CPU path) against the JAX `FlashAttention`
  run as the Pallas kernel in interpret mode (`block_q = block_k = 16`) at
  [2, 32, 2, 16]: causal and full, without segments and with a packed
  segment mask that starts a segment mid-block and ends in a padding tail
  of id 0. Out, the row logsumexp and the gradients of sum(out**2) agree
  within atol 2e-5 (float32; the frameworks sum in different orders).
- The autograd Function that ties the three kernels together, driven
  through the wrappers' CPU paths, gives the same gradients.
- `MultiHeadedAttention.FProp` with `use_flash_attention` on and off
  against the reference's, with paddings and segments.
- The wrappers raise on float16 and bad shapes; the kernels themselves
  are checked on the card by the `cuda`-marked cases, which skip here. The
  module imports JAX only inside `_Jax`, so on a machine with a card and
  no JAX the kernel cases run alone:

    python -m pytest tests/test_torch_flash_attention.py -m cuda
"""

import numpy as np
import pytest
import torch

from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import attention
from lingvo_tpu_torch.ops import flash_attention as fa

ATOL = 2e-5
B, T, N, H = 2, 32, 2, 16


def _Jax():
  """(jax, jax.numpy, the reference flash_attention, the reference
  attention module)."""
  import jax
  import jax.numpy as jnp
  from lingvo_tpu.core import attention as jax_attention
  from lingvo_tpu.ops import flash_attention as jax_fa
  return jax, jnp, jax_fa, jax_attention


def _Segments():
  """Row 0: segments 1 | 2 split mid-block (at 11), then a padding tail of
  id 0 from 25; row 1: one segment 1 | 2 split at the block edge 16."""
  seg = np.zeros((B, T), np.int32)
  seg[0, :11], seg[0, 11:25] = 1, 2
  seg[1, :16], seg[1, 16:] = 1, 2
  return seg


def _Inputs(seed):
  rng = np.random.RandomState(seed)
  return [rng.randn(B, T, N, H).astype(np.float32) for _ in range(3)]


def _JaxForward(q, k, v, seg, causal):
  """(out [b, t, n, h], lse [b, n, t]) of the Pallas kernel, interpreted."""
  _, jnp, jax_fa, _ = _Jax()
  flat = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * N, T, H)
  out, lse = jax_fa._FlashForward(
      flat(q), flat(k), flat(v), None if seg is None else jnp.asarray(seg),
      16, 16, causal, True)
  out = np.asarray(out).reshape(B, N, T, H).transpose(0, 2, 1, 3)
  return out, np.asarray(lse[..., 0]).reshape(B, N, T)


def _JaxGrads(q, k, v, seg, causal):
  jax, jnp, jax_fa, _ = _Jax()
  def Loss(q, k, v):
    out = jax_fa.FlashAttention(
        q, k, v, causal=causal,
        segment_ids=None if seg is None else jnp.asarray(seg),
        block_q=16, block_k=16, interpret=True)
    return jnp.sum(out ** 2)
  return jax.grad(Loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _TorchGrads(fn, q, k, v):
  leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
  torch.sum(fn(*leaves) ** 2).backward()
  return [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("with_seg", [False, True])
def test_plain_matches_interpreted_kernel(causal, with_seg):
  q, k, v = _Inputs(0)
  seg = _Segments() if with_seg else None
  out_j, lse_j = _JaxForward(q, k, v, seg, causal)
  tseg = None if seg is None else torch.as_tensor(seg)
  out_t, lse_t = fa.FlashForward(*map(torch.as_tensor, (q, k, v)), tseg,
                                 causal)
  np.testing.assert_allclose(out_t.numpy(), out_j, atol=ATOL, rtol=0)
  np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=ATOL, rtol=0)
  public = fa.FlashAttention(*map(torch.as_tensor, (q, k, v)), causal=causal,
                             segment_ids=tseg)
  np.testing.assert_allclose(public.numpy(), out_j, atol=ATOL, rtol=0)
  grads_j = _JaxGrads(q, k, v, seg, causal)
  grads_t = _TorchGrads(lambda *x: fa.FlashAttention(
      *x, causal=causal, segment_ids=tseg), q, k, v)
  for gj, gt in zip(grads_j, grads_t):
    np.testing.assert_allclose(gt, np.asarray(gj), atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_wires_the_three_kernels(causal):
  """The Function the CUDA path runs (forward kernel, delta, dK/dV, dQ),
  driven through the wrappers' CPU paths, matches autograd of the plain
  version; on the CPU it counts no launch."""
  q, k, v = _Inputs(1)
  seg = torch.as_tensor(_Segments())
  before = (fa.FlashForward.launches, fa.FlashDkDv.launches,
            fa.FlashDq.launches)
  via_fn = _TorchGrads(
      lambda *x: fa._FlashFunction.apply(*x, seg, causal), q, k, v)
  plain = _TorchGrads(lambda *x: fa._PlainAttention(*x, seg, causal), q, k, v)
  for a, b in zip(via_fn, plain):
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
  assert (fa.FlashForward.launches, fa.FlashDkDv.launches,
          fa.FlashDq.launches) == before


def test_row_delta_layout():
  rng = np.random.RandomState(2)
  do, out = (torch.as_tensor(rng.randn(B, T, N, H).astype(np.float32))
             for _ in range(2))
  delta = fa.RowDelta(do, out)
  assert delta.shape == (B, N, T) and delta.is_contiguous()
  np.testing.assert_allclose(
      delta.numpy(), np.einsum("btnh,btnh->bnt", do.numpy(), out.numpy()),
      atol=1e-5)


@pytest.mark.parametrize("use_flash", [False, True])
def test_mha_fprop_matches_reference(use_flash):
  """Causal self-attention with rotary, key paddings and segments: the
  flash path (paddings folded into the segment mask, ctx zeroed at pads)
  and the einsum path each match the reference's same path."""
  jax, jnp, _, jax_attention = _Jax()
  fields = dict(name="a", input_dim=24, num_heads=2,
                use_rotary_position_emb=True, use_flash_attention=use_flash)
  jl = jax_attention.MultiHeadedAttention.Params().Set(**fields).Instantiate()
  theta = jl.InstantiateVariables(jax.random.PRNGKey(3))
  rng = np.random.RandomState(3)
  theta = jax.tree_util.tree_map(
      lambda x: np.asarray(x) + 0.1 * rng.randn(*x.shape).astype(np.float32),
      theta)
  tl = attention.MultiHeadedAttention.Params().Set(**fields).Instantiate(
      device="cpu")
  convert.LoadJaxTheta(tl, theta)
  x = rng.randn(B, T, 24).astype(np.float32)
  paddings = np.zeros((B, T), np.float32)
  paddings[0, 25:] = 1.0
  seg = _Segments()
  out_j, _ = jl.FProp(theta, jnp.asarray(x), paddings=jnp.asarray(paddings),
                      segment_ids=jnp.asarray(seg), causal=True)
  out_t, probs = tl.FProp(torch.as_tensor(x),
                          paddings=torch.as_tensor(paddings),
                          segment_ids=torch.as_tensor(seg), causal=True)
  assert (probs is None) == use_flash
  np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                             atol=ATOL, rtol=1e-5)


def test_mha_flash_eligibility():
  tl = attention.MultiHeadedAttention.Params().Set(
      name="a", input_dim=8, num_heads=2,
      use_flash_attention=True).Instantiate(device="cpu")
  assert tl._FlashEligible(None, None, 32)
  assert not tl._FlashEligible(None, None, 30)          # t % 16
  assert not tl._FlashEligible(torch.zeros(1), None, 32)  # cross-attention
  assert not tl._FlashEligible(None, torch.zeros(1), 32)  # additive mask


def test_wrappers_raise_on_bf16_and_bad_shapes():
  """bfloat16 is taken since the bf16 slice; float16 and mixed dtypes
  still raise, as do bad shapes."""
  q = torch.zeros(1, 16, 2, 16)
  with pytest.raises(TypeError, match="float32 or bfloat16"):
    fa.FlashAttention(q.half(), q.half(), q.half())
  with pytest.raises(TypeError, match="share one dtype"):
    fa.FlashAttention(q.bfloat16(), q, q)
  assert fa.FlashAttention(q.bfloat16(), q.bfloat16(),
                           q.bfloat16()).dtype == torch.bfloat16
  with pytest.raises(ValueError, match="one \\[b, t, n, h\\] shape"):
    fa.FlashForward(q, q[:, :8], q[:, :8], None, True)
  with pytest.raises(ValueError, match="segment ids must be int32"):
    fa.FlashForward(q, q, q, torch.zeros(1, 15, dtype=torch.int32), True)
  rows = torch.zeros(1, 2, 16)
  with pytest.raises(ValueError, match="lse must be float32"):
    fa.FlashDkDv(q, q, q, None, q, rows[:, :, :8], rows, True)
  with pytest.raises(ValueError, match="runs on cpu or cuda"):
    fa.FlashAttention(q.to("meta"), q.to("meta"), q.to("meta"))


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: the flash kernels are CUDA C++ with no "
                "CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_kernels_match_plain_on_card(cuda, causal):
  """The three kernels at t = 200 (a ragged last tile), h = 64, against
  the plain version on the card."""
  rng = np.random.RandomState(4)
  q, k, v, do = (torch.as_tensor(rng.randn(2, 200, 3, 64).astype(
      np.float32)).cuda() for _ in range(4))
  seg = np.ones((2, 200), np.int32)
  seg[0, 70:] = 2
  seg[1, 150:] = 0
  seg = torch.as_tensor(seg).cuda()
  out, lse = fa.FlashForward(q, k, v, seg, causal)
  out_p, lse_p = fa._PlainForward(q, k, v, seg, causal)
  delta = fa.RowDelta(do, out)
  dk, dv = fa.FlashDkDv(q, k, v, seg, do, lse, delta, causal)
  dq = fa.FlashDq(q, k, v, seg, do, lse, delta, causal)
  dq_p, dk_p, dv_p = fa._PlainBackward(q, k, v, seg, do, causal)
  torch.cuda.synchronize()
  for got, want in ((out, out_p), (lse, lse_p)):
    assert float((got - want).abs().max()) <= 2e-5
  for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_unsupported_head_dim(cuda):
  q = torch.zeros(1, 16, 2, 24, device="cuda")
  with pytest.raises(ValueError, match="multiple of 16"):
    fa.FlashForward(q, q, q, None, True)


def _CardInputs(t, h, seed, b=2, n=2):
  """q, k, v on the card and segment ids: row 0 switches segment at 37
  (inside a tile of 32 keys and of 64 queries) and ends in padding (id 0)
  for its last t // 5 tokens; row 1 is one segment."""
  rng = np.random.RandomState(seed)
  q, k, v = (torch.as_tensor(rng.randn(b, t, n, h).astype(np.float32)).cuda()
             for _ in range(3))
  seg = np.ones((b, t), np.int32)
  seg[0, min(37, t):] = 2
  seg[0, t - t // 5:] = 0
  return q, k, v, torch.as_tensor(seg).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h", [16, 64, 128])
@pytest.mark.parametrize("t", [77, 1000])
def test_forward_kernel_edges_on_card(cuda, t, h, causal):
  """The forward kernel at t that is not a multiple of its tiles, with a
  segment boundary inside a tile and a padding tail: out and lse within
  2e-5 of the plain version, and within it again without segments."""
  q, k, v, seg = _CardInputs(t, h, seed=t + h)
  for s in (seg, None):
    out, lse = fa.FlashForward(q, k, v, s, causal)
    out_p, lse_p = fa._PlainForward(q, k, v, s, causal)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
    assert float((out - out_p).abs().max()) <= 2e-5
    assert float((lse - lse_p).abs().max()) <= 2e-5


@pytest.mark.cuda
def test_forward_kernel_bitwise_repeat(cuda):
  """Two calls of the forward kernel give the same bits."""
  q, k, v, seg = _CardInputs(1000, 128, seed=6)
  first = fa.FlashForward(q, k, v, seg, True)
  again = fa.FlashForward(q, k, v, seg, True)
  torch.cuda.synchronize()
  assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def _CardBackwardInputs(t, h, seed):
  """`_CardInputs` plus the output gradient do."""
  q, k, v, seg = _CardInputs(t, h, seed)
  rng = np.random.RandomState(seed + 1)
  do = torch.as_tensor(rng.randn(*q.shape).astype(np.float32)).cuda()
  return q, k, v, seg, do


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h", [16, 48, 64, 96, 128])
@pytest.mark.parametrize("t", [20, 77, 200, 1000])
def test_backward_kernel_edges_on_card(cuda, t, h, causal):
  """The float32 dK/dV and dQ kernels at t shorter than one streamed tile
  (20: below the 32 queries of a dK/dV tile and the 64 keys of a dQ tile)
  and at t that is not a multiple of the tiles, with a segment boundary
  inside a tile and a padding tail: dq, dk and dv within 1e-4 x max|grad|
  of the plain backward (float32 sums over up to t rows in other orders),
  and within it again without segments. h = 48 and 96 take the row copy
  whose 256 threads do not divide into whole rows (256 % (h / 4) != 0),
  and h = 96 the two-column accumulation with its columns past h
  clamped."""
  q, k, v, seg, do = _CardBackwardInputs(t, h, seed=t + h)
  for s in (seg, None):
    out, lse = fa.FlashForward(q, k, v, s, causal)
    delta = fa.RowDelta(do, out)
    dk, dv = fa.FlashDkDv(q, k, v, s, do, lse, delta, causal)
    dq = fa.FlashDq(q, k, v, s, do, lse, delta, causal)
    dq_p, dk_p, dv_p = fa._PlainBackward(q, k, v, s, do, causal)
    torch.cuda.synchronize()
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
      assert bool(torch.isfinite(got).all())
      assert float((got - want).abs().max()) <= 1e-4 * float(
          want.abs().max())


@pytest.mark.cuda
def test_backward_kernels_bitwise_repeat(cuda):
  """Two calls of each float32 backward kernel give the same bits (no
  floating-point atomics: each element is summed by one thread, in
  order)."""
  q, k, v, seg, do = _CardBackwardInputs(1000, 128, seed=6)
  out, lse = fa.FlashForward(q, k, v, seg, True)
  delta = fa.RowDelta(do, out)
  first = fa.FlashDkDv(q, k, v, seg, do, lse, delta, True) + (
      fa.FlashDq(q, k, v, seg, do, lse, delta, True),)
  again = fa.FlashDkDv(q, k, v, seg, do, lse, delta, True) + (
      fa.FlashDq(q, k, v, seg, do, lse, delta, True),)
  torch.cuda.synchronize()
  assert all(torch.equal(a, b) for a, b in zip(first, again))


def _Dyadic(x, step):
  """x on a grid of `step`: q.k is then exact in any order of its sum, so
  scores, maxima and p agree bit for bit wherever p is rounded alike."""
  return np.round(x / step) * step


def _Bf16CardInputs(t, h, seed, b=2, n=2):
  """Dyadic bf16 q, k, v and do on the card (q.k and dp = do.v exact in
  any order, so both sides round the same p and ds), and the segment ids
  of `_CardInputs` (a switch at 37, a padding tail)."""
  rng = np.random.RandomState(seed)
  q, k, v, do = (_Dyadic(rng.randn(b, t, n, h), 1 / 8) for _ in range(4))
  seg = np.ones((b, t), np.int32)
  seg[0, 37:] = 2
  seg[0, t - t // 5:] = 0
  bf = lambda x: torch.as_tensor(x.astype(np.float32)).bfloat16().cuda()
  return bf(q), bf(k), bf(v), bf(do), torch.as_tensor(seg).cuda()


def _Share(got, want):
  """The share of elements that differ by more than 1e-5 x max|want|. The
  floor only spares the noise of exact cancellations (a query's only key
  has ds = p (dp - delta) = 0 up to rounding, summed in another order):
  a bf16 rounding of a value above it is 2^-8 of the value and counts."""
  got, want = got.float(), want.float()
  floor = 1e-5 * float(want.abs().max())
  return float(((got - want).abs() > floor).float().mean())


def _OffByMoreThanAnUlp(got, want):
  """The elements with |got - want| > 2^-7 |want| + 1e-5 max|want|: one
  bf16 ulp, the most that float32 sums of the same terms in two orders
  can move a single rounding (the floor as in `_Share`). `_Share` bounds
  how many elements differ, this how far any of them is off."""
  got, want = got.float(), want.float()
  bar = 2.0 ** -7 * want.abs() + 1e-5 * float(want.abs().max())
  return int(((got - want).abs() > bar).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t, h, block_k", [(512, 128, 128), (320, 64, 64),
                                           (256, 128, 256)])
def test_bf16_kernels_match_pallas_twin_on_card(cuda, t, h, block_k, causal):
  """The bf16 forward, dK/dV and dQ kernels against `_PallasForward` /
  `_PallasBackward` on dyadic inputs, with several reference key blocks
  (t / block_k of 4, 5 and 1). Tolerance: out, dq, dk and dv differ in at
  most 1e-3 of their elements (`_Share`: float32 sums of exact products in
  other orders, then one bf16 rounding), and no element by more than one
  bf16 ulp (`_OffByMoreThanAnUlp`); lse within 2e-5. The control, p
  rounded against 64-key tile maxima (block 64), must differ in at least
  10 times as many out elements where the reference block is wider."""
  q, k, v, do, seg = _Bf16CardInputs(t, h, seed=t + h)
  before = dict(fa.FlashForward.launches_by_dtype)
  out, lse = fa.FlashForward(q, k, v, seg, causal, block_k)
  out_p, lse_p = fa._PallasForward(q, k, v, seg, causal, block_k)
  delta = fa.RowDelta(do, out)
  dk, dv = fa.FlashDkDv(q, k, v, seg, do, lse, delta, causal)
  dq = fa.FlashDq(q, k, v, seg, do, lse, delta, causal)
  dq_p, dk_p, dv_p = fa._PallasBackward(q, k, v, seg, do, lse, delta, causal)
  torch.cuda.synchronize()
  assert fa.FlashForward.launches_by_dtype["bfloat16"] == (
      before["bfloat16"] + 1)
  assert out.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
  assert bool(torch.isfinite(out.float()).all())
  assert float((lse - lse_p).abs().max()) <= 2e-5
  share = _Share(out, out_p)
  assert share <= 1e-3
  for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
    assert _Share(got, want) <= 1e-3
  for got, want in ((out, out_p), (dq, dq_p), (dk, dk_p), (dv, dv_p)):
    assert _OffByMoreThanAnUlp(got, want) == 0
  if block_k > 64:
    control = fa._PallasForward(q, k, v, seg, causal, 64)[0]
    assert _Share(control, out_p) >= 10 * max(share, 1e-3)


def _CheckBf16Forward(q, k, v, seg, causal, block_k):
  """The bf16 forward kernel against `_PallasForward` at the bars of
  `test_bf16_kernels_match_pallas_twin_on_card`, plus two calls bitwise
  equal and, where the reference block is wider than a tile, the 64-key
  tile-max control 10x further off."""
  out, lse = fa.FlashForward(q, k, v, seg, causal, block_k)
  again = fa.FlashForward(q, k, v, seg, causal, block_k)
  out_p, lse_p = fa._PallasForward(q, k, v, seg, causal, block_k)
  torch.cuda.synchronize()
  assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
  assert bool(torch.isfinite(out.float()).all())
  assert float((lse - lse_p).abs().max()) <= 2e-5
  share = _Share(out, out_p)
  assert share <= 1e-3
  assert _OffByMoreThanAnUlp(out, out_p) == 0
  if block_k > 64:
    control = fa._PallasForward(q, k, v, seg, causal, 64)[0]
    assert _Share(control, out_p) >= 10 * max(share, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t, h, block_k, b, n", [
    (192, 128, 64, 2, 2), (1024, 128, 1024, 1, 2), (256, 16, 256, 2, 2),
    (320, 16, 64, 2, 2), (100, 64, 100, 2, 2), (256, 96, 256, 1, 2)])
def test_bf16_forward_shapes_on_card(cuda, t, h, block_k, b, n, causal):
  """The bf16 forward's 128-query blocks at t = 192 (a half-empty last
  query tile), at one reference block of 1024 keys (b 1, n 2), at h = 16
  (one TMA box, its columns past h read as zeros), at t = 100 (a partial
  key tile: rows past t read as zeros and masked) and at h = 96 (a second
  box half past h), with the segments of `_Bf16CardInputs`."""
  q, k, v, _, seg = _Bf16CardInputs(t, h, seed=t + h + b, b=b, n=n)
  _CheckBf16Forward(q, k, v, seg, causal, block_k)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_forward_heavy_first_with_skipped_tiles(cuda, causal):
  """t = 1024, h = 64, reference blocks of 256: row 0 has segments of
  200, 500 and 324 keys, row 1 one of 900 and a padding tail of 124, so
  the query tiles that run first (the heaviest causal ones) skip most key
  tiles by their segment ids, some reference blocks wholly."""
  t, h = 1024, 64
  q, k, v, _, _ = _Bf16CardInputs(t, h, seed=31)
  seg = np.zeros((2, t), np.int32)
  seg[0, :200], seg[0, 200:700], seg[0, 700:] = 1, 2, 3
  seg[1, :900] = 1
  _CheckBf16Forward(q, k, v, torch.as_tensor(seg).cuda(), causal, 256)


@pytest.mark.cuda
def test_bf16_forward_refuses_blocks_of_partial_tiles(cuda):
  q = torch.zeros(1, 96, 2, 16, device="cuda", dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="multiple of 64"):
    fa.FlashForward(q, q, q, None, True, 32)


def _CheckBf16Backward(q, k, v, do, seg, causal):
  """The bf16 dK/dV and dQ kernels against `_PallasBackward` on the lse
  and delta of the bf16 forward kernel, at the bars of
  `test_bf16_kernels_match_pallas_twin_on_card`: dq, dk and dv differ in
  at most 1e-3 of their elements (`_Share`) and no element by more than
  one bf16 ulp (`_OffByMoreThanAnUlp`)."""
  out, lse = fa.FlashForward(q, k, v, seg, causal)
  delta = fa.RowDelta(do, out)
  dk, dv = fa.FlashDkDv(q, k, v, seg, do, lse, delta, causal)
  dq = fa.FlashDq(q, k, v, seg, do, lse, delta, causal)
  dq_p, dk_p, dv_p = fa._PallasBackward(q, k, v, seg, do, lse, delta, causal)
  torch.cuda.synchronize()
  for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
    assert got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert _Share(got, want) <= 1e-3
    assert _OffByMoreThanAnUlp(got, want) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h", [16, 48, 64, 96, 128])
@pytest.mark.parametrize("t", [20, 77, 200, 1000])
def test_bf16_backward_kernel_edges_on_card(cuda, t, h, causal):
  """The bf16 dK/dV and dQ kernels at t shorter than one streamed tile
  (20: below the 64 rows of a tile and the 128 a block owns) and at t
  that is not a multiple of the tiles (rows past t read as zeros by TMA
  and masked), with a segment switch at 37 inside a tile and a padding
  tail (`_Bf16CardInputs`), and again without segments. h = 16 and 48 take
  one TMA box with its columns past h read as zeros, h = 96 a second box
  half past h."""
  q, k, v, do, seg = _Bf16CardInputs(t, h, seed=t + h)
  for s in (seg, None):
    _CheckBf16Backward(q, k, v, do, s, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_backward_partial_last_tile_on_card(cuda, causal):
  """b n = 9 blocks on grid x, and t = 200 leaves the last 128-row block
  and the last 64-row tile partial."""
  q, k, v, do, seg = _Bf16CardInputs(200, 128, seed=44, b=3, n=3)
  _CheckBf16Backward(q, k, v, do, seg, causal)


@pytest.mark.cuda
def test_bf16_backward_kernels_bitwise_repeat(cuda):
  """Two calls of each bf16 backward kernel give the same bits (no
  floating-point atomics: each element is summed by one thread, in tile
  order)."""
  q, k, v, do, seg = _Bf16CardInputs(1000, 128, seed=6)
  out, lse = fa.FlashForward(q, k, v, seg, True)
  delta = fa.RowDelta(do, out)
  first = fa.FlashDkDv(q, k, v, seg, do, lse, delta, True) + (
      fa.FlashDq(q, k, v, seg, do, lse, delta, True),)
  again = fa.FlashDkDv(q, k, v, seg, do, lse, delta, True) + (
      fa.FlashDq(q, k, v, seg, do, lse, delta, True),)
  torch.cuda.synchronize()
  assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_bf16_backward_geometry_has_no_spills(cuda):
  """Both bf16 backward kernels at h = 64 and 128: one block per SM, and
  no local (spill) memory, though dK/dV holds 192 float32 accumulators a
  thread at h = 128."""
  for h in (64, 128):
    for name, g in fa.BackwardGeometry(1024, h, torch.bfloat16).items():
      assert g["per_sm"] == 1, (h, name, g)
      assert g["local"] == 0, (h, name, g)
