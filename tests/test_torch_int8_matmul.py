"""The int8-serving matmul kernels of lingvo_tpu_torch (ops/int8_matmul.py).

The plain versions on the CPU:
- `QuantizeActivations`: one scale over the whole x, a true division and
  round half to even (x / x_scale exactly on .5 rounds to the even
  integer), clip at [-128, 127], rows zero-padded to a multiple of 16;
- `Int8Gemm`: the int32 product against numpy's int64 one, then float32
  times x_scale, then times the per-channel scale;
- `GemmPlan`: the K splits are non-empty and cover Kp exactly, a cluster
  holds at most 8 blocks, the operands swap for M <= 64; `QuantizePlan`:
  one cluster of at most 8 blocks covers every row and holds no more
  than a block's shared memory.

The `cuda` cases (they skip without a card) hold kernel (a) and kernel
(b) against the plain versions on the card bit for bit, at M in {1, 8,
17, 64, 65, 264, 2048}, in both orientations, with K split over a
cluster and not, at DenseLm1B's shapes and at K and N that are not
multiples of the tiles (K = 72, 100, 200: the weight loaded without
TMA), and `Int8Weight.Einsum` on the card against the CPU in both
layouts; the bfloat16 instantiations (fprop_dtype=bfloat16) bit for bit
their float32 runs on the widened x, rounded. This file imports no JAX,
so on the card run

    python -m pytest tests/test_torch_int8_matmul.py -m cuda
"""

import itertools

import numpy as np
import pytest
import torch

from lingvo_tpu_torch.core import quant_utils
from lingvo_tpu_torch.ops import int8_matmul


def _X(m, k, seed=0, scale=3.0):
  return torch.tensor(
      np.random.RandomState(seed).randn(m, k).astype(np.float32) * scale)


def _W(n, k, seed=1):
  rng = np.random.RandomState(seed)
  w = torch.tensor(rng.randint(-128, 128, size=(n, k)).astype(np.int8))
  s = torch.tensor((rng.rand(n) * 0.01 + 1e-4).astype(np.float32))
  return w, s


def test_quantize_rounds_half_to_even_and_pads():
  x = torch.tensor([[127.0, 2.5, 3.5, -2.5, -0.5, 0.5, 1.5, 0.0],
                    [-127.0, 126.5, -126.5, 64.0, 0.49, 0.51, 5.0, 7.0]])
  x8, x_scale = int8_matmul.QuantizeActivations(x)
  assert x_scale.tolist() == [1.0]
  assert x8.shape == (2, 16) and x8.dtype == torch.int8
  assert x8[0, :8].tolist() == [127, 2, 4, -2, 0, 0, 2, 0]
  assert x8[1, :8].tolist() == [-127, 126, -126, 64, 0, 1, 5, 7]
  assert not x8[:, 8:].any()


def test_quantize_zero_input_takes_the_floor_scale():
  x8, x_scale = int8_matmul.QuantizeActivations(torch.zeros(3, 32))
  assert x_scale.item() == np.float32(1e-8)
  assert not x8.any()


def test_plain_gemm_matches_numpy():
  m, k, n = 5, 72, 100
  x = _X(m, k)
  w, s = _W(n, k)
  x8, x_scale = int8_matmul.QuantizeActivations(x)
  y = int8_matmul.Int8Gemm(x8, x_scale, w, s)
  acc = x8[:, :k].numpy().astype(np.int64) @ w.numpy().astype(np.int64).T
  want = (acc.astype(np.float32) * x_scale.numpy()[0]) * s.numpy()[None]
  np.testing.assert_array_equal(y.numpy(), want)
  assert int8_matmul.QuantizeActivations.launches == 0
  assert int8_matmul.Int8Gemm.launches == 0


# every m the ported paths give (decode rows, both sides of the swap, the
# ragged step's 264, a legacy mixed step's B x C) at the step's shapes and
# at K and N off the tiles
_PLAN_SHAPES = ((2048, 2048), (2048, 8192), (8192, 2048), (2048, 32000),
                (72, 100), (200, 136), (64, 8))


def _KSplits(plan, kp):
  """The byte ranges [k0, k1) of x8's padded K that a tile's splits under
  `plan` multiply, in rank order (the kernel's kb0 = split * kb_per_split
  128-byte blocks, the last run cut at Kp)."""
  run = plan["kb_per_split"] * int8_matmul.K_BLOCK
  return [(s * run, min(kp, (s + 1) * run)) for s in range(plan["cluster"])]


@pytest.mark.parametrize("m, k, n", [
    (m, k, n) for m, (k, n) in itertools.product(
        (1, 8, 17, 64, 65, 264, 2048), _PLAN_SHAPES)])
def test_gemm_geometry(m, k, n):
  plan = int8_matmul.GemmPlan(m, k, n, 132)
  kp = int8_matmul.PaddedK(k)
  # the swap follows m; the swapped B operand holds every row
  assert plan["swap"] == (m <= int8_matmul.SWAP_MAX_M)
  if plan["swap"]:
    assert plan["nb"] in int8_matmul.SWAP_N and plan["nb"] >= m
    assert plan["nb"] == 8 or plan["nb"] // 2 < m
    assert (plan["tile_m"], plan["tile_n"], plan["m_tiles"]) == (
        plan["nb"], 64, 1)
  else:
    assert (plan["tile_m"], plan["tile_n"]) == (128, 128)
  assert plan["m_tiles"] * plan["tile_m"] >= m > (
      plan["m_tiles"] - 1) * plan["tile_m"]
  assert plan["n_tiles"] * plan["tile_n"] >= n > (
      plan["n_tiles"] - 1) * plan["tile_n"]
  # a cluster holds at most 8 blocks (a power of two); every K split is
  # non-empty and the splits cover Kp exactly, in order
  assert plan["cluster"] in (1, 2, 4, 8)
  splits = _KSplits(plan, kp)
  assert len(splits) == plan["cluster"]
  assert splits[0][0] == 0 and splits[-1][1] == kp
  assert all(k0 < k1 for k0, k1 in splits)
  assert all(a[1] == b[0] for a, b in zip(splits, splits[1:]))
  assert plan["blocks"] == plan["m_tiles"] * plan["n_tiles"] * plan["cluster"]
  # K is not split where the tiles alone fill two waves of the card
  wave = min(plan["per_sm"], int8_matmul.GEMM_STREAMS_PER_SM) * 132
  if plan["m_tiles"] * plan["n_tiles"] >= 2 * wave:
    assert plan["cluster"] == 1
  assert plan["smem"] + 1024 <= int8_matmul.SMEM_PER_SM // plan["per_sm"]


@pytest.mark.parametrize("max_blocks", [8, 16])
@pytest.mark.parametrize("m, k, itemsize", [
    (1, 72, 4), (8, 2048, 4), (8, 2048, 2), (17, 100, 2), (264, 2048, 4),
    (264, 8192, 4), (264, 2048, 2), (2048, 8192, 4), (3, 100000, 4)])
def test_quantize_plan(m, k, itemsize, max_blocks):
  plan = int8_matmul.QuantizePlan(m, k, itemsize, max_blocks)
  assert 1 <= plan["blocks"] <= max_blocks
  # the blocks' rows cover x, none empty
  assert (plan["blocks"] - 1) * plan["rows"] < m <= plan["blocks"] * plan[
      "rows"]
  # a block holds all its rows (x read once) where they fit, else none
  fits = k * itemsize * plan["rows"] <= int8_matmul.QUANT_HOLD_BYTES
  assert plan["held"] == (plan["rows"] if fits else 0)


def test_wrapper_checks():
  x8, x_scale = int8_matmul.QuantizeActivations(_X(2, 32))
  w, s = _W(4, 32)
  with pytest.raises(TypeError):
    int8_matmul.QuantizeActivations(_X(2, 32).double())
  with pytest.raises(ValueError):
    int8_matmul.Int8Gemm(x8, x_scale, w[:, :16], s)
  with pytest.raises(ValueError):
    int8_matmul.Int8Gemm(x8, x_scale, w, s[:3])
  with pytest.raises(TypeError):
    int8_matmul.Int8Gemm(x8.int(), x_scale, w, s)
  assert int8_matmul.Int8Matmul(torch.zeros(0, 32), w, s).shape == (0, 4)
  with pytest.raises(ValueError):
    int8_matmul.Int8Matmul(_X(2, 32).double(), w, s)
  with pytest.raises(ValueError):
    int8_matmul.Int8Matmul(_X(2, 16), w, s)
  assert int8_matmul.KernelLimitError(0, 32, 4) is not None
  assert int8_matmul.KernelLimitError(8, 2048, 32000) is None


def test_bf16_activations_are_widened_and_the_output_rounded():
  """Under fprop_dtype=bfloat16: x quantized from its widened values, y
  the float32 product rounded to bfloat16 once (the reference's
  x.astype(float32) ... .astype(x.dtype)); an Int8Weight serves a
  bfloat16 x in bfloat16."""
  x = _X(5, 64).bfloat16()
  w, s = _W(24, 64)
  x8, x_scale = int8_matmul.QuantizeActivations(x)
  w8, ws = int8_matmul.QuantizeActivations(x.float())
  assert torch.equal(x8, w8) and torch.equal(x_scale, ws)
  y = int8_matmul.Int8Gemm(x8, x_scale, w, s, out_dtype=torch.bfloat16)
  assert y.dtype == torch.bfloat16
  assert torch.equal(y, int8_matmul.Int8Gemm(x8, x_scale, w, s).bfloat16())
  assert torch.equal(int8_matmul.Int8Matmul(x, w, s), y)
  weight = quant_utils.Int8Weight.Quantize(torch.tensor(
      np.random.RandomState(2).randn(64, 24).astype(np.float32)))
  out = weight.Einsum(x)
  assert out.dtype == torch.bfloat16
  assert torch.equal(out, weight.Einsum(x.float()).bfloat16())
  with pytest.raises(TypeError, match="float32 or bfloat16"):
    int8_matmul.Int8Gemm(x8, x_scale, w, s, out_dtype=torch.float16)


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (the int8 kernels run only on a card)")
  torch.backends.cuda.matmul.allow_tf32 = False


def _CheckOnCard(x, w, s):
  """Kernel (a) and kernel (b) against the plain versions on the card,
  bit for bit, each launched once."""
  xc, wc, sc = x.cuda(), w.cuda(), s.cuda()
  q0 = int8_matmul.QuantizeActivations.launches
  g0 = int8_matmul.Int8Gemm.launches
  x8, x_scale = int8_matmul.QuantizeActivations(xc)
  y = int8_matmul.Int8Gemm(x8, x_scale, wc, sc)
  torch.cuda.synchronize()
  assert int8_matmul.QuantizeActivations.launches == q0 + 1
  assert int8_matmul.Int8Gemm.launches == g0 + 1
  px8, px_scale = int8_matmul._PlainQuantize(xc)
  assert torch.equal(x_scale, px_scale)
  assert torch.equal(x8, px8)
  want = int8_matmul._PlainGemm(x8, x_scale, wc, sc)
  assert torch.equal(y, want)
  # both kernels from one call (the serving path): the same bits
  assert torch.equal(int8_matmul.Int8Matmul(xc, wc, sc), y)
  assert int8_matmul.QuantizeActivations.launches == q0 + 2
  assert int8_matmul.Int8Gemm.launches == g0 + 2
  # and the CPU's plain path, an int32 matmul
  assert torch.equal(y.cpu(), int8_matmul.Int8Matmul(x, w, s))
  return y


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 17, 64, 65, 264, 2048])
@pytest.mark.parametrize("k, n", [(2048, 2048), (8192, 2048), (2048, 8192),
                                  (72, 100), (64, 8), (200, 136)])
def test_kernels_match_plain_on_card(cuda, m, k, n):
  x = _X(m, k, seed=m + k)
  w, s = _W(n, k, seed=n)
  _CheckOnCard(x, w, s)


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n, swap, split", [
    (8, 2048, 2048, True, True), (1, 8192, 2048, True, True),
    (64, 2048, 32000, True, False), (17, 200, 136, True, True),
    (264, 2048, 2048, False, True), (264, 8192, 2048, False, True),
    (2048, 2048, 8192, False, False), (65, 8192, 2048, False, True),
    (264, 1000, 2048, False, True)])
def test_gemm_orientations_and_clusters_on_card(cuda, m, k, n, swap, split):
  """Both orientations, K split over a cluster or not, the weight by TMA
  and (K = 200, 1000: rows not a multiple of 16 bytes) by the producer
  warp's loads: bitwise the plain versions, and in bfloat16 bitwise the
  float32 kernel rounded."""
  plan = int8_matmul.GemmPlan(
      m, k, n, torch.cuda.get_device_properties(0).multi_processor_count)
  assert plan["swap"] == swap and (plan["cluster"] > 1) == split
  x = _X(m, k, seed=7 * m + k)
  w, s = _W(n, k, seed=n + 1)
  y = _CheckOnCard(x, w, s)
  yb = int8_matmul.Int8Matmul(x.cuda().bfloat16(), w.cuda(), s.cuda())
  x8, x_scale = int8_matmul.QuantizeActivations(x.cuda().bfloat16())
  assert torch.equal(yb, int8_matmul._PlainGemm(
      x8, x_scale, w.cuda(), s.cuda()).bfloat16())
  assert y.shape == (m, n)


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, dtype", [
    (2048, 8192, torch.float32), (264, 8192, torch.bfloat16),
    (300, 37, torch.float32), (9, 100, torch.bfloat16),
    (3, 60000, torch.float32)])
def test_quantize_plans_on_card(cuda, m, k, dtype):
  """Kernel (a) where a block holds only some of its rows (read twice),
  where a row is not a multiple of 16 bytes (no bulk copies), and where
  one row outgrows a block's shared memory: bitwise the plain version."""
  x = _X(m, k, seed=m, scale=5.0).to(dtype).cuda()
  x8, x_scale = int8_matmul.QuantizeActivations(x)
  px8, px_scale = int8_matmul._PlainQuantize(x)
  torch.cuda.synchronize()
  assert torch.equal(x_scale, px_scale) and torch.equal(x8, px8)


@pytest.mark.cuda
def test_kernels_at_the_logits_shape(cuda):
  x = _X(264, 2048, seed=3)
  w, s = _W(32000, 2048, seed=4)
  _CheckOnCard(x, w, s)
  _CheckOnCard(x[:8], w, s)


@pytest.mark.cuda
def test_kernels_round_half_to_even_on_card(cuda):
  x = torch.tensor([[127.0, 2.5, 3.5, -2.5, -0.5, 0.5, 1.5, 0.0] * 4,
                    [-127.0, 126.5, -126.5, 64.0, 0.49, 0.51, 5.0, 7.0] * 4])
  w, s = _W(24, 32)
  _CheckOnCard(x, w, s)
  x8, x_scale = int8_matmul.QuantizeActivations(x.cuda())
  assert x_scale.item() == 1.0
  assert x8[0, :8].tolist() == [127, 2, 4, -2, 0, 0, 2, 0]
  _CheckOnCard(torch.zeros(3, 48), *_W(5, 48))


@pytest.mark.cuda
@pytest.mark.parametrize("amax", [127.0, 3.0, 1e-7])
def test_quantize_next_to_half_integers_on_card(cuda, amax):
  """Values whose quotient by the scale lies within a few ulps of a
  half-integer, where kernel (a)'s reciprocal product hands the rounding
  to the true division: bitwise the plain version."""
  scale = np.float32(max(np.float32(amax) * np.float32(1 / 127), 1e-8))
  half = (np.arange(-127, 127, dtype=np.float32) + np.float32(0.5))
  quot = [np.nextafter(half, np.float32(d * np.inf)) if d else half
          for d in (-1, 0, 1)]
  quot += [half + np.float32(e) for e in (-3e-5, 3e-5, -7e-5, 7e-5)]
  x = np.concatenate([np.float32(amax) * np.ones(16, np.float32)] +
                     [(q * scale).astype(np.float32) for q in quot])
  x = x[:x.size // 16 * 16].reshape(-1, 16)
  xc = torch.tensor(x).cuda()
  x8, x_scale = int8_matmul.QuantizeActivations(xc)
  px8, px_scale = int8_matmul._PlainQuantize(xc)
  torch.cuda.synchronize()
  assert torch.equal(x_scale, px_scale) and torch.equal(x8, px8)


@pytest.mark.cuda
def test_two_calls_are_bitwise_equal_on_card(cuda):
  x = _X(264, 8192, seed=9).cuda()
  w, s = (t.cuda() for t in _W(2048, 8192))
  a = int8_matmul.Int8Matmul(x, w, s)
  b = int8_matmul.Int8Matmul(x, w, s)
  assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("layout, contract_ndim, shape", [
    ("dv", 1, (72, 4, 25)), ("vd", 2, (100, 4, 18)), ("vd", 1, (100, 72)),
    ("dv", 1, (64, 128))])
def test_int8_weight_einsum_on_card_matches_cpu(cuda, layout, contract_ndim,
                                                shape):
  rng = np.random.RandomState(5)
  w = torch.tensor(rng.randn(*shape).astype(np.float32))
  w8 = quant_utils.Int8Weight.Quantize(w, layout, contract_ndim)
  in_dims = (shape[:contract_ndim] if layout == "dv"
             else shape[len(shape) - contract_ndim:])
  for m in (1, 8, 17):
    x = torch.tensor(rng.randn(2, m, *in_dims).astype(np.float32))
    want = w8.Einsum(x)
    w8c = quant_utils.Int8Weight(w8.w_int8.cuda(), w8.scale.cuda(), layout,
                                 contract_ndim)
    assert torch.equal(w8c.Einsum(x.cuda()).cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n", [(8, 2048, 2048), (264, 2048, 8192),
                                     (17, 100, 136), (1, 64, 8)])
def test_bf16_kernels_on_card(cuda, m, k, n):
  """The bfloat16 instantiations (x widened on load; y rounded to
  bfloat16 after the epilogue): kernel (a) bitwise its float32 run on the
  widened x, kernel (b) bitwise its float32 run rounded, both bitwise the
  plain versions and counted by dtype; K = 100 takes the scalar loads."""
  x = _X(m, k, seed=m + k).bfloat16()
  w, s = _W(n, k, seed=n)
  xc, wc, sc = x.cuda(), w.cuda(), s.cuda()
  by_q = dict(int8_matmul.QuantizeActivations.launches_by_dtype)
  by_g = dict(int8_matmul.Int8Gemm.launches_by_dtype)
  x8, x_scale = int8_matmul.QuantizeActivations(xc)
  y = int8_matmul.Int8Gemm(x8, x_scale, wc, sc, out_dtype=torch.bfloat16)
  f8, f_scale = int8_matmul.QuantizeActivations(xc.float())
  yf = int8_matmul.Int8Gemm(f8, f_scale, wc, sc)
  both = int8_matmul.Int8Matmul(xc, wc, sc)
  torch.cuda.synchronize()
  assert int8_matmul.QuantizeActivations.launches_by_dtype["bfloat16"] == (
      by_q["bfloat16"] + 2)
  assert int8_matmul.Int8Gemm.launches_by_dtype["bfloat16"] == (
      by_g["bfloat16"] + 2)
  assert torch.equal(x8, f8) and torch.equal(x_scale, f_scale)
  assert y.dtype == both.dtype == torch.bfloat16
  assert torch.equal(y, yf.bfloat16())
  assert torch.equal(both, y)
  assert torch.equal(y.cpu(), int8_matmul.Int8Matmul(x, w, s))
