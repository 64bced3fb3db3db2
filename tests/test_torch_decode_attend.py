"""lingvo_tpu_torch/ops/flash_decode.py and ops/block_decode.py against the JAX reference.

The port's plain `FlashDecode` and `BlockDecode` (the CPU path and the
CUDA kernels' yardsticks) must compute what the reference computes when
it runs its Pallas kernels in interpret mode (`lowering='pallas',
interpret=True`), at B 3, page 4, N 2, H 16: a row whose live slots are
all padded, left-pad paddings, a time_step inside a page, an inactive
(seq_len 0) row, table entries past a row's live pages that alias other
rows' pages, and a stale tail page (finite garbage past the live slots
that the reference masks). `BlockPrefill` and `GatherPages` are held to
the reference's XLA functions. Tolerance: float32, atol 2e-5 (the two
frameworks sum the page dot products in other orders). Rows with nothing
live must come out exactly 0, and NaN in slots or pages the read must
skip must not reach the output.

The flash-decode kernel splits each row's live tiles over several blocks;
the host's split count (`NumSplits`) is checked here on the CPU: at least
one split, never more than the tiles up to time_step.

The CUDA kernels run only on a card: their cases (marked `cuda`, atol
2e-5 against the plain version) skip here and say so. The module imports
JAX only inside the reference helpers, so on a machine with a card and no
JAX the kernel cases run alone:

    python -m pytest tests/test_torch_decode_attend.py -m cuda
"""

import numpy as np
import pytest
import torch

from lingvo_tpu_torch.ops import block_decode
from lingvo_tpu_torch.ops import flash_decode

ATOL = 2e-5
B, P, N, H = 3, 4, 2, 16


def _Jnp():
  import jax.numpy as jnp
  return jnp


def _Cache(s=16, seed=0, b=B, n=N, h=H):
  rng = np.random.RandomState(seed)
  q = (rng.randn(b, 1, n, h) / np.sqrt(h)).astype(np.float32)
  k = rng.randn(b, s, n, h).astype(np.float32)
  v = rng.randn(b, s, n, h).astype(np.float32)
  pad = np.zeros((b, s), np.float32)
  pad[1, :3] = 1.0            # a right-aligned prompt's left pad
  pad[2, :] = 1.0             # a row with nothing live: exact 0
  return q, k, v, pad


def _JaxFlash(q, k, v, t, pad):
  from lingvo_tpu.ops import flash_decode as jax_fd
  jnp = _Jnp()
  return np.asarray(jax_fd.FlashDecode(
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(t, jnp.int32),
      page_size=P, cache_paddings=None if pad is None else jnp.asarray(pad),
      lowering="pallas", interpret=True))


def _PortFlash(q, k, v, t, pad):
  t_ = torch.as_tensor
  return flash_decode.FlashDecode(
      t_(q), t_(k), t_(v), t, page_size=P,
      cache_paddings=None if pad is None else t_(pad)).numpy()


class TestFlashDecodeMatchesJax:

  @pytest.mark.parametrize("t", [0, 6, 15])
  def test_matches_interpreted_pallas_kernel(self, t):
    q, k, v, pad = _Cache()
    ref = _JaxFlash(q, k, v, t, pad)
    launches = flash_decode.FlashDecode.launches
    out = _PortFlash(q, k, v, t, pad)
    assert flash_decode.FlashDecode.launches == launches  # CPU: no kernel
    np.testing.assert_allclose(out, ref, atol=ATOL)
    np.testing.assert_array_equal(out[2], np.zeros_like(out[2]))

  def test_no_paddings(self):
    q, k, v, _ = _Cache(seed=1)
    np.testing.assert_allclose(_PortFlash(q, k, v, 9, None),
                               _JaxFlash(q, k, v, 9, None), atol=ATOL)

  def test_slots_past_time_step_never_read(self):
    """NaN in the live page's tail (slots > t) and in every page past t
    leave the output unchanged, bitwise."""
    q, k, v, pad = _Cache()
    clean = _PortFlash(q, k, v, 5, pad)
    kp, vp = k.copy(), v.copy()
    kp[:, 6:] = np.nan
    vp[:, 6:] = np.nan
    np.testing.assert_array_equal(_PortFlash(q, kp, vp, 5, pad), clean)

  def test_shape_contract(self):
    q, k, v, _ = _Cache()
    t_ = torch.as_tensor
    with pytest.raises(ValueError, match="multiple of page_size"):
      flash_decode.FlashDecode(t_(q), t_(k[:, :15]), t_(v[:, :15]), 3,
                               page_size=P)
    with pytest.raises(ValueError, match=r"\[B, 1, N, H\]"):
      flash_decode.FlashDecode(t_(q[:, 0]), t_(k), t_(v), 3, page_size=P)
    assert flash_decode.SupportedShape(16, 4)
    assert not flash_decode.SupportedShape(15, 4)
    assert not flash_decode.SupportedShape(16, 0)


class TestFlashDecodeSplitPlan:

  @pytest.mark.parametrize("rows, t, s, h", [
      (128, 1151, 1152, 128), (128, 700, 1152, 128), (128, 0, 1152, 128),
      (6, 29, 32, 4), (1, 5000, 4096, 16), (128, -1, 1152, 128)])
  def test_split_count(self, rows, t, s, h):
    splits = flash_decode.NumSplits(rows, t, s, h, sm_count=132,
                                    blocks_per_sm=4)
    t_eff = min(t, s - 1)
    tiles = max(t_eff, 0) // flash_decode.TileSlots(h) + 1
    assert 1 <= splits <= tiles
    if (rows, t) == (128, 1151):
      assert splits == 9    # two waves of 4 x 132 resident blocks


def _Pool(seed=0, b=B, t_pages=4, n=N, h=H):
  """A pool of b * t_pages + 1 pages, disjoint tables, seq_lens with an
  inactive row; entries past each row's live pages alias other rows'."""
  rng = np.random.RandomState(seed)
  np_total = b * t_pages + 1
  k_pool = rng.randn(np_total, P, n, h).astype(np.float32)
  v_pool = rng.randn(np_total, P, n, h).astype(np.float32)
  tables = rng.permutation(np_total - 1).reshape(b, t_pages).astype(np.int32)
  lens = np.array([6, 0, 13], np.int32)[:b]
  hostile = tables.copy()
  hostile[0, 2:] = tables[2, :2]       # row 0 reads 2 pages
  hostile[1, :] = tables[0]            # row 1 is inactive
  q = (rng.randn(b, 1, n, h) / np.sqrt(h)).astype(np.float32)
  return q, k_pool, v_pool, hostile, lens


def _JaxBlock(q, k_pool, v_pool, tables, lens):
  from lingvo_tpu.ops import block_decode as jax_bd
  jnp = _Jnp()
  return np.asarray(jax_bd.BlockDecode(
      jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
      jnp.asarray(tables), jnp.asarray(lens), page_size=P,
      lowering="pallas", interpret=True))


def _PortBlock(q, k_pool, v_pool, tables, lens):
  t_ = torch.as_tensor
  return block_decode.BlockDecode(t_(q), t_(k_pool), t_(v_pool), t_(tables),
                                  t_(lens), page_size=P).numpy()


class TestBlockDecodeMatchesJax:

  @pytest.mark.parametrize("seed", [0, 1])
  def test_matches_interpreted_pallas_kernel(self, seed):
    x = _Pool(seed)
    ref = _JaxBlock(*x)
    launches = block_decode.BlockDecode.launches
    out = _PortBlock(*x)
    assert block_decode.BlockDecode.launches == launches  # CPU: no kernel
    np.testing.assert_allclose(out, ref, atol=ATOL)
    np.testing.assert_array_equal(out[1], np.zeros_like(out[1]))

  def test_dead_pages_and_slots_never_read(self):
    """NaN in every page no row reads live, and in each row's stale tail
    slots, leaves the output unchanged, bitwise."""
    q, k_pool, v_pool, tables, lens = _Pool()
    clean = _PortBlock(q, k_pool, v_pool, tables, lens)
    kp, vp = k_pool.copy(), v_pool.copy()
    live = {int(tables[0, 0]), int(tables[0, 1])} | {
        int(x) for x in tables[2]}
    dead = [i for i in range(kp.shape[0]) if i not in live]
    for pool in (kp, vp):
      pool[dead] = np.nan
      pool[tables[0, 1], 2:] = np.nan   # row 0: slots 6, 7 of its page 1
      pool[tables[2, 3], 1:] = np.nan   # row 2: slots 13..15
    np.testing.assert_array_equal(_PortBlock(q, kp, vp, tables, lens), clean)

  def test_int8_pools_raise(self):
    q, k_pool, v_pool, tables, lens = (torch.as_tensor(a) for a in _Pool())
    scale = torch.ones((k_pool.shape[0], N, P))
    with pytest.raises(NotImplementedError, match="ROADMAP item 2"):
      block_decode.BlockDecode(q, k_pool, v_pool, tables, lens, page_size=P,
                               k_scale=scale, v_scale=scale)
    with pytest.raises(NotImplementedError, match="ROADMAP item 2"):
      block_decode.BlockPrefill(q, k_pool.to(torch.int8),
                                v_pool.to(torch.int8), tables, lens, lens,
                                page_size=P)


class TestPrefillAndGather:

  def test_block_prefill_matches_reference(self):
    from lingvo_tpu.ops import block_decode as jax_bd
    jnp = _Jnp()
    _, k_pool, v_pool, tables, _ = _Pool(seed=2)
    rng = np.random.RandomState(3)
    c = 5
    q = (rng.randn(B, c, N, H) / 4).astype(np.float32)
    q_pos = np.array([3, 0, 9], np.int32)    # mid-prompt, fresh, decode row
    in_len = np.array([5, 2, 1], np.int32)
    ref = np.asarray(jax_bd.BlockPrefill(
        *(jnp.asarray(a) for a in (q, k_pool, v_pool, tables, q_pos,
                                   in_len)), page_size=P))
    t_ = torch.as_tensor
    out = block_decode.BlockPrefill(
        *(t_(a) for a in (q, k_pool, v_pool, tables, q_pos, in_len)),
        page_size=P).numpy()
    valid = np.arange(c)[None] < in_len[:, None]
    np.testing.assert_allclose(out[valid], ref[valid], atol=ATOL)
    np.testing.assert_array_equal(out[~valid], np.zeros_like(out[~valid]))

  def test_gather_pages_matches_reference(self):
    from lingvo_tpu.ops import block_decode as jax_bd
    _, k_pool, _, tables, _ = _Pool(seed=4)
    tables = tables.copy()
    tables[0, 3] = 99                       # out of range: clamps
    ref = np.asarray(jax_bd.GatherPages(_Jnp().asarray(k_pool),
                                        _Jnp().asarray(tables)))
    out = block_decode.GatherPages(torch.as_tensor(k_pool),
                                   torch.as_tensor(tables)).numpy()
    np.testing.assert_array_equal(out, ref)


def _PortFlash_(q, k, v, t, pad, page):
  t_ = torch.as_tensor
  return flash_decode.FlashDecode(t_(q), t_(k), t_(v), t, page_size=page,
                                  cache_paddings=t_(pad)).numpy()


def _CardFlash(q, k, v, t, pad, page):
  """The kernel on the card: exactly one launch counted."""
  t_ = lambda a: torch.as_tensor(a).cuda()
  launches = flash_decode.FlashDecode.launches
  got = flash_decode.FlashDecode(t_(q), t_(k), t_(v), t, page_size=page,
                                 cache_paddings=t_(pad))
  torch.cuda.synchronize()
  assert flash_decode.FlashDecode.launches == launches + 1
  return got.cpu().numpy()


def _NeedCard():
  if not torch.cuda.is_available():
    pytest.skip("no CUDA device here: the CUDA kernel is unverified on this "
                "machine (chip_smoke.py checks it on the H100)")


@pytest.mark.cuda
class TestCudaKernels:
  """The kernels against their plain versions on the card, atol 2e-5."""

  @pytest.mark.parametrize("h, page", [(16, 4), (64, 16), (128, 128)])
  def test_flash_decode_kernel_matches_plain(self, h, page):
    _NeedCard()
    s = 4 * page
    q, k, v, pad = _Cache(s=s, seed=5, h=h)
    t_ = lambda a: torch.as_tensor(a).cuda()
    for t in (0, page + 1, s - 1):
      want = flash_decode.FlashDecode(
          *(torch.as_tensor(a) for a in (q, k, v)), t, page_size=page,
          cache_paddings=torch.as_tensor(pad)).numpy()
      launches = flash_decode.FlashDecode.launches
      got = flash_decode.FlashDecode(t_(q), t_(k), t_(v), t, page_size=page,
                                     cache_paddings=t_(pad))
      torch.cuda.synchronize()
      assert flash_decode.FlashDecode.launches == launches + 1
      np.testing.assert_allclose(got.cpu().numpy(), want, atol=ATOL)
      assert (got[2] == 0).all()

  @pytest.mark.parametrize("h", flash_decode.HEAD_DIMS)
  @pytest.mark.parametrize("at", ["0", "P-1", "P", "S-1"])
  def test_flash_decode_time_steps_and_head_dims(self, h, at):
    """t = 0, P - 1, P and S - 1 at every head dim, page 16, S = 80: a
    row with nothing padded, a left-padded row, a wholly padded row (exact
    0) and a row whose only live slot is t // 2; padded and past-t slots
    hold NaN."""
    _NeedCard()
    page, s = 16, 80
    t = {"0": 0, "P-1": page - 1, "P": page, "S-1": s - 1}[at]
    q, k, v, _ = _Cache(s=s, seed=7, b=4, h=h)
    pad = np.zeros((4, s), np.float32)
    pad[1, :5] = 1.0
    pad[2, :] = 1.0
    pad[3, :] = 1.0
    pad[3, t // 2] = 0.0
    dead = (pad > 0.5) | (np.arange(s)[None] > t)
    k[dead], v[dead] = np.nan, np.nan
    want = _PortFlash_(q, k, v, t, pad, page)
    got = _CardFlash(q, k, v, t, pad, page)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got[2], np.zeros_like(got[2]))

  @pytest.mark.parametrize("splits", [3, 5])
  def test_flash_decode_splits_that_do_not_divide_the_tiles(
      self, splits, monkeypatch):
    """7 tiles of 16 slots (h 128) over 3 splits (shares of 2, 2, 3) and
    5 (a left-padded row with 2 live tiles leaves 3 splits empty)."""
    _NeedCard()
    page, s, t = 16, 112, 111
    q, k, v, pad = _Cache(s=s, seed=8, h=128)
    pad[1, :80] = 1.0
    monkeypatch.setattr(flash_decode, "NumSplits", lambda *a: splits)
    want = _PortFlash_(q, k, v, t, pad, page)
    got = _CardFlash(q, k, v, t, pad, page)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got[2], np.zeros_like(got[2]))

  def test_flash_decode_bitwise_repeat(self):
    """Two calls give the same bits: the splits merge in split order."""
    _NeedCard()
    q, k, v, pad = _Cache(s=1152, seed=9, b=4, n=16, h=128)
    first = _CardFlash(q, k, v, 1000, pad, 128)
    np.testing.assert_array_equal(_CardFlash(q, k, v, 1000, pad, 128), first)

  @pytest.mark.parametrize("h", [16, 64, 128])
  def test_block_decode_kernel_matches_plain(self, h):
    _NeedCard()
    x = _Pool(seed=6, h=h)
    want = _PortBlock(*x)
    launches = block_decode.BlockDecode.launches
    got = block_decode.BlockDecode(
        *(torch.as_tensor(a).cuda() for a in x[:5]), page_size=P)
    torch.cuda.synchronize()
    assert block_decode.BlockDecode.launches == launches + 1
    np.testing.assert_allclose(got.cpu().numpy(), want, atol=ATOL)
    assert (got[1] == 0).all()
