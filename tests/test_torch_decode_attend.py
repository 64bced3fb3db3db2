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

Quantized storage, against the same reference functions: `FlashDecode`
on a bfloat16 cache, `BlockDecode` and `BlockPrefill` on int8 pools with
their [NP, N, P] scale sidecars and on bfloat16 pools (atol 2e-5; p is
rounded to bfloat16 before P.V on both sides). The int8 ops equal the
float ops on the pre-dequantized pool bit for bit, and NaN in dead
slots' scales never reaches the output.

The flash-decode kernel splits each row's live tiles over several blocks;
the host's split count (`NumSplits`) is checked here on the CPU: at least
one split, never more than the tiles up to time_step.

The CUDA kernels run only on a card: their cases (marked `cuda`, atol
2e-5 against the plain version; on bfloat16 storage 1e-5 on dyadic q and
K, `_Dyadic`, where q.k is exact in any summation order, so kernel and
plain version round the same probabilities to bfloat16, while the
float32 kernel on the widened storage, which rounds none, must miss that
bar) skip here and say so. The module imports
JAX only inside the reference helpers, so on a machine with a card and no
JAX the kernel cases run alone:

    python -m pytest tests/test_torch_decode_attend.py -m cuda

The bfloat16-q instantiations (fprop_dtype=bfloat16) must equal the
float32-q kernels on the widened q, rounded, bit for bit, and lie within
one bfloat16 ulp of the plain versions.
"""

import numpy as np
import pytest
import torch

from lingvo_tpu_torch.ops import block_decode
from lingvo_tpu_torch.ops import flash_decode
from lingvo_tpu_torch.ops import ragged_block_attend as rba
from lingvo_tpu_torch.quant import kv as kv_quant

ATOL = 2e-5
B, P, N, H = 3, 4, 2, 16


def _Dyadic(x, step):
  """x rounded to a multiple of the power of two `step`: few enough
  significant bits that a dot product of such values is exact in float32
  in any summation order."""
  return (np.round(x / step) * step).astype(np.float32)


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


def _JaxFlash(q, k, v, t, pad, bf16=False):
  """The reference's interpreted Pallas kernel; bf16 rounds the cache to
  bfloat16 first."""
  from lingvo_tpu.ops import flash_decode as jax_fd
  jnp = _Jnp()
  k, v = jnp.asarray(k), jnp.asarray(v)
  if bf16:
    k, v = k.astype(jnp.bfloat16), v.astype(jnp.bfloat16)
  return np.asarray(jax_fd.FlashDecode(
      jnp.asarray(q), k, v, jnp.asarray(t, jnp.int32),
      page_size=P, cache_paddings=None if pad is None else jnp.asarray(pad),
      lowering="pallas", interpret=True))


def _PortFlash(q, k, v, t, pad, bf16=False):
  t_ = torch.as_tensor
  k, v = t_(k), t_(v)
  if bf16:
    k, v = k.bfloat16(), v.bfloat16()
  return flash_decode.FlashDecode(
      t_(q), k, v, t, page_size=P,
      cache_paddings=None if pad is None else t_(pad)).numpy()


def _Quantize(pool):
  """An int8 pool [NP, P, N, H] and its sidecar [NP, N, P], quantized per
  (slot, head) as the serving step writes them."""
  q8, scale = kv_quant.QuantizeKv(torch.as_tensor(pool))
  return q8.numpy(), np.ascontiguousarray(scale.numpy().transpose(0, 2, 1))


def _Dequantize(q8, scale):
  return rba._DequantPages(torch.as_tensor(q8),
                           torch.as_tensor(scale)).numpy()


def _Storage(k_pool, v_pool, dtype):
  """(k_pool, v_pool, scales) of float32 pools stored as `dtype`; scales
  is (k_scale, v_scale) for int8, else ()."""
  if dtype == "int8":
    (k8, ks), (v8, vs) = _Quantize(k_pool), _Quantize(v_pool)
    return k8, v8, (ks, vs)
  return k_pool, v_pool, ()


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

  @pytest.mark.parametrize("t", [0, 6, 15])
  def test_bf16_cache_matches_interpreted_pallas_kernel(self, t):
    q, k, v, pad = _Cache(seed=2)
    ref = _JaxFlash(q, k, v, t, pad, bf16=True)
    out = _PortFlash(q, k, v, t, pad, bf16=True)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    np.testing.assert_array_equal(out[2], np.zeros_like(out[2]))

  def test_bf16_slots_past_time_step_never_read(self):
    q, k, v, pad = _Cache(seed=3)
    clean = _PortFlash(q, k, v, 5, pad, bf16=True)
    kp, vp = k.copy(), v.copy()
    kp[:, 6:] = np.nan
    vp[:, 6:] = np.nan
    kp[1, :3] = np.nan     # the left pad
    np.testing.assert_array_equal(_PortFlash(q, kp, vp, 5, pad, bf16=True),
                                  clean)

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


  @pytest.mark.parametrize("rows, t, s, h", [
      (128, 1151, 1152, 128), (128, 700, 1152, 128), (128, 0, 1152, 128),
      (6, 29, 32, 8), (1, 5000, 4096, 16), (128, -1, 1152, 128),
      (2, 1151, 1152, 128)])
  def test_bf16_split_cap(self, rows, t, s, h):
    """A bfloat16 cache's splits form one cluster: at least 1, at most 8
    (the portable cluster size), never more than the tiles up to t."""
    splits = flash_decode.NumSplitsBf16(rows, t, s, h, sm_count=132,
                                        blocks_per_sm=8)
    tiles = max(min(t, s - 1), 0) // flash_decode.TileSlots(h, 2) + 1
    assert 1 <= splits <= min(flash_decode.MAX_CLUSTER, tiles)
    if (rows, t) == (128, 1151):
      assert splits == 8    # the float32 rule's 17, capped

  def test_bf16_scores_fit_the_blocks(self):
    """GShardDecode's shapes (S = 1152, H = 128, 8 splits) keep 160 slots
    of scores per block; the wrapper's limit is MAX_CTA_SLOTS."""
    assert flash_decode.CtaSlots(1152, 128, 1151, 8) == 160
    assert flash_decode.CtaSlots(1152, 128, -1, 8) == 0
    assert flash_decode.CtaSlots(1152, 128, 0, 1) == 32
    assert flash_decode.CtaSlots(
        8 * flash_decode.MAX_CTA_SLOTS, 128,
        8 * flash_decode.MAX_CTA_SLOTS - 1, 8) == flash_decode.MAX_CTA_SLOTS


def _ClusterPageMax(scores, lo, t_eff, page, ts, splits):
  """A plain model of the bfloat16 kernel's cluster rule (flash_decode.cu,
  FlashDecodeBf16Kernel): the rounding max M of every slot a block holds,
  from the blocks' published (total, first-page max, first page) triples
  alone. scores: [S] float32, NEG_INF where masked. Returns M [S] (NaN
  for the slots no block holds) and the triples."""
  neg = np.float32(rba.NEG_INF)
  m = np.full(scores.shape, np.nan, np.float32)
  if lo > t_eff:
    return m, []
  first, nt = lo // ts, t_eff // ts - lo // ts + 1
  held = []   # (first slot, scores held) per block, in split order
  for split in range(splits):
    b0 = first + split * nt // splits
    b1 = first + (split + 1) * nt // splits
    x = np.full((b1 - b0) * ts, neg, np.float32)
    live = scores[b0 * ts:min(b1 * ts, t_eff + 1)]
    x[:live.size] = live
    held.append((b0 * ts, x))
  triples = []
  for start, x in held:
    if x.size == 0:
      triples.append((neg, neg, -1))
      continue
    first_end = min(x.size, (start // page + 1) * page - start)
    triples.append((x.max(), x[:first_end].max(), start // page))
  for c, (start, x) in enumerate(held):
    if x.size == 0:
      continue
    before = max([t[0] for t in triples[:c]], default=neg)
    last_page = (start + x.size - 1) // page
    tail = max([t[1] for t in triples[c + 1:] if t[2] == last_page],
               default=neg)
    run = np.maximum.accumulate(x)
    for i in range(x.size):
      pg = (start + i) // page
      mj = max(before, run[min(x.size, (pg + 1) * page - start) - 1])
      if pg == last_page:
        mj = max(mj, tail)
      m[start + i] = mj
  return m, triples


def _ReferencePageMax(scores, t_eff, page):
  """The running max through the end of each slot's page, in the
  reference's page loop (`m_new = max(m, max(s_page))`)."""
  m = np.full(scores.shape, np.nan, np.float32)
  run = np.float32(rba.NEG_INF)
  for start in range(0, t_eff + 1, page):
    run = max(run, scores[start:min(start + page, t_eff + 1)].max())
    m[start:start + page] = run
  return m


def _ClusterDecode(q, k, v, t, pad, page, splits):
  """[B, N, H]: the kernel's arithmetic on the CPU from the model's M:
  acc = sum bf16(exp(s - M_safe)) exp(M - m) v, l the same unrounded,
  out = acc / max(l, 1e-20), with the row's max m."""
  b, s_len, n, h = k.shape
  t_eff = min(t, s_len - 1)
  ts = flash_decode.TileSlots(h, 2)
  neg = np.float32(rba.NEG_INF)
  kf = torch.as_tensor(k).bfloat16().float().numpy()
  vf = torch.as_tensor(v).bfloat16().float().numpy()
  out = np.zeros((b, n, h), np.float32)
  for bi in range(b):
    keep = (np.arange(s_len) <= t_eff) & (pad[bi] < 0.5)
    live = np.nonzero(keep)[0]
    lo = int(live[0]) if live.size else t_eff + 1
    for ni in range(n):
      sc = np.where(keep, np.einsum("sh,h->s", kf[bi, :, ni], q[bi, 0, ni]),
                    neg).astype(np.float32)
      mm, triples = _ClusterPageMax(sc, lo, t_eff, page, ts, splits)
      if not triples:
        continue
      row_max = max(tr[0] for tr in triples)
      held = ~np.isnan(mm)
      msafe = np.where(mm <= neg * 0.5, 0.0, mm).astype(np.float32)
      p = torch.exp(torch.as_tensor(np.where(held, sc - msafe, neg)))
      e = torch.exp(torch.as_tensor(np.where(held, mm - row_max, 0.0)))
      w = p.bfloat16().float() * e
      acc = (w[:, None] * torch.as_tensor(vf[bi, :, ni])).sum(0)
      out[bi, ni] = (acc / torch.clamp((p * e).sum(), min=1e-20)).numpy()
  return out


class TestBf16ClusterPageMaxima:
  """The bfloat16 kernel's cluster rule on the CPU: each block knows only
  its own scores and its neighbours' (total, first-page max, first page),
  and must still round every p against the reference's running max
  through the end of its page. S 768 in 32-slot tiles (H 128), splits
  1..8, pages 4 (many pages per block), 16, 48 (pages cut tiles) and 128
  (a page across several blocks); a right-aligned prompt that leaves
  blocks empty, a row with nothing live and a row whose one live slot is
  t // 2."""

  S, T = 768, 700

  def _Inputs(self):
    rng = np.random.RandomState(21)
    b, n, h = 4, 2, 128
    q = _Dyadic(rng.randn(b, 1, n, h) / np.sqrt(h), 1 / 64)
    k = _Dyadic(rng.randn(b, self.S, n, h), 1 / 8)
    v = rng.randn(b, self.S, n, h).astype(np.float32)
    pad = np.zeros((b, self.S), np.float32)
    pad[1, :650] = 1.0      # 51 live slots: blocks left empty
    pad[2, :] = 1.0         # nothing live: exact 0
    pad[3, :] = 1.0
    pad[3, self.T // 2] = 0.0
    return q, k, v, pad

  @pytest.mark.parametrize("page", [4, 16, 48, 128])
  @pytest.mark.parametrize("splits", range(1, 9))
  def test_model_rounds_at_the_reference_max(self, splits, page):
    q, k, v, pad = self._Inputs()
    b, s_len, n, h = k.shape
    ts = flash_decode.TileSlots(h, 2)
    kf = torch.as_tensor(k).bfloat16().float().numpy()
    neg = np.float32(rba.NEG_INF)
    for bi in range(b):
      keep = (np.arange(s_len) <= self.T) & (pad[bi] < 0.5)
      live = np.nonzero(keep)[0]
      lo = int(live[0]) if live.size else self.T + 1
      for ni in range(n):
        sc = np.where(keep, np.einsum("sh,h->s", kf[bi, :, ni],
                                      q[bi, 0, ni]), neg).astype(np.float32)
        got, _ = _ClusterPageMax(sc, lo, self.T, page, ts, splits)
        want = _ReferencePageMax(sc, self.T, page)
        held = ~np.isnan(got)
        # every live slot is held, and its M is the reference's, bitwise
        assert held[live].all()
        np.testing.assert_array_equal(got[held], want[held])
    out = _ClusterDecode(q, k, v, self.T, pad, page, splits)
    t_ = torch.as_tensor
    plain = flash_decode._PlainDecode(
        t_(q)[:, 0], t_(k).bfloat16(), t_(v).bfloat16(), self.T, page,
        t_(pad)).numpy()
    np.testing.assert_allclose(out, plain, atol=1e-5)
    np.testing.assert_allclose(out, _JaxPage(page), atol=1e-5)
    np.testing.assert_array_equal(out[2], np.zeros_like(out[2]))


_JAX_PAGE = {}


def _JaxPage(page):
  """The interpreted Pallas kernel on TestBf16ClusterPageMaxima's inputs
  (a bfloat16 cache) at `page`, once per page."""
  if page not in _JAX_PAGE:
    from lingvo_tpu.ops import flash_decode as jax_fd
    jnp = _Jnp()
    q, k, v, pad = TestBf16ClusterPageMaxima()._Inputs()
    _JAX_PAGE[page] = np.asarray(jax_fd.FlashDecode(
        jnp.asarray(q), jnp.asarray(k).astype(jnp.bfloat16),
        jnp.asarray(v).astype(jnp.bfloat16),
        jnp.asarray(TestBf16ClusterPageMaxima.T, jnp.int32), page_size=page,
        cache_paddings=jnp.asarray(pad), lowering="pallas",
        interpret=True))[:, 0]
  return _JAX_PAGE[page]


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


def _JaxBlock(q, k_pool, v_pool, tables, lens, scales=(), bf16=False):
  """The reference's interpreted Pallas kernel; scales = (k_scale,
  v_scale) of int8 pools, bf16 rounds float32 pools to bfloat16 first."""
  from lingvo_tpu.ops import block_decode as jax_bd
  jnp = _Jnp()
  k, v = jnp.asarray(k_pool), jnp.asarray(v_pool)
  if bf16:
    k, v = k.astype(jnp.bfloat16), v.astype(jnp.bfloat16)
  kw = {}
  if scales:
    kw = dict(k_scale=jnp.asarray(scales[0]), v_scale=jnp.asarray(scales[1]))
  return np.asarray(jax_bd.BlockDecode(
      jnp.asarray(q), k, v, jnp.asarray(tables), jnp.asarray(lens),
      page_size=P, lowering="pallas", interpret=True, **kw))


def _PortBlock(q, k_pool, v_pool, tables, lens, scales=(), bf16=False):
  t_ = torch.as_tensor
  k, v = t_(k_pool), t_(v_pool)
  if bf16:
    k, v = k.bfloat16(), v.bfloat16()
  kw = dict(k_scale=t_(scales[0]), v_scale=t_(scales[1])) if scales else {}
  return block_decode.BlockDecode(t_(q), k, v, t_(tables), t_(lens),
                                  page_size=P, **kw).numpy()


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

  @pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
  def test_quantized_pools_match_interpreted_pallas_kernel(self, dtype):
    q, k_pool, v_pool, tables, lens = _Pool(seed=5)
    k, v, scales = _Storage(k_pool, v_pool, dtype)
    bf16 = dtype == "bfloat16"
    ref = _JaxBlock(q, k, v, tables, lens, scales, bf16)
    out = _PortBlock(q, k, v, tables, lens, scales, bf16)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    np.testing.assert_array_equal(out[1], np.zeros_like(out[1]))

  def test_int8_equals_float_on_the_dequantized_pool(self):
    q, k_pool, v_pool, tables, lens = _Pool(seed=6)
    k8, v8, (ks, vs) = _Storage(k_pool, v_pool, "int8")
    np.testing.assert_array_equal(
        _PortBlock(q, k8, v8, tables, lens, (ks, vs)),
        _PortBlock(q, _Dequantize(k8, ks), _Dequantize(v8, vs), tables,
                   lens))

  def test_int8_dead_scales_never_read(self):
    """NaN scales (and int8 extremes) in every page no row reads live and
    in each row's stale tail slots leave the output unchanged, bitwise."""
    q, k_pool, v_pool, tables, lens = _Pool()
    k8, v8, (ks, vs) = _Storage(k_pool, v_pool, "int8")
    clean = _PortBlock(q, k8, v8, tables, lens, (ks, vs))
    live = {int(tables[0, 0]), int(tables[0, 1])} | {
        int(x) for x in tables[2]}
    dead = [i for i in range(k8.shape[0]) if i not in live]
    for pool, scale in ((k8, ks), (v8, vs)):
      pool[dead] = 127
      scale[dead] = np.nan
      scale[tables[0, 1], :, 2:] = np.nan   # row 0: slots 6, 7
      scale[tables[2, 3], :, 1:] = np.nan   # row 2: slots 13..15
    np.testing.assert_array_equal(
        _PortBlock(q, k8, v8, tables, lens, (ks, vs)), clean)

  def test_int8_pools_need_their_scales(self):
    """BlockDecode and BlockPrefill take int8 pools only with both
    sidecars, and sidecars only with int8 pools."""
    q, k_pool, v_pool, tables, lens = (torch.as_tensor(a) for a in _Pool())
    scale = torch.ones((k_pool.shape[0], N, P))
    k8, v8 = k_pool.to(torch.int8), v_pool.to(torch.int8)
    with pytest.raises(ValueError, match="int8 pools take"):
      block_decode.BlockDecode(q, k_pool, v_pool, tables, lens, page_size=P,
                               k_scale=scale, v_scale=scale)
    with pytest.raises(ValueError, match="int8 pools take"):
      block_decode.BlockPrefill(q, k8, v8, tables, lens, lens, page_size=P)
    with pytest.raises(ValueError, match="together"):
      block_decode.BlockPrefill(q, k8, v8, tables, lens, lens, page_size=P,
                                v_scale=scale)


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

  @pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
  def test_quantized_block_prefill_matches_reference(self, dtype):
    """int8 pools dequantize on read, bfloat16 pools round p before P.V:
    the reference's XLA BlockPrefill within 2e-5; int8 equals the float
    prefill on the dequantized pool bitwise."""
    from lingvo_tpu.ops import block_decode as jax_bd
    jnp = _Jnp()
    _, k_pool, v_pool, tables, _ = _Pool(seed=7)
    k, v, scales = _Storage(k_pool, v_pool, dtype)
    rng = np.random.RandomState(8)
    c = 5
    q = (rng.randn(B, c, N, H) / 4).astype(np.float32)
    q_pos = np.array([3, 0, 9], np.int32)
    in_len = np.array([5, 2, 1], np.int32)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.as_tensor(k), torch.as_tensor(v)
    if dtype == "bfloat16":
      jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
      tk, tv = tk.bfloat16(), tv.bfloat16()
    j_kw, t_kw = {}, {}
    if scales:
      j_kw = dict(k_scale=jnp.asarray(scales[0]),
                  v_scale=jnp.asarray(scales[1]))
      t_kw = dict(k_scale=torch.as_tensor(scales[0]),
                  v_scale=torch.as_tensor(scales[1]))
    ref = np.asarray(jax_bd.BlockPrefill(
        jnp.asarray(q), jk, jv, *(jnp.asarray(a) for a in (tables, q_pos,
                                                           in_len)),
        page_size=P, **j_kw))
    t_ = torch.as_tensor
    out = block_decode.BlockPrefill(t_(q), tk, tv, t_(tables), t_(q_pos),
                                    t_(in_len), page_size=P, **t_kw).numpy()
    valid = np.arange(c)[None] < in_len[:, None]
    np.testing.assert_allclose(out[valid], ref[valid], atol=ATOL)
    np.testing.assert_array_equal(out[~valid], np.zeros_like(out[~valid]))
    if scales:
      flt = block_decode.BlockPrefill(
          t_(q), t_(_Dequantize(k, scales[0])), t_(_Dequantize(v, scales[1])),
          t_(tables), t_(q_pos), t_(in_len), page_size=P).numpy()
      np.testing.assert_array_equal(out, flt)

  def test_gather_scales_matches_reference(self):
    from lingvo_tpu.ops import block_decode as jax_bd
    _, k_pool, _, tables, _ = _Pool(seed=9)
    _, scale = _Quantize(k_pool)
    tables = tables.copy()
    tables[1, 2] = 99                       # out of range: clamps
    ref = np.asarray(jax_bd.GatherScales(_Jnp().asarray(scale),
                                         _Jnp().asarray(tables)))
    out = block_decode.GatherScales(torch.as_tensor(scale),
                                    torch.as_tensor(tables)).numpy()
    np.testing.assert_array_equal(out, ref)

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

  @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
  @pytest.mark.parametrize("splits", [3, 5])
  def test_flash_decode_splits_that_do_not_divide_the_tiles(
      self, splits, dtype, monkeypatch):
    """7 tiles of 16 slots (h 128) over 3 splits (shares of 2, 2, 3) and
    5 (a left-padded row with 2 live tiles leaves 3 splits empty). A
    bfloat16 cache (4 tiles of 32 slots, dyadic q and K) must stay within
    1e-5: each split takes the running max of the scores before its first
    tile, so it rounds p where one pass over the row would."""
    _NeedCard()
    page, s, t = 16, 112, 111
    q, k, v, pad = _Cache(s=s, seed=8, h=128)
    pad[1, :80] = 1.0
    monkeypatch.setattr(flash_decode, "NumSplits", lambda *a: splits)
    if dtype == "float32":
      want = _PortFlash_(q, k, v, t, pad, page)
      got = _CardFlash(q, k, v, t, pad, page)
      np.testing.assert_allclose(got, want, atol=ATOL)
      np.testing.assert_array_equal(got[2], np.zeros_like(got[2]))
      return
    q, k = _Dyadic(q, 1 / 64), _Dyadic(k, 1 / 8)
    t_ = lambda a: torch.as_tensor(a).cuda()
    kc, vc = t_(k).bfloat16(), t_(v).bfloat16()
    want = flash_decode._PlainDecode(t_(q)[:, 0], kc, vc, t, page, t_(pad))
    got = flash_decode.FlashDecode(t_(q), kc, vc, t, page_size=page,
                                   cache_paddings=t_(pad))
    torch.cuda.synchronize()
    assert float((got[:, 0] - want).abs().max()) <= 1e-5
    assert (got[2] == 0).all()

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

  @pytest.mark.parametrize("h, page", [(16, 16), (64, 16), (128, 16),
                                       (128, 48), (8, 16), (32, 16)])
  def test_bf16_flash_decode_kernel_matches_plain(self, h, page):
    """A bfloat16 cache with NaN in padded and past-t slots, dyadic q and
    K, t = 0, P + 1, S - 1: within 1e-5 of the plain version, which
    rounds each p against the running max through its page's end (page
    16 and 48 cut the kernel's 32-slot tiles at H 128 both ways); two
    calls bitwise equal; the float32 kernel on the widened cache misses
    the bar."""
    _NeedCard()
    s = 4 * page
    q, k, v, pad = _Cache(s=s, seed=10, h=h)
    q, k = _Dyadic(q, 1 / 64), _Dyadic(k, 1 / 8)
    t_ = lambda a: torch.as_tensor(a).cuda()
    for t in (0, page + 1, s - 1):
      dead = (pad > 0.5) | (np.arange(s)[None] > t)
      kp, vp = k.copy(), v.copy()
      kp[dead], vp[dead] = np.nan, np.nan
      kc, vc = t_(kp).bfloat16(), t_(vp).bfloat16()
      want = flash_decode._PlainDecode(t_(q)[:, 0], kc, vc, t, page,
                                       t_(pad))
      launches = flash_decode.FlashDecode.launches_by_dtype["bfloat16"]
      got = flash_decode.FlashDecode(t_(q), kc, vc, t, page_size=page,
                                     cache_paddings=t_(pad))
      again = flash_decode.FlashDecode(t_(q), kc, vc, t, page_size=page,
                                       cache_paddings=t_(pad))
      unrounded = flash_decode.FlashDecode(t_(q), kc.float(), vc.float(), t,
                                           page_size=page,
                                           cache_paddings=t_(pad))
      torch.cuda.synchronize()
      assert (flash_decode.FlashDecode.launches_by_dtype["bfloat16"]
              == launches + 2)
      assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
      assert float((got[:, 0] - want).abs().max()) <= 1e-5
      if t > 0:   # t = 0 has one live slot: p = 1 needs no rounding
        assert float((unrounded[:, 0] - want).abs().max()) > 1e-5
      assert (got[2] == 0).all()

  @pytest.mark.parametrize("page", [4, 128])
  @pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
  def test_bf16_cluster_at_forced_splits(self, splits, page, monkeypatch):
    """The one-launch bfloat16 kernel with its splits forced (one cluster
    of `splits` blocks): S 256 in 32-slot tiles (H 128), so at page 128 a
    page spans up to four blocks and at page 4 a block holds many pages; a
    left-padded row with 2 live tiles leaves blocks empty, a wholly padded
    row must be exact 0, a row has one live slot; t = 0, 100 and 255, NaN
    in every slot the read skips. Within 1e-5 of `_PlainDecode` on dyadic
    q and K, two calls bitwise equal, one counted launch per call."""
    _NeedCard()
    s = 256
    q, k, v, pad = _Cache(s=s, seed=12, b=4, h=128)
    q, k = _Dyadic(q, 1 / 64), _Dyadic(k, 1 / 8)
    pad[1, :200] = 1.0
    pad[3, :] = 1.0
    pad[3, 50] = 0.0
    monkeypatch.setattr(flash_decode, "NumSplits", lambda *a: splits)
    t_ = lambda a: torch.as_tensor(a).cuda()
    for t in (0, 100, s - 1):
      dead = (pad > 0.5) | (np.arange(s)[None] > t)
      kp, vp = k.copy(), v.copy()
      kp[dead], vp[dead] = np.nan, np.nan
      kc, vc = t_(kp).bfloat16(), t_(vp).bfloat16()
      want = flash_decode._PlainDecode(t_(q)[:, 0], kc, vc, t, page,
                                       t_(pad))
      launches = flash_decode.FlashDecode.launches_by_dtype["bfloat16"]
      got = flash_decode.FlashDecode(t_(q), kc, vc, t, page_size=page,
                                     cache_paddings=t_(pad))
      again = flash_decode.FlashDecode(t_(q), kc, vc, t, page_size=page,
                                       cache_paddings=t_(pad))
      torch.cuda.synchronize()
      assert (flash_decode.FlashDecode.launches_by_dtype["bfloat16"]
              == launches + 2)
      assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
      assert float((got[:, 0] - want).abs().max()) <= 1e-5
      assert (got[2] == 0).all()

  def test_bf16_flash_decode_refuses_scores_past_its_limit(
      self, monkeypatch):
    """One split of a 8224-slot bfloat16 cache would hold 8224 slots of
    scores in shared memory, past MAX_CTA_SLOTS: the wrapper raises
    before launching."""
    _NeedCard()
    monkeypatch.setattr(flash_decode, "NumSplits", lambda *a: 1)
    s = 8224
    q = torch.zeros(1, 1, 1, 128, device="cuda")
    kc = torch.zeros(1, s, 1, 128, device="cuda", dtype=torch.bfloat16)
    launches = flash_decode.FlashDecode.launches
    with pytest.raises(ValueError, match="slots of scores"):
      flash_decode.FlashDecode(q, kc, kc, s - 1, page_size=32)
    assert flash_decode.FlashDecode.launches == launches

  @pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
  def test_quantized_block_decode_kernel_matches_plain(self, dtype):
    """int8 (NaN dead scales) and bfloat16 pools against the plain
    version, 1e-5; int8 equals the float kernel on the dequantized pool,
    bitwise. bfloat16 runs on dyadic q and K, and the float32 kernel on
    the widened pools (p unrounded) must miss the bar."""
    _NeedCard()
    q, k_pool, v_pool, tables, lens = _Pool(seed=11, h=128)
    if dtype == "bfloat16":
      q, k_pool = _Dyadic(q, 1 / 64), _Dyadic(k_pool, 1 / 8)
    k, v, scales = _Storage(k_pool, v_pool, dtype)
    c = lambda a: torch.as_tensor(a).cuda()
    kw = {}
    if scales:
      live = {int(tables[0, 0]), int(tables[0, 1])} | {
          int(x) for x in tables[2]}
      kf, vf = _Dequantize(k, scales[0]), _Dequantize(v, scales[1])
      for scale in scales:
        scale[[i for i in range(k.shape[0]) if i not in live]] = np.nan
      kw = dict(k_scale=c(scales[0]), v_scale=c(scales[1]))
      kc, vc = c(k), c(v)
    else:
      kc, vc = c(k).bfloat16(), c(v).bfloat16()
    launches = block_decode.BlockDecode.launches_by_dtype[dtype]
    got = block_decode.BlockDecode(c(q), kc, vc, c(tables), c(lens),
                                   page_size=P, **kw)
    want = block_decode._PlainBlockDecode(c(q)[:, 0], kc, vc, c(tables),
                                          c(lens), P, **kw)
    torch.cuda.synchronize()
    assert block_decode.BlockDecode.launches_by_dtype[dtype] == launches + 1
    assert bool(torch.isfinite(got).all())
    assert float((got[:, 0] - want).abs().max()) <= 1e-5
    if not scales:
      unrounded = block_decode.BlockDecode(c(q), kc.float(), vc.float(),
                                           c(tables), c(lens), page_size=P)
      assert float((unrounded[:, 0] - want).abs().max()) > 1e-5
    if scales:
      flt = block_decode.BlockDecode(c(q), c(kf), c(vf), c(tables), c(lens),
                                     page_size=P)
      torch.cuda.synchronize()
      assert torch.equal(got, flt)


# -- row 2's split over a thread-block cluster (its CPU model) -----------------


@pytest.mark.parametrize("page", [1, 4, 16, 128])
@pytest.mark.parametrize("splits", range(1, 9))
def test_split_pages_cover_every_live_page_once(splits, page):
  """`SplitPages`, the block-decode kernel's split of a row: the blocks'
  runs, in rank order, are contiguous and cover the row's live pages
  exactly once (empty runs allowed), for rows of 0, 1, P, P + 1 slots, a
  ragged length and the table's full width (and past it: the read stops
  at the table)."""
  t_pages = 12
  for seq_len in (0, 1, page, page + 1, 5 * page - 3, t_pages * page,
                  t_pages * page + 7):
    runs = block_decode.SplitPages(seq_len, page, t_pages, splits)
    live = min(-(-seq_len // page), t_pages) if seq_len > 0 else 0
    assert len(runs) == splits
    hits = np.zeros(t_pages, int)
    end = 0
    for a, b in runs:
      assert a == end and b >= a
      hits[a:b] += 1
      end = b
    assert end == live
    assert (hits[:live] == 1).all() and (hits[live:] == 0).all()


@pytest.mark.parametrize("t_pages, page, want", [
    (64, 16, 8), (8, 128, 8), (4, 4, 1), (64, 4, 4), (3, 128, 3), (1, 1, 1),
    (512, 16, 8)])
def test_split_count_reads_the_table_width_only(t_pages, page, want):
  """`NumSplits` from the table's width and P (never seq_lens): about
  SPLIT_SLOTS table slots a block, at most 8 (the portable cluster) and
  at most one page a block; every block's scores fit MAX_CTA_SLOTS."""
  splits = block_decode.NumSplits(t_pages, page)
  assert splits == want
  assert block_decode.CtaSlots(t_pages, page, splits) <= (
      block_decode.MAX_CTA_SLOTS)


@pytest.mark.parametrize("splits", range(1, 9))
def test_split_maxima_are_the_reference_running_page_maxima(splits):
  """What a bfloat16 pool's probabilities are rounded against: each
  block's view (its own page maxima, then every block's max from the
  cluster's exchange) gives, bitwise, the reference's running max through
  the end of each page, and the row's max."""
  rng = np.random.RandomState(splits)
  for live in (1, 2, 7, 13, 40):
    page_max = torch.as_tensor(rng.randn(live).astype(np.float32))
    runs = block_decode.SplitPages(live * 16, 16, 64, splits)
    got, row_max = block_decode.SplitMaxima(page_max, runs)
    want = np.maximum.accumulate(page_max.numpy())
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(row_max) == float(want[-1])


def _SplitModelDecode(q, k_pool, v_pool, tables, lens, page, splits):
  """[B, N, H]: the block-decode kernel's arithmetic on a bfloat16 pool,
  on the CPU, from the split model: the maxima M_j of `SplitMaxima`,
  acc = sum bf16(exp(s - M_j)) exp(M_j - m) v, l the same unrounded, out =
  acc / max(l, 1e-20) with the row's max m."""
  b, _, n, h = q.shape
  kf = torch.as_tensor(k_pool).bfloat16().float()
  vf = torch.as_tensor(v_pool).bfloat16().float()
  t_pages = tables.shape[1]
  out = torch.zeros((b, n, h))
  for bi in range(b):
    runs = block_decode.SplitPages(int(lens[bi]), page, t_pages, splits)
    live = runs[-1][1]
    if live == 0:
      continue
    slots = np.arange(int(lens[bi]))[:live * page]
    pids = tables[bi, slots // page]
    for ni in range(n):
      k_rows = kf[pids, slots % page, ni]                   # [S, H]
      v_rows = vf[pids, slots % page, ni]
      s = k_rows @ torch.as_tensor(q[bi, 0, ni])
      page_of = torch.as_tensor(slots // page)
      page_max = torch.stack([s[page_of == j].max() for j in range(live)])
      m_j, m_row = block_decode.SplitMaxima(page_max, runs)
      p = torch.exp(s - m_j[page_of])
      e = torch.exp(m_j[page_of] - m_row)
      acc = (p.bfloat16().float() * e)[:, None] * v_rows
      out[bi, ni] = acc.sum(0) / torch.clamp((p * e).sum(), min=1e-20)
  return out.numpy()


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_split_model_matches_interpreted_pallas_kernel(splits):
  """The kernel's bfloat16 arithmetic from the split model, on dyadic q
  and K (scores exact in any order, so both sides round the same p),
  against the reference's interpreted Pallas kernel and the plain
  version, atol 2e-5; the inactive row exactly 0."""
  q, k_pool, v_pool, tables, lens = _Pool(seed=13)
  lens = np.array([11, 0, 16], np.int32)   # a ragged last page; full width
  q, k_pool = _Dyadic(q, 1 / 64), _Dyadic(k_pool, 1 / 8)
  got = _SplitModelDecode(q, k_pool, v_pool, tables, lens, P, splits)
  np.testing.assert_allclose(
      got, _JaxBlock(q, k_pool, v_pool, tables, lens, bf16=True)[:, 0],
      atol=ATOL)
  np.testing.assert_allclose(
      got, _PortBlock(q, k_pool, v_pool, tables, lens, bf16=True)[:, 0],
      atol=ATOL)
  np.testing.assert_array_equal(got[1], np.zeros_like(got[1]))


def _SplitPool(h, dtype, seed=14):
  """Row 2's kernel cases: 5 rows of 2 heads over a 16-page table of
  page 4: lengths 0 (inactive), 1, 4 (one full page), 37 (a
  ragged last page) and 64 (the table's full width); every page no row
  reads live, the table entries past each row's live pages and the stale
  slots of its last page poisoned (NaN; int8 127 and NaN scales)."""
  rng = np.random.RandomState(seed)
  b, t_pages, n = 5, 16, 2
  lens = np.array([0, 1, 4, 37, 64], np.int32)
  need = [-(-int(x) // P) for x in lens]
  np_total = sum(need) + 9
  perm = rng.permutation(np_total)
  owned = np.split(perm[:sum(need)], np.cumsum(need)[:-1])
  freed = perm[sum(need):]
  tables = rng.choice(freed, size=(b, t_pages)).astype(np.int32)
  for r in range(b):
    tables[r, :need[r]] = owned[r]
  k_pool = _Dyadic(rng.randn(np_total, P, n, h), 1 / 8)
  v_pool = rng.randn(np_total, P, n, h).astype(np.float32)
  q = _Dyadic(rng.randn(b, 1, n, h) / np.sqrt(h), 1 / 64)
  dead = np.zeros((np_total, P), bool)
  dead[freed] = True
  for r in range(b):
    if need[r]:
      dead[owned[r][-1], lens[r] - (need[r] - 1) * P:] = True
  k, v, scales = _Storage(k_pool, v_pool, dtype)
  c = lambda a: torch.as_tensor(a).cuda()
  kw = {}
  if scales:
    ks, vs = (s.copy() for s in scales)
    deq = (c(_Dequantize(k, ks)), c(_Dequantize(v, vs)))
    k, v = k.copy(), v.copy()
    for pool, sc in ((k, ks), (v, vs)):
      pool[dead] = 127
      sc.transpose(0, 2, 1)[dead] = np.nan
    kw = dict(k_scale=c(ks), v_scale=c(vs))
    kc, vc = c(k), c(v)
  else:
    kc, vc = c(k), c(v)
    if dtype == "bfloat16":
      kc, vc = kc.bfloat16(), vc.bfloat16()
    kc[c(dead)] = float("nan")
    vc[c(dead)] = float("nan")
    deq = None
  return c(q), kc, vc, c(tables), c(lens), kw, deq


@pytest.mark.cuda
class TestBlockDecodeSplitKernel:
  """Row 2's kernel against `_PlainBlockDecode` on the card with its
  cluster forced to 1, 2 and 8 blocks (`NumSplits`), at every head dim it
  takes: float32 within 2e-5; bfloat16 within 1e-5 on dyadic q and K, the
  float32 kernel on the widened pool (no p rounded) more than 1e-5 off;
  int8 bitwise equal to the float32 kernel on the dequantized pool; two
  calls bitwise equal, one counted launch per call; the inactive row
  exactly 0."""

  @pytest.mark.parametrize("splits", [1, 2, 8])
  @pytest.mark.parametrize("dtype, h", [
      ("float32", 4), ("float32", 8), ("float32", 16), ("float32", 32),
      ("float32", 64), ("float32", 128), ("bfloat16", 8),
      ("bfloat16", 32), ("bfloat16", 128), ("int8", 16), ("int8", 64),
      ("int8", 128)])
  def test_kernel_matches_plain(self, dtype, h, splits, monkeypatch):
    _NeedCard()
    monkeypatch.setattr(block_decode, "NumSplits", lambda *a: splits)
    q, k, v, tables, lens, kw, deq = _SplitPool(h, dtype)
    call = lambda k=k, v=v, kw=kw: block_decode.BlockDecode(
        q, k, v, tables, lens, page_size=P, **kw)
    launches = block_decode.BlockDecode.launches_by_dtype[dtype]
    got, again = call(), call()
    want = block_decode._PlainBlockDecode(q[:, 0], k, v, tables, lens, P,
                                          **kw)
    torch.cuda.synchronize()
    assert block_decode.BlockDecode.launches_by_dtype[dtype] == launches + 2
    assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
    assert (got[0] == 0).all()
    tol = 1e-5 if dtype == "bfloat16" else ATOL
    assert float((got[:, 0] - want).abs().max()) <= tol
    if dtype == "bfloat16":
      unrounded = call(k.float(), v.float(), {})
      assert float((unrounded[:, 0] - want).abs().max()) > 1e-5
    if deq is not None:
      assert torch.equal(got, call(*deq, {}))

  def test_kernel_refuses_shapes_outside_its_limits(self):
    """The wrapper raises what `KernelLimitError` says, before launching:
    a head dim that is not a power of two, an int8 row under 16 bytes."""
    _NeedCard()
    for dtype, h in ((torch.float32, 48), (torch.int8, 8)):
      assert block_decode.KernelLimitError(h, P, dtype) is not None
      pool = torch.zeros(3, P, 1, h, device="cuda").to(dtype)
      kw = {}
      if dtype == torch.int8:
        kw = dict(k_scale=torch.ones(3, 1, P, device="cuda"),
                  v_scale=torch.ones(3, 1, P, device="cuda"))
      launches = block_decode.BlockDecode.launches
      with pytest.raises(ValueError, match="head dim"):
        block_decode.BlockDecode(
            torch.zeros(1, 1, 1, h, device="cuda"), pool, pool,
            torch.zeros(1, 2, dtype=torch.int32, device="cuda"),
            torch.ones(1, dtype=torch.int32, device="cuda"), page_size=P,
            **kw)
      assert block_decode.BlockDecode.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_bf16_q_block_decode_on_card(dtype):
  """The block-decode kernel's bfloat16-q instantiation for each pool
  dtype on dyadic q and K (pages 16, a table of 64): bitwise the float32-q
  kernel on the widened q rounded to bfloat16, within one bfloat16 ulp of
  the plain version, an inactive row exactly zero, one launch counted
  under ('bfloat16', dtype)."""
  from tests.test_torch_ragged_attend import OneBf16Ulp
  _NeedCard()
  rng = np.random.RandomState(12)
  page, t_pages = 16, 64
  k_pool = _Dyadic(rng.randn(3 * t_pages + 1, page, 4, 128), 1 / 8)
  v_pool = rng.randn(3 * t_pages + 1, page, 4, 128).astype(np.float32)
  tables = rng.permutation(3 * t_pages).reshape(3, t_pages).astype(np.int32)
  q = _Dyadic(rng.randn(3, 1, 4, 128) / 8, 1 / 64)
  lens = np.array([700, 0, 1000], np.int32)
  c = lambda a: torch.as_tensor(a).cuda()
  k, v, scales = _Storage(k_pool, v_pool, dtype)
  sc = dict(k_scale=c(scales[0]), v_scale=c(scales[1])) if scales else {}
  kt, vt = c(k), c(v)
  if dtype == "bfloat16":
    kt, vt = kt.bfloat16(), vt.bfloat16()
  qb = c(q).bfloat16()
  before = block_decode.BlockDecode.launches_by_q_dtype["bfloat16"][dtype]
  out = block_decode.BlockDecode(qb, kt, vt, c(tables), c(lens),
                                 page_size=page, **sc)
  torch.cuda.synchronize()
  assert block_decode.BlockDecode.launches_by_q_dtype["bfloat16"][dtype] == (
      before + 1)
  wide = block_decode.BlockDecode(qb.float(), kt, vt, c(tables), c(lens),
                                  page_size=page, **sc)
  want = block_decode._PlainBlockDecode(qb[:, 0], kt, vt, c(tables),
                                        c(lens), page, **sc)
  torch.cuda.synchronize()
  assert out.dtype == want.dtype == torch.bfloat16
  assert torch.equal(out, wide.bfloat16())
  assert bool((out[1] == 0).all())
  assert OneBf16Ulp(out[:, 0], want)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_q_flash_decode_on_card(dtype):
  """Flash decode's bfloat16-q instantiations (the float32 cache's split
  and combine kernels, the bfloat16 cache's cluster kernel) on dyadic q
  and K at h 128, page 16, S 1152, t 1151 and 700: bitwise the float32-q
  kernel on the widened q rounded to bfloat16, within one bfloat16 ulp of
  the plain version, a wholly padded row exactly zero."""
  from tests.test_torch_ragged_attend import OneBf16Ulp
  _NeedCard()
  q, k, v, pad = _Cache(s=1152, seed=13, b=4, n=4, h=128)
  q, k = _Dyadic(q, 1 / 64), _Dyadic(k, 1 / 8)
  pad[1, :300] = 1.0
  c = lambda a: torch.as_tensor(a).cuda()
  kt, vt = c(k).to(getattr(torch, dtype)), c(v).to(getattr(torch, dtype))
  qb = c(q).bfloat16()
  for t in (1151, 700):
    before = flash_decode.FlashDecode.launches_by_q_dtype["bfloat16"][dtype]
    out = flash_decode.FlashDecode(qb, kt, vt, t, page_size=16,
                                   cache_paddings=c(pad))
    torch.cuda.synchronize()
    assert flash_decode.FlashDecode.launches_by_q_dtype["bfloat16"][
        dtype] == before + 1
    wide = flash_decode.FlashDecode(qb.float(), kt, vt, t, page_size=16,
                                    cache_paddings=c(pad))
    want = flash_decode._PlainDecode(qb[:, 0], kt, vt, t, 16, c(pad))
    torch.cuda.synchronize()
    assert out.dtype == want.dtype == torch.bfloat16
    assert torch.equal(out, wide.bfloat16())
    assert bool((out[2] == 0).all())
    assert OneBf16Ulp(out[:, 0], want)[0]
