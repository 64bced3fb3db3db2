"""lingvo_tpu_torch/ops/ragged_block_attend.py against the JAX reference.

The port's plain `RaggedAttend` (the CPU path and the CUDA kernel's
yardstick) must compute what the reference `RaggedAttend(lowering="xla")`
computes on the same packs: mixed decode / prefill / padding tokens, tree
rows with real ancestor masks, stale table entries past a row's horizon,
page sizes 8 and 16. Tolerance: float32, atol 2e-5 / rtol 1e-5 (the two
frameworks sum the page dot products in different orders). Padding
tokens must come out exactly zero.

Quantized pools: int8 pools with their [NP, N, P] scale sidecars and
bfloat16 pools go through the same plain op and are held to the
reference's XLA twin and its interpreted Pallas kernel (atol 2e-5). The
int8 op equals the float op on the pre-dequantized pool bit for bit (the
reference's contract), and NaN in dead slots' scales never reaches the
output.

The CUDA kernel itself only runs on a card (int8 within 1e-5 of the
plain version and bitwise equal to the float kernel on the dequantized
pool; bfloat16 within 1e-5 on dyadic q and K, `_Dyadic`, where q.k is
exact in any summation order, so kernel and plain version round the same
probabilities to bfloat16, while the float32 kernel on the widened pools,
which rounds none, must miss that bar): its cases (marked `cuda`)
skip here and say so. The module imports JAX only inside the reference
helper, so on a machine with a card and no JAX the kernel cases run
alone:

    python -m pytest tests/test_torch_ragged_attend.py -m cuda

Its bfloat16-q instantiations (fprop_dtype=bfloat16) must equal the
float32-q kernel on the widened q, rounded, bit for bit, and lie within
one bfloat16 ulp of the plain version.
"""

import numpy as np
import pytest
import torch

from lingvo_tpu_torch.core import ragged
from lingvo_tpu_torch.ops import ragged_block_attend as rba
from lingvo_tpu_torch.quant import kv as kv_quant

ATOL, RTOL = 2e-5, 1e-5


def _Dyadic(x, step):
  """x rounded to a multiple of the power of two `step`: few enough
  significant bits that a dot product of such values is exact in float32
  in any summation order."""
  return (np.round(x / step) * step).astype(np.float32)


def _Pool(page, b=3, t_pages=4, n=2, h=16, seed=0):
  rng = np.random.RandomState(seed)
  np_total = b * t_pages + 1
  k_pool = rng.randn(np_total, page, n, h).astype(np.float32)
  v_pool = rng.randn(np_total, page, n, h).astype(np.float32)
  tables = rng.permutation(np_total - 1).reshape(b, t_pages).astype(np.int32)
  return k_pool, v_pool, tables, rng


def _Pack(case, page, rng, n=2, h=16):
  """(q, row_of, q_end, q_start, anc_lo, anc_hi, padding mask) of a case."""
  if case == "tree":
    # row 0: a decode token; row 1: a 7-node tree (root + 2 branches of 3)
    # whose columns see only their ancestors; row 2: a 4-token prefill
    parents = np.array([-1, 0, 1, -1, 3, 4], np.int32)
    rows = ragged.BuildRaggedRows(
        [1, 7, 4], [2 * page + 3, page + 1, 5], 16, 8, {1: parents})
    q_end = np.where(rows.valid, rows.pos + 1, 0).astype(np.int32)
    q_start = rows.row_q_pos[rows.row_of].astype(np.int32)
    row_of, lo, hi = rows.row_of, rows.anc_lo, rows.anc_hi
  else:
    # decode row 0 | prefill row 1 (3 tokens) | verify-style row 2 | pads
    row_of = np.array([0, 1, 1, 1, 2, 2, 2, 0, 0], np.int32)
    q_end = np.array([2 * page + 1, 5, 6, 7, page + 4, page + 5, page + 6,
                      0, 0], np.int32)
    q_start = np.zeros_like(q_end)
    lo = hi = np.full_like(q_end, -1)
  q = rng.randn(len(row_of), n, h).astype(np.float32)
  return q, row_of, q_end, q_start, lo, hi


def _JaxRef(q, k_pool, v_pool, tables, pack, page, scales=(),
            bf16=False, lowering="xla"):
  """The reference op; scales = (k_scale, v_scale) of int8 pools, bf16
  rounds float32 pools to bfloat16 first."""
  import jax.numpy as jnp
  from lingvo_tpu.ops import ragged_block_attend as jax_rba
  _, row_of, q_end, q_start, lo, hi = pack
  k, v = jnp.asarray(k_pool), jnp.asarray(v_pool)
  if bf16:
    k, v = k.astype(jnp.bfloat16), v.astype(jnp.bfloat16)
  kw = {}
  if scales:
    kw = dict(k_scale=jnp.asarray(scales[0]), v_scale=jnp.asarray(scales[1]))
  if lowering == "pallas":
    kw["interpret"] = True
  return np.asarray(jax_rba.RaggedAttend(
      jnp.asarray(q), k, v, jnp.asarray(tables), jnp.asarray(row_of),
      jnp.asarray(q_end), page_size=page, q_start=jnp.asarray(q_start),
      anc_lo=jnp.asarray(lo), anc_hi=jnp.asarray(hi), lowering=lowering,
      **kw))


def _Port(q, k_pool, v_pool, tables, pack, page, scales=(), bf16=False):
  _, row_of, q_end, q_start, lo, hi = pack
  t = torch.as_tensor
  k, v = t(k_pool), t(v_pool)
  if bf16:
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
  kw = dict(k_scale=t(scales[0]), v_scale=t(scales[1])) if scales else {}
  return rba.RaggedAttend(
      t(q), k, v, t(tables), t(row_of), t(q_end), page_size=page,
      q_start=t(q_start), anc_lo=t(lo), anc_hi=t(hi), **kw).numpy()


def _Quantize(pool):
  """An int8 pool [NP, P, N, H] and its sidecar [NP, N, P], quantized per
  (slot, head) as the serving step writes them."""
  q8, scale = kv_quant.QuantizeKv(torch.as_tensor(pool))
  return q8.numpy(), np.ascontiguousarray(scale.numpy().transpose(0, 2, 1))


def _Dequantize(q8, scale):
  """The float pool the int8 pool stands for (the reference
  `_DequantPages`)."""
  return rba._DequantPages(torch.as_tensor(q8),
                           torch.as_tensor(scale)).numpy()


class TestPlainRaggedAttendMatchesJax:

  @pytest.mark.parametrize("page", [8, 16])
  @pytest.mark.parametrize("case", ["mixed", "tree", "stale"])
  def test_matches_reference(self, case, page):
    k_pool, v_pool, tables, rng = _Pool(page)
    pack = _Pack(case, page, rng)
    q = pack[0]
    if case == "stale":
      # entries past each row's horizon alias other rows' live pages: they
      # must not change the output
      hostile = tables.copy()
      hostile[0, 3] = tables[1, 0]
      hostile[1, 1:] = tables[0, :3]
      hostile[2, 2:] = tables[1, :2]
      ref = _JaxRef(q, k_pool, v_pool, tables, pack, page)
      tables = hostile
    else:
      ref = _JaxRef(q, k_pool, v_pool, tables, pack, page)
    launches = rba.RaggedAttend.launches
    out = _Port(q, k_pool, v_pool, tables, pack, page)
    assert rba.RaggedAttend.launches == launches   # CPU: no kernel launch
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    pad = pack[2] == 0
    np.testing.assert_array_equal(out[pad], np.zeros_like(out[pad]))

  def test_chain_default_equals_explicit_sentinel(self):
    """Omitting the tree operands is chain semantics: bitwise the -1/-1
    sentinel call."""
    k_pool, v_pool, tables, rng = _Pool(8)
    pack = _Pack("mixed", 8, rng)
    q, row_of, q_end = pack[:3]
    t = torch.as_tensor
    plain = rba.RaggedAttend(t(q), t(k_pool), t(v_pool), t(tables),
                             t(row_of), t(q_end), page_size=8).numpy()
    np.testing.assert_array_equal(plain,
                                  _Port(q, k_pool, v_pool, tables, pack, 8))

  def test_nonfinite_dead_pages_never_leak(self):
    """Freed pages full of NaN, reachable only through table entries past
    a row's horizon or through masked slots, leave the output finite and
    unchanged."""
    k_pool, v_pool, tables, rng = _Pool(8)
    pack = _Pack("mixed", 8, rng)
    q = pack[0]
    clean = _Port(q, k_pool, v_pool, tables, pack, 8)
    kp, vp = k_pool.copy(), v_pool.copy()
    # each row's pages past its own horizon (row 0 reads 3 pages, row 1
    # one, row 2 two); the page loop still visits some of them for the
    # tokens of shorter rows
    dead = np.concatenate([tables[0, 3:], tables[1, 1:], tables[2, 2:]])
    kp[dead] = np.nan
    vp[dead] = np.nan
    poisoned = _Port(q, kp, vp, tables, pack, 8)
    np.testing.assert_array_equal(poisoned, clean)


class TestQuantizedPoolsMatchJax:

  @pytest.mark.parametrize("lowering", ["xla", "pallas"])
  @pytest.mark.parametrize("case", ["mixed", "tree"])
  def test_int8_matches_reference(self, case, lowering):
    k_pool, v_pool, tables, rng = _Pool(8)
    pack = _Pack(case, 8, rng)
    (k8, ks), (v8, vs) = _Quantize(k_pool), _Quantize(v_pool)
    ref = _JaxRef(pack[0], k8, v8, tables, pack, 8, (ks, vs),
                  lowering=lowering)
    out = _Port(pack[0], k8, v8, tables, pack, 8, (ks, vs))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    pad = pack[2] == 0
    np.testing.assert_array_equal(out[pad], np.zeros_like(out[pad]))

  @pytest.mark.parametrize("lowering", ["xla", "pallas"])
  @pytest.mark.parametrize("case", ["mixed", "tree"])
  def test_bf16_matches_reference(self, case, lowering):
    """bfloat16 pools: p is rounded to bfloat16 before P.V on both sides,
    so the port meets the reference at the float32 tolerance."""
    k_pool, v_pool, tables, rng = _Pool(8)
    pack = _Pack(case, 8, rng)
    ref = _JaxRef(pack[0], k_pool, v_pool, tables, pack, 8, bf16=True,
                  lowering=lowering)
    out = _Port(pack[0], k_pool, v_pool, tables, pack, 8, bf16=True)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)

  def test_int8_equals_float_on_the_dequantized_pool(self):
    """The reference's contract: dequantize-on-read, then the float page
    step, bit for bit."""
    k_pool, v_pool, tables, rng = _Pool(16, seed=2)
    pack = _Pack("mixed", 16, rng)
    (k8, ks), (v8, vs) = _Quantize(k_pool), _Quantize(v_pool)
    int8 = _Port(pack[0], k8, v8, tables, pack, 16, (ks, vs))
    flt = _Port(pack[0], _Dequantize(k8, ks), _Dequantize(v8, vs), tables,
                pack, 16)
    np.testing.assert_array_equal(int8, flt)

  def test_nonfinite_dead_scales_and_pages_never_leak(self):
    """NaN scales and NaN-scaled int8 extremes in every slot no token may
    read (pages past a row's horizon, stale slots of its last page), and
    NaN bfloat16 pages there, leave the outputs unchanged, bitwise."""
    k_pool, v_pool, tables, rng = _Pool(8)
    pack = _Pack("mixed", 8, rng)
    q = pack[0]
    (k8, ks), (v8, vs) = _Quantize(k_pool), _Quantize(v_pool)
    clean8 = _Port(q, k8, v8, tables, pack, 8, (ks, vs))
    clean16 = _Port(q, k_pool, v_pool, tables, pack, 8, bf16=True)
    dead = np.concatenate([tables[0, 3:], tables[1, 1:], tables[2, 2:]])
    k8, v8, ks, vs = (a.copy() for a in (k8, v8, ks, vs))
    kp, vp = k_pool.copy(), v_pool.copy()
    for pool8, scale, pool in ((k8, ks, kp), (v8, vs, vp)):
      pool8[dead] = -128
      scale[dead] = np.nan
      pool[dead] = np.nan
      # row 1's horizon is slot 7 of its first page; row 2's is 14
      pool8[tables[2, 1], 7:] = 127
      scale[tables[2, 1], :, 7:] = np.nan
      pool[tables[2, 1], 7:] = np.nan
    np.testing.assert_array_equal(
        _Port(q, k8, v8, tables, pack, 8, (ks, vs)), clean8)
    np.testing.assert_array_equal(
        _Port(q, kp, vp, tables, pack, 8, bf16=True), clean16)


class TestWrapperContract:

  def test_pools_and_scales_must_agree(self):
    """int8 pools need both sidecars, other pools take none, and the
    sidecars are float32 [NP, N, P]."""
    q = torch.zeros((2, 1, 8))
    pool8 = torch.zeros((3, 8, 1, 8), dtype=torch.int8)
    pool = torch.zeros((3, 8, 1, 8))
    scale = torch.ones((3, 1, 8))
    tables = torch.zeros((1, 2), dtype=torch.int32)
    idx = torch.zeros((2,), dtype=torch.int32)
    attend = lambda k, v, **kw: rba.RaggedAttend(q, k, v, tables, idx, idx,
                                                 page_size=8, **kw)
    with pytest.raises(ValueError, match="int8 pools take"):
      attend(pool8, pool8)
    with pytest.raises(ValueError, match="int8 pools take"):
      attend(pool, pool, k_scale=scale, v_scale=scale)
    with pytest.raises(ValueError, match="together"):
      attend(pool8, pool8, k_scale=scale)
    with pytest.raises(ValueError, match="sidecars"):
      attend(pool8, pool8, k_scale=scale[:, :, :4], v_scale=scale[:, :, :4])
    with pytest.raises(TypeError, match="share"):
      attend(pool8, pool)
    np.testing.assert_array_equal(
        attend(pool8, pool8, k_scale=scale, v_scale=scale).numpy(),
        np.zeros((2, 1, 8), np.float32))

  def test_partial_tree_operands_raise(self):
    q = torch.zeros((2, 1, 8))
    pool = torch.zeros((3, 8, 1, 8))
    tables = torch.zeros((1, 2), dtype=torch.int32)
    idx = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
      rba.RaggedAttend(q, pool, pool, tables, idx, idx, page_size=8,
                       q_start=idx)


@pytest.mark.cuda
class TestCudaKernel:

  @pytest.mark.parametrize("case", ["mixed", "tree"])
  def test_kernel_matches_plain_on_card(self, case):
    if not torch.cuda.is_available():
      pytest.skip("no CUDA device here: the CUDA kernel is unverified on "
                  "this machine (chip_smoke.py checks it on the H100)")
    k_pool, v_pool, tables, rng = _Pool(16)
    pack = _Pack(case, 16, rng)
    ref = _Port(pack[0], k_pool, v_pool, tables, pack, 16)
    cuda = [torch.as_tensor(x).cuda() for x in
            (pack[0], k_pool, v_pool, tables) + pack[1:]]
    launches = rba.RaggedAttend.launches
    out = rba.RaggedAttend(*cuda[:4], cuda[4], cuda[5], page_size=16,
                           q_start=cuda[6], anc_lo=cuda[7], anc_hi=cuda[8])
    torch.cuda.synchronize()
    assert rba.RaggedAttend.launches == launches + 1
    np.testing.assert_allclose(out.cpu().numpy(), ref, atol=1e-5, rtol=1e-5)

  @pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
  @pytest.mark.parametrize("case", ["mixed", "tree"])
  def test_quantized_kernel_matches_plain_on_card(self, case, dtype):
    """The int8 and bfloat16 instantiations against the plain version,
    with NaN in dead scales and dead bfloat16 pages, within 1e-5; the int8
    kernel equals the float kernel on the dequantized pool, bitwise. The
    bfloat16 case runs on dyadic q and K, so both sides round the same p,
    and the float32 kernel on the widened pools (p unrounded) must miss
    the 1e-5 bar."""
    if not torch.cuda.is_available():
      pytest.skip("no CUDA device here: the CUDA kernel is unverified on "
                  "this machine (chip_smoke.py checks it on the H100)")
    k_pool, v_pool, tables, rng = _Pool(16)
    pack = _Pack(case, 16, rng)
    row_of, q_end = pack[1], pack[2]
    live = set()
    for r in range(tables.shape[0]):   # each row's pages up to its horizon
      need = -(-int(q_end[row_of == r].max()) // 16)
      live |= {int(x) for x in tables[r, :need]}
    dead = [i for i in range(k_pool.shape[0]) if i not in live]
    c = lambda a: torch.as_tensor(a).cuda()
    ints = [c(x) for x in pack[1:]]
    tree = dict(q_start=ints[2], anc_lo=ints[3], anc_hi=ints[4])
    q = pack[0]
    if dtype == "int8":
      (k8, ks), (v8, vs) = _Quantize(k_pool), _Quantize(v_pool)
      kf, vf = _Dequantize(k8, ks), _Dequantize(v8, vs)
      for scale in (ks, vs):
        scale[dead] = np.nan
      pools = dict(k_pool=c(k8), v_pool=c(v8), k_scale=c(ks), v_scale=c(vs))
    else:
      q, kp, vp = _Dyadic(q / 4, 1 / 32), _Dyadic(k_pool, 1 / 8), v_pool.copy()
      kp[dead] = np.nan
      vp[dead] = np.nan
      pools = dict(k_pool=c(kp).bfloat16(), v_pool=c(vp).bfloat16())
    args = lambda k, v: (c(q), k, v, c(tables), ints[0], ints[1])
    launches = dict(rba.RaggedAttend.launches_by_dtype)
    out = rba.RaggedAttend(*args(pools["k_pool"], pools["v_pool"]),
                           page_size=16, k_scale=pools.get("k_scale"),
                           v_scale=pools.get("v_scale"), **tree)
    want = rba._PlainRaggedAttend(
        *args(pools["k_pool"], pools["v_pool"]), 16, **tree,
        k_scale=pools.get("k_scale"), v_scale=pools.get("v_scale"))
    torch.cuda.synchronize()
    assert rba.RaggedAttend.launches_by_dtype[dtype] == launches[dtype] + 1
    assert bool(torch.isfinite(out).all())
    assert float((out - want).abs().max()) <= 1e-5
    if dtype == "bfloat16":
      unrounded = rba.RaggedAttend(
          *args(pools["k_pool"].float(), pools["v_pool"].float()),
          page_size=16, **tree)
      assert float((unrounded - want).abs().max()) > 1e-5
    if dtype == "int8":
      flt = rba.RaggedAttend(*args(c(kf), c(vf)), page_size=16, **tree)
      torch.cuda.synchronize()
      assert torch.equal(out, flt)


# -- the kernel's tile schedule (runs here) ------------------------------------


def _SchedulePack(case, page=16):
  """(row_of, q_end, t_pages, num_rows) of a schedule case."""
  if case in ("main", "tree_in_tile"):
    # phase 3's pack of chip_smoke.py: decode rows, two prefill chunks
    # that straddle tile edges, a tree row, padding
    lens, q_pos = [1, 1, 1, 1, 1, 128, 120, 7], [999, 516, 63, 32, 299, 256,
                                                0, 700]
    if case == "tree_in_tile":   # the tree row lands inside one tile
      lens, q_pos = [3, 7, 20], [40, 600, 90]
    parents = np.array([-1, 0, 1, -1, 3, 4], np.int32)
    tree_row = 7 if case == "main" else 1
    rows = ragged.BuildRaggedRows(lens, q_pos, 264, 256,
                                  {tree_row: parents})
    q_end = np.where(rows.valid, rows.pos + 1, 0).astype(np.int32)
    return rows.row_of, q_end, 1024 // page, len(lens)
  if case == "decode_only":    # 8 live tokens, 256 padding
    rows = ragged.BuildRaggedRows([1] * 8, [700, 999, 512, 800, 333, 901,
                                            640, 777], 264, 256)
    q_end = np.where(rows.valid, rows.pos + 1, 0).astype(np.int32)
    return rows.row_of, q_end, 1024 // page, 8
  if case == "scattered":      # a row's tokens not contiguous: A B A
    row_of = np.array([0, 0, 1, 0, 0, 2, 2, 0], np.int32)
    q_end = np.array([5, 6, 40, 7, 8, 300, 301, 0], np.int32)
    return row_of, q_end, 32, 3
  if case == "long_prefill":   # 70 tokens of one row over 4 tile edges
    row_of = np.full(80, 1, np.int32)
    q_end = np.concatenate([np.arange(200, 270), np.zeros(10)]).astype(
        np.int32)
    return row_of, q_end, 64, 2
  raise ValueError(case)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("case", ["main", "tree_in_tile", "decode_only",
                                  "scattered", "long_prefill"])
def test_tile_schedule_covers_each_live_token_once(case, split):
  """`TileSchedule` (the kernel's schedule rule): every live token in
  exactly one tile, padding tokens in none; a tile holds at most 16
  consecutive tokens of one row_of and never crosses a row_of change or a
  tile-size boundary; a tile's splits run in order and cover its live
  pages, ceil(max q_end / P), exactly once; bfloat16 schedules
  (split=False) never split."""
  row_of, q_end, t_pages, num_rows = _SchedulePack(case)
  items = rba.TileSchedule(row_of, q_end, 16, t_pages, num_rows,
                           split=split)
  f = {name: i for i, name in enumerate(rba.ITEM_FIELDS)}
  hits = np.zeros(len(q_end), int)
  tiles = {}
  for it in items:
    tiles.setdefault(int(it[f["tile"]]), []).append(it)
  assert sorted(tiles) == list(range(len(tiles)))
  for tile, its in tiles.items():
    tok0, n = int(its[0][f["tok0"]]), int(its[0][f["len"]])
    assert 1 <= n <= rba.TILE_TOKENS
    assert tok0 // rba.TILE_TOKENS == (tok0 + n - 1) // rba.TILE_TOKENS
    toks = np.arange(tok0, tok0 + n)
    assert (row_of[toks] == row_of[tok0]).all()
    assert (q_end[toks] > 0).all()
    hits[toks] += 1
    pages = min(-(-int(q_end[toks].max()) // 16), t_pages)
    nsplit = int(its[0][f["nsplit"]])
    assert len(its) == nsplit <= rba.MAX_SPLITS
    assert split or nsplit == 1
    edge = 0
    for s, it in enumerate(its):
      assert (int(it[f["tok0"]]), int(it[f["len"]])) == (tok0, n)
      assert int(it[f["split"]]) == s
      assert int(it[f["row"]]) == row_of[tok0]
      assert int(it[f["page_begin"]]) == edge
      edge = int(it[f["page_end"]])
      assert edge > int(it[f["page_begin"]])
    assert edge == pages
  assert (hits == (q_end > 0)).all()
  # a tile ends where row_of changes: the next live token starts a tile
  starts = {int(its[0][f["tok0"]]) for its in tiles.values()}
  for i in range(1, len(q_end)):
    if q_end[i] > 0 and (row_of[i] != row_of[i - 1] or q_end[i - 1] <= 0):
      assert i in starts


def _EdgePack(case, rng, n=2, h=16, page=16):
  """(q, row_of, q_end, q_start, anc_lo, anc_hi, tables, k_pool, v_pool)
  of a kernel edge case: `_SchedulePack`'s packs over random pools."""
  row_of, q_end, t_pages, num_rows = _SchedulePack(case, page)
  t = len(row_of)
  if case in ("main", "tree_in_tile", "decode_only"):
    lens = {"main": [1, 1, 1, 1, 1, 128, 120, 7],
            "tree_in_tile": [3, 7, 20], "decode_only": [1] * 8}[case]
    tree = {"main": 7, "tree_in_tile": 1}.get(case)
    parents = np.array([-1, 0, 1, -1, 3, 4], np.int32)
    q_pos = {"main": [999, 516, 63, 32, 299, 256, 0, 700],
             "tree_in_tile": [40, 600, 90],
             "decode_only": [700, 999, 512, 800, 333, 901, 640, 777]}[case]
    rows = ragged.BuildRaggedRows(lens, q_pos, t, 256,
                                  {tree: parents} if tree is not None else
                                  None)
    q_start = rows.row_q_pos[rows.row_of].astype(np.int32)
    lo, hi = rows.anc_lo, rows.anc_hi
  else:
    q_start = np.zeros(t, np.int32)
    lo = hi = np.full(t, -1, np.int32)
  num_pages = num_rows * t_pages + 1
  tables = rng.permutation(num_pages - 1)[:num_rows * t_pages].reshape(
      num_rows, t_pages).astype(np.int32)
  k_pool = rng.randn(num_pages, page, n, h).astype(np.float32)
  v_pool = rng.randn(num_pages, page, n, h).astype(np.float32)
  q = (rng.randn(t, n, h) / 4).astype(np.float32)
  return q, row_of, q_end, q_start, lo, hi, tables, k_pool, v_pool


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("case", ["main", "tree_in_tile", "decode_only",
                                  "scattered", "long_prefill"])
def test_kernel_edges_on_card(case, dtype):
  """The kernel on the schedule cases (a decode-only pack of 8 live
  tokens and 256 padding, prefill chunks that straddle tile edges, a tree
  row inside a tile, a row whose tokens are not contiguous): the card's
  schedule equals `TileSchedule`; within 1e-5 of the plain version
  (bfloat16 on dyadic q and K); padding exactly zero; int8 bitwise the
  float32 kernel on the dequantized pool; two calls bitwise equal."""
  if not torch.cuda.is_available():
    pytest.skip("no CUDA device here: the CUDA kernel is unverified on "
                "this machine (chip_smoke.py checks it on the H100)")
  q, row_of, q_end, q_start, lo, hi, tables, k_pool, v_pool = _EdgePack(
      case, np.random.RandomState(3))
  c = lambda a: torch.as_tensor(a).cuda()
  split = dtype != "bfloat16"
  got_items = rba.DeviceSchedule(c(row_of), c(q_end), 16, tables.shape[1],
                                 tables.shape[0], 2, split=split)
  np.testing.assert_array_equal(
      got_items, rba.TileSchedule(row_of, q_end, 16, tables.shape[1],
                                  tables.shape[0], split=split))
  sc = {}
  if dtype == "bfloat16":
    q, k_pool = _Dyadic(q, 1 / 32), _Dyadic(k_pool, 1 / 8)
    k, v = c(k_pool).bfloat16(), c(v_pool).bfloat16()
  elif dtype == "int8":
    (k8, ks), (v8, vs) = _Quantize(k_pool), _Quantize(v_pool)
    k, v = c(k8), c(v8)
    sc = dict(k_scale=c(ks), v_scale=c(vs))
  else:
    k, v = c(k_pool), c(v_pool)
  args = (c(q), k, v, c(tables), c(row_of), c(q_end))
  tree = dict(q_start=c(q_start), anc_lo=c(lo), anc_hi=c(hi))
  out = rba.RaggedAttend(*args, page_size=16, **sc, **tree)
  again = rba.RaggedAttend(*args, page_size=16, **sc, **tree)
  want = rba._PlainRaggedAttend(*args, 16, **tree, **sc)
  torch.cuda.synchronize()
  assert torch.equal(out, again)
  assert bool((out[c(q_end <= 0)] == 0).all())
  assert float((out - want).abs().max()) <= 1e-5
  if dtype == "int8":
    deq = [c(_Dequantize(k8, ks)), c(_Dequantize(v8, vs))]
    flt = rba.RaggedAttend(args[0], *deq, *args[3:], page_size=16, **tree)
    torch.cuda.synchronize()
    assert torch.equal(out, flt)


def OneBf16Ulp(got, want):
  """Whether bfloat16 got is within one bfloat16 ulp of want everywhere
  (2^-7 of the magnitude, plus 1e-6 of the largest for values near 0):
  float32 sums in another order, then one rounding, can land on either
  side of a rounding boundary. Returns (ok, elements that differ)."""
  g, w = got.float(), want.float()
  bar = 2.0 ** -7 * w.abs() + 1e-6 * float(w.abs().max())
  return bool(((g - w).abs() <= bar).all()), int((g != w).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("case", ["main", "tree_in_tile", "decode_only"])
def test_bf16_q_kernel_on_card(case, dtype):
  """The bfloat16-q instantiation (fprop_dtype=bfloat16) for each pool
  dtype on dyadic q and K: a bfloat16 output bitwise equal to the
  float32-q kernel on the widened q rounded to bfloat16 (the widening is
  exact and the rest is the float32 code), within one bfloat16 ulp of the
  plain version (float32 sums in another order, then one rounding),
  padding exactly zero, one launch counted under ('bfloat16', dtype)."""
  if not torch.cuda.is_available():
    pytest.skip("no CUDA device here: the CUDA kernel is unverified on "
                "this machine (chip_smoke.py checks it on the H100)")
  q, row_of, q_end, q_start, lo, hi, tables, k_pool, v_pool = _EdgePack(
      case, np.random.RandomState(5))
  q, k_pool = _Dyadic(q, 1 / 32), _Dyadic(k_pool, 1 / 8)
  c = lambda a: torch.as_tensor(a).cuda()
  sc = {}
  if dtype == "int8":
    (k8, ks), (v8, vs) = _Quantize(k_pool), _Quantize(v_pool)
    k, v = c(k8), c(v8)
    sc = dict(k_scale=c(ks), v_scale=c(vs))
  else:
    k, v = c(k_pool).to(getattr(torch, dtype)), c(v_pool).to(
        getattr(torch, dtype))
  qb = c(q).bfloat16()
  rest = (k, v, c(tables), c(row_of), c(q_end))
  tree = dict(q_start=c(q_start), anc_lo=c(lo), anc_hi=c(hi))
  before = rba.RaggedAttend.launches_by_q_dtype["bfloat16"][dtype]
  out = rba.RaggedAttend(qb, *rest, page_size=16, **sc, **tree)
  torch.cuda.synchronize()
  assert rba.RaggedAttend.launches_by_q_dtype["bfloat16"][dtype] == (
      before + 1)
  wide = rba.RaggedAttend(qb.float(), *rest, page_size=16, **sc, **tree)
  want = rba._PlainRaggedAttend(qb, *rest, 16, **tree, **sc)
  torch.cuda.synchronize()
  assert out.dtype == want.dtype == torch.bfloat16
  assert torch.equal(out, wide.bfloat16())
  assert bool((out[c(q_end <= 0)] == 0).all())
  assert OneBf16Ulp(out, want)[0]
