"""lingvo_tpu_torch/ops/ragged_block_attend.py against the JAX reference.

The port's plain `RaggedAttend` (the CPU path and the CUDA kernel's
yardstick) must compute what the reference `RaggedAttend(lowering="xla")`
computes on the same packs: mixed decode / prefill / padding tokens, tree
rows with real ancestor masks, stale table entries past a row's horizon,
page sizes 8 and 16. Tolerance: float32, atol 2e-5 / rtol 1e-5 (the two
frameworks sum the page dot products in different orders). Padding
tokens must come out exactly zero. The CUDA kernel itself only runs on a
card: its cases (marked `cuda`) skip here and say so. The module imports
JAX only inside the reference helper, so on a machine with a card and no
JAX the kernel cases run alone:

    python -m pytest tests/test_torch_ragged_attend.py -m cuda
"""

import numpy as np
import pytest
import torch

from lingvo_tpu_torch.core import ragged
from lingvo_tpu_torch.ops import ragged_block_attend as rba

ATOL, RTOL = 2e-5, 1e-5


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


def _JaxRef(q, k_pool, v_pool, tables, pack, page):
  import jax.numpy as jnp
  from lingvo_tpu.ops import ragged_block_attend as jax_rba
  _, row_of, q_end, q_start, lo, hi = pack
  return np.asarray(jax_rba.RaggedAttend(
      jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
      jnp.asarray(tables), jnp.asarray(row_of), jnp.asarray(q_end),
      page_size=page, q_start=jnp.asarray(q_start), anc_lo=jnp.asarray(lo),
      anc_hi=jnp.asarray(hi), lowering="xla"))


def _Port(q, k_pool, v_pool, tables, pack, page):
  _, row_of, q_end, q_start, lo, hi = pack
  t = torch.as_tensor
  return rba.RaggedAttend(
      t(q), t(k_pool), t(v_pool), t(tables), t(row_of), t(q_end),
      page_size=page, q_start=t(q_start), anc_lo=t(lo), anc_hi=t(hi)).numpy()


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


class TestWrapperContract:

  def test_int8_pool_raises(self):
    q = torch.zeros((2, 1, 8))
    pool = torch.zeros((3, 8, 1, 8), dtype=torch.int8)
    tables = torch.zeros((1, 2), dtype=torch.int32)
    idx = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="int8"):
      rba.RaggedAttend(q, pool, pool, tables, idx, idx, page_size=8)

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
