"""The port's DistributedShampoo, EGDD and AdaGraft against the JAX reference on the CPU.

Each runs through `Learner.Apply` for 12 steps against `jax.jit` of the
reference's `Apply` on the same numpy trees: a square [16, 16] and a
[24, 40] weight (preconditioned at block_size 64), a repeat stack's
stacked leaf [3, 16, 8] and a 3-D [32, 4, 8] weight (Shampoo's diagonal
fallback: a repeat stack is 3-D, as in the reference) and a vector;
step 5 has a NaN gradient, so it is skipped and every parameter and
slot rolls back (for Shampoo a refresh step: its roots roll back too).
`convert.LoadJaxOptState` restarts the port from the reference's state
after step 0.

Shampoo's inverse roots come from `eigh`, and the roots of a
rank-deficient statistic depend in its null space on the solver's
rounding (ROADMAP §3's deliberate divergence). So:
- on full-rank, well-conditioned statistics (condition ~1e2) the port's
  root equals the jitted reference's within atol 1e-6 (2e-6 of its
  largest entry), rtol 1e-5;
- at gradient scale 0.01 the damped null-space eigenvalues sit at
  epsilon, and the parameters agree within atol 2e-5 over all 12 steps
  (measured: 2.4e-7 with the restart from the reference's state, 8.3e-6
  with each side's own roots), the slots within 5e-4 of each slot's
  largest value (measured: 9.6e-5, the null-space entries of `root_r` of
  the [24, 40] leaf after the step-0 refresh);
- at gradient scale 1 the [24, 40] leaf's step-0 `root_r` (rank 24 of
  40) differs by more than 1e-2 of its largest value (measured: 0.184),
  yet the refresh step's update agrees within 1e-5 (measured 1.67e-6:
  the gradient has no component in the null space), and after the
  step-10 refresh, on full-rank statistics, the roots agree again within
  1e-4 (measured 6.8e-7).
`python -m tests.test_torch_shampoo_egdd_adagraft` prints these gaps.

EGDD and AdaGraft (magnitude Adam, direction Momentum; and AdaGraft
inside a CompositeOptimizer) hold parameters and slots within atol
2e-6, rtol 1e-5, their first steps included:
`sign(gbar)` is 0 at the first step, and `lr_scale` is one scalar over a
stacked leaf's layers.

The `cuda` cases (JAX is imported only in `_Jax`, so they run where it is
not installed) hold the four optimizers' 12 steps on the card against the
CPU: Shampoo's roots from cuSOLVER against LAPACK's.
"""

import types

import numpy as np
import pytest
import torch

from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import learner
from lingvo_tpu_torch.core import optimizer
from lingvo_tpu_torch.core.nested_map import NestedMap

SHAPES = dict(sq=(16, 16), f=(24, 40), s=(3, 16, 8), u=(32, 4, 8), vec=(7,))
STEPS, NAN_STEP = 12, 5


def _Jax():
  """The reference's modules, imported here only (the `cuda` cases run
  where JAX is not installed)."""
  import jax
  import jax.numpy as jnp
  from lingvo_tpu.core import learner as jax_learner
  from lingvo_tpu.core import optimizer as jax_optimizer
  from lingvo_tpu.core.nested_map import NestedMap as JaxNestedMap
  return types.SimpleNamespace(jax=jax, jnp=jnp, learner=jax_learner,
                               optimizer=jax_optimizer,
                               NestedMap=JaxNestedMap)


def _Case(scale, seed=0):
  rng = np.random.RandomState(seed)
  params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
  grads = [{k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in SHAPES.items()} for _ in range(STEPS)]
  grads[NAN_STEP]["u"][0, 0, 0] = np.nan
  return params, grads


def _PortLeaf(key, arr, device="cpu"):
  if key == "s":   # the stacked leaf of a 3-layer repeat
    return base_layer.StackedLeaf(tuple(torch.tensor(a, device=device)
                                        for a in arr))
  return torch.tensor(arr, device=device)


def _LeafNumpy(leaf):
  if isinstance(leaf, base_layer.StackedLeaf):
    return np.stack([x.cpu().numpy() for x in leaf.layers])
  return leaf.cpu().numpy()


def _JaxTree(tree):
  j = _Jax()
  return j.NestedMap({k: j.jnp.asarray(v) for k, v in tree.items()})


def _Opts(name, with_jax=True):
  """(reference optimizer Params or None, port optimizer Params)."""
  jax_optimizer = _Jax().optimizer if with_jax else None

  def Both(cls_name, **kw):
    return (getattr(jax_optimizer, cls_name).Params().Set(**kw)
            if with_jax else None,
            getattr(optimizer, cls_name).Params().Set(**kw))
  if name == "shampoo":
    return Both("DistributedShampoo", block_size=64,
                statistics_compute_steps=5)
  if name == "egdd":
    return Both("EGDD")
  if name == "egdd_magnitudes":
    return Both("EGDD", use_signs=False, use_directions=False)
  ja, ta = Both("Adam", beta2=0.98)
  jm, tm = Both("Momentum", momentum=0.8)
  jg = jax_optimizer.AdaGraft.Params().Set(
      magnitude_optimizer=ja, direction_optimizer=jm) if with_jax else None
  tg = optimizer.AdaGraft.Params().Set(magnitude_optimizer=ta,
                                       direction_optimizer=tm)
  if name == "adagraft":
    return jg, tg
  jad, tad = Both("Adagrad")
  return (jax_optimizer.CompositeOptimizer.Params().Set(
              optimizer_map=[("s|vec", jad, 0.5), (".*", jg, 1.0)])
          if with_jax else None,
          optimizer.CompositeOptimizer.Params().Set(
              optimizer_map=[("s|vec", tad, 0.5), (".*", tg, 1.0)]))


def _Run(name, scale, on_step=None, reload=True):
  """Both learners over the case's 12 steps; on_step(step, port params,
  port state, reference theta, reference state) after each. With reload,
  the port restarts from the reference's state after step 0."""
  j = _Jax()
  jopt, topt = _Opts(name)
  jl = j.learner.Learner.Params().Set(
      name="lrn", optimizer=jopt, learning_rate=0.01).Instantiate()
  tl = learner.Learner.Params().Set(
      optimizer=topt, learning_rate=0.01).Instantiate(device="cpu")
  params, grads = _Case(scale)
  jtheta = _JaxTree(params)
  jstate = jl.InitState(jtheta)
  apply = j.jax.jit(jl.Apply)
  tp = {k: _PortLeaf(k, v) for k, v in params.items()}
  tstate = tl.InitState(tp)
  for step, g in enumerate(grads):
    before = {k: _LeafNumpy(v).copy() for k, v in tp.items()}
    jtheta, jstate, _ = apply(jtheta, _JaxTree(g), step, jstate)
    tstats = tl.Apply(tp, {k: _PortLeaf(k, v) for k, v in g.items()}, step,
                      tstate)
    assert float(tstats.skipped_step) == float(step == NAN_STEP)
    if step == NAN_STEP:
      for k, v in tp.items():
        np.testing.assert_array_equal(_LeafNumpy(v), before[k])
    jnp_state = j.jax.tree_util.tree_map(np.asarray, jstate)
    on_step(step, tp, tstate, jtheta, jnp_state)
    if step == 0 and reload:
      convert.LoadJaxOptState(tstate, jnp_state)


def _Pairs(tstate, jstate):
  pairs = convert.OptStatePairs(tstate, jstate)
  assert len(pairs) == len(_Jax().jax.tree_util.tree_leaves(jstate))
  return pairs


@pytest.mark.parametrize("name", ["egdd", "egdd_magnitudes", "adagraft",
                                  "composite_adagraft"])
def test_egdd_and_adagraft_match_reference_over_12_steps(name):
  def Check(step, tp, tstate, jtheta, jstate):
    for k in SHAPES:
      np.testing.assert_allclose(_LeafNumpy(tp[k]), np.asarray(jtheta[k]),
                                 atol=2e-6, rtol=1e-5, err_msg=f"{step} {k}")
    for n, t, a in _Pairs(tstate, jstate):
      np.testing.assert_allclose(t.numpy(), a, atol=2e-6, rtol=1e-5,
                                 err_msg=f"{step} {n}")
  _Run(name, 0.01, Check)


def test_shampoo_matches_reference_over_12_steps_across_refreshes():
  def Check(step, tp, tstate, jtheta, jstate):
    for k in SHAPES:
      np.testing.assert_allclose(_LeafNumpy(tp[k]), np.asarray(jtheta[k]),
                                 atol=2e-5, rtol=0, err_msg=f"{step} {k}")
    for n, t, a in _Pairs(tstate, jstate):
      err = np.abs(t.numpy() - a).max() / max(np.abs(a).max(), 1e-30)
      assert err <= 5e-4, (step, n, err)
  _Run("shampoo", 0.01, Check)


def test_shampoo_null_space_roots_are_solver_noise():
  seen = {}

  def Check(step, tp, tstate, jtheta, jstate):
    if step == 0:
      t, a = tstate.root_r["f"].numpy(), jstate.root_r["f"]
      seen["root0"] = np.abs(t - a).max() / np.abs(a).max()
      seen["update0"] = np.abs(_LeafNumpy(tp["f"]) -
                               np.asarray(jtheta["f"])).max()
    if step == 10:
      seen["root10"] = max(
          np.abs(tstate[n]["f"].numpy() - jstate[n]["f"]).max() /
          np.abs(jstate[n]["f"]).max() for n in ("root_l", "root_r"))
    for k in ("sq", "s", "u", "vec"):   # full rank or no roots: tight
      np.testing.assert_allclose(_LeafNumpy(tp[k]), np.asarray(jtheta[k]),
                                 atol=2e-5, rtol=1e-5, err_msg=f"{step} {k}")
  _Run("shampoo", 1.0, Check)
  assert seen["root0"] > 1e-2, seen
  assert seen["update0"] < 1e-5, seen
  assert seen["root10"] < 1e-4, seen


def test_shampoo_inverse_root_on_full_rank_statistics_matches_reference():
  rng = np.random.RandomState(3)
  g = rng.randn(32, 48).astype(np.float32)
  stat = g @ g.T + np.eye(32, dtype=np.float32)   # condition ~ 1e2
  j = _Jax()
  jopt = j.optimizer.DistributedShampoo.Params().Instantiate()
  topt = optimizer.DistributedShampoo.Params().Instantiate(device="cpu")
  want = np.asarray(j.jax.jit(jopt._InverseQuarterRoot)(j.jnp.asarray(stat)))
  got = topt.InverseQuarterRoot(torch.tensor(stat)).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_shampoo_state_layout_and_the_shape_test():
  """The preconditioning test on the reference's shapes: a stacked leaf
  and a 3-D weight fall back (0-d placeholders), a 2-D leaf above
  block_size too; the slots carry the reference's names and shapes."""
  params, _ = _Case(0.01)
  params["big"] = np.ones((80, 16), np.float32)
  jopt, topt = _Opts("shampoo")
  jstate = jopt.Instantiate().InitState(_JaxTree(params))
  tstate = topt.Instantiate(device="cpu").InitState(
      {k: _PortLeaf(k, v) for k, v in params.items()})
  for k in ("s", "u", "vec", "big"):
    assert tuple(tstate.stat_l[k].shape) == ()
  assert tuple(tstate.root_r["f"].shape) == (40, 40)
  for _, t, a in _Pairs(tstate, _Jax().jax.tree_util.tree_map(np.asarray,
                                                              jstate)):
    np.testing.assert_array_equal(t.numpy(), a)


def test_adagraft_children_never_write_the_callers_tensors():
  """The magnitude and direction optimizers step from copies: the
  caller's parameters change only by the grafted step."""
  _, topt = _Opts("adagraft", with_jax=False)
  opt = topt.Instantiate(device="cpu")
  params, grads = _Case(0.01)
  tp = {k: _PortLeaf(k, v) for k, v in params.items()}
  ids = {k: [id(m) for m in optimizer.Members(v)] for k, v in tp.items()}
  state = opt.InitState(tp)
  lr = torch.tensor(0.01)
  opt.Update(state, {k: _PortLeaf(k, v) for k, v in grads[0].items()}, tp,
             lr, 0)
  assert {k: [id(m) for m in optimizer.Members(v)]
          for k, v in tp.items()} == ids
  # the step's length is Adam's: lr * correction * m / (sqrt(v) + eps)
  for k in SHAPES:
    step = _LeafNumpy(tp[k]) - params[k]
    assert 0 < np.linalg.norm(step) < 1.0


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: compares the card's optimizer steps "
                "with the CPU's")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["shampoo", "egdd", "adagraft",
                                  "composite_adagraft"])
def test_optimizers_on_card_match_cpu(cuda, name):
  """12 steps with the skipped one on the card and on the CPU (no JAX):
  Shampoo's roots from cuSOLVER against LAPACK's on this case's
  statistics (gradient scale 0.01: the null-space eigenvalues sit at
  epsilon), the parameters within atol 2e-5 and every slot within 5e-4 of
  its largest value for Shampoo, atol 2e-6, rtol 1e-5 for the others."""
  _, topt = _Opts(name, with_jax=False)
  params, grads = _Case(0.01)
  runs = []
  for dev in ("cpu", "cuda"):
    tl = learner.Learner.Params().Set(
        optimizer=topt, learning_rate=0.01).Instantiate(device=dev)
    tp = {k: _PortLeaf(k, v, dev) for k, v in params.items()}
    state = tl.InitState(tp)
    for step, g in enumerate(grads):
      stats = tl.Apply(tp, {k: _PortLeaf(k, v, dev) for k, v in g.items()},
                       step, state)
      assert float(stats.skipped_step) == float(step == NAN_STEP)
    runs.append((tp, state))
  (cpu_p, cpu_s), (card_p, card_s) = runs
  for k in SHAPES:
    np.testing.assert_allclose(
        _LeafNumpy(card_p[k]), _LeafNumpy(cpu_p[k]),
        atol=2e-5 if name == "shampoo" else 2e-6,
        rtol=0 if name == "shampoo" else 1e-5, err_msg=k)
  cpu_slots = dict(NestedMap(s=cpu_s).FlattenItems())
  for k, v in NestedMap(s=card_s).FlattenItems():
    got, want = v.cpu().numpy(), cpu_slots[k].numpy()
    if name == "shampoo":
      err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
      assert err <= 5e-4, (k, err)
    else:
      np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5,
                                 err_msg=k)


def _Measure():
  """Prints the measured gaps the bars above rest on (ROADMAP §3):
  `python -m tests.test_torch_shampoo_egdd_adagraft` from the repo root.
  Without the reload after step 0 each side keeps its own roots."""
  for scale in (0.01, 1.0):
    for reload in (True, False):
      seen = dict(param=0.0, slot=0.0)

      def Record(step, tp, tstate, jtheta, jstate, seen=seen):
        seen["param"] = max(seen["param"], max(
            float(np.abs(_LeafNumpy(tp[k]) - np.asarray(jtheta[k])).max())
            for k in SHAPES))
        seen["slot"] = max(seen["slot"], max(
            float(np.abs(t.numpy() - a).max() / max(np.abs(a).max(), 1e-30))
            for _, t, a in _Pairs(tstate, jstate)))
        if step in (0, 10):
          seen[step] = (max(
              float(np.abs(tstate[n]["f"].numpy() - jstate[n]["f"]).max()
                    / np.abs(jstate[n]["f"]).max())
              for n in ("root_l", "root_r")), float(np.abs(
                  _LeafNumpy(tp["f"]) - np.asarray(jtheta["f"])).max()))

      _Run("shampoo", scale, Record, reload=reload)
      print(f"gradient scale {scale}, reload {reload}: the [24, 40] leaf's "
            f"roots / parameter at step 0 {seen[0][0]:.3g} / "
            f"{seen[0][1]:.3g}, at step 10 {seen[10][0]:.3g} / "
            f"{seen[10][1]:.3g}; over 12 steps every parameter within "
            f"{seen['param']:.3g}, every slot within {seen['slot']:.3g} of "
            f"its largest entry")


if __name__ == "__main__":
  _Measure()
