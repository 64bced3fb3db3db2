"""The port's optimizers and learner options against the JAX reference on the CPU.

- Every ported optimizer (SGD, Momentum with and without Nesterov,
  RMSProp, Adagrad, Adam, AdamW, Adafactor, the Accumulator over Adam and
  SGD, a CompositeOptimizer of Adam and Momentum) through
  `Learner.Apply` over 3 steps, the second with a NaN gradient (a skipped
  step: parameters and slots roll back), against `jax.jit` of the
  reference's `Apply` on the same numpy trees (a weight, a repeat stack's
  stacked leaf, an unfactored rank-3 weight and a vector): parameters
  and every slot within atol 2e-6, rtol 1e-5, the stats within rtol
  1e-5. `convert.LoadJaxOptState` starts the port from the reference's
  state after its first step.
- Adam's bias correction against the jitted reference's at steps 0 to
  2999: within rtol 1e-6 (XLA contracts a product and a sum into one
  fused multiply-add where the port rounds twice: 1 ulp at a few steps).
- The Accumulator's mean divides by accum_steps as the jitted reference
  does, a product with the float32 reciprocal: bitwise equal to
  `jax.jit`, and the eager reference (a true division) differs.
- Each learner option (the per-tensor clip, clip-to-zero, skip_nan_gradients
  off, the gradient aggregation hook, the global clip with L1/L2) against
  the reference's `Apply`, and `RegularizationLoss`; a TrainStep with
  L2 and L1 weights against the reference's `TrainStep`.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lingvo_tpu.core import learner as jax_learner
from lingvo_tpu.core import optimizer as jax_optimizer
from lingvo_tpu.core.nested_map import NestedMap as JaxNestedMap
from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import learner
from lingvo_tpu_torch.core import optimizer

ATOL, RTOL = 2e-6, 1e-5
SHAPES = dict(f=(128, 256), s=(3, 16, 8), u=(32, 4, 8), vec=(7,))


def _Case(seed, nan_step=1, scale=0.01):
  rng = np.random.RandomState(seed)
  params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
  grads = [{k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in SHAPES.items()} for _ in range(3)]
  if nan_step is not None:
    grads[nan_step]["u"][0, 0, 0] = np.nan
  return params, grads


def _PortLeaf(key, arr):
  """'s' is the stacked leaf of a 3-layer repeat: per-layer tensors."""
  if key == "s":
    return base_layer.StackedLeaf(tuple(torch.tensor(a) for a in arr))
  return torch.tensor(arr)


def _LeafNumpy(leaf):
  if isinstance(leaf, base_layer.StackedLeaf):
    return np.stack([x.numpy() for x in leaf.layers])
  return leaf.numpy()


def _Jax(tree):
  return JaxNestedMap({k: jnp.asarray(v) for k, v in tree.items()})


def _Opts(name):
  """(reference optimizer Params, port optimizer Params)."""
  def Both(cls_name, **kw):
    return (getattr(jax_optimizer, cls_name).Params().Set(**kw),
            getattr(optimizer, cls_name).Params().Set(**kw))
  if name == "accum_adam":
    j, t = Both("Adam", beta2=0.98)
    return (jax_optimizer.Accumulator.Params().Set(optimizer_tpl=j,
                                                   accum_steps=2),
            optimizer.Accumulator.Params().Set(optimizer_tpl=t,
                                               accum_steps=2))
  if name == "accum_sgd":
    j, t = Both("SGD")
    return (jax_optimizer.Accumulator.Params().Set(optimizer_tpl=j,
                                                   accum_steps=2),
            optimizer.Accumulator.Params().Set(optimizer_tpl=t,
                                               accum_steps=2))
  if name == "composite":
    ja, ta = Both("Adam")
    jm, tm = Both("Momentum", momentum=0.8)
    return (jax_optimizer.CompositeOptimizer.Params().Set(
                optimizer_map=[("s|vec", ja, 0.5), (".*", jm, 1.0)]),
            optimizer.CompositeOptimizer.Params().Set(
                optimizer_map=[("s|vec", ta, 0.5), (".*", tm, 1.0)]))
  return {
      "sgd": lambda: Both("SGD"),
      "momentum": lambda: Both("Momentum", momentum=0.8),
      "nesterov": lambda: Both("Momentum", momentum=0.8, use_nesterov=True),
      "rmsprop": lambda: Both("RMSProp", decay=0.9, momentum=0.5,
                              epsilon=1e-3),
      "adagrad": lambda: Both("Adagrad", initial_accumulator_value=0.2),
      "adam": lambda: Both("Adam", beta2=0.98),
      "adamw": lambda: Both("AdamW", beta2=0.98, weight_decay=0.1),
      "adafactor": lambda: Both("Adafactor", beta1=0.9,
                                multiply_by_parameter_scale=False),
  }[name]()


def _Learners(opt_name, **kw):
  jopt, topt = _Opts(opt_name)
  kw = dict(dict(learning_rate=0.01), **kw)
  jl = jax_learner.Learner.Params().Set(name="lrn", optimizer=jopt,
                                        **kw).Instantiate()
  tl = learner.Learner.Params().Set(optimizer=topt, **kw).Instantiate(
      device="cpu")
  return jl, tl


def _CheckState(tstate, jstate):
  pairs = convert.OptStatePairs(tstate, jax.tree_util.tree_map(np.asarray,
                                                               jstate))
  assert len(pairs) == len(jax.tree_util.tree_leaves(jstate))
  for name, t, a in pairs:
    np.testing.assert_allclose(t.numpy(), a, atol=ATOL, rtol=RTOL,
                               err_msg=name)


def _Run(jl, tl, params, grads, jstats_names=("grad_norm", "learning_rate",
                                               "grad_scale",
                                               "skipped_step"),
         start_from_reference=False):
  """Applies grads step by step on both sides; checks the stats, the
  parameters and the state after each step. Returns the port's stats."""
  jtheta = _Jax(params)
  jstate = jl.InitState(jtheta)
  apply = jax.jit(jl.Apply)
  tp = {k: _PortLeaf(k, v) for k, v in params.items()}
  tstate = tl.InitState(tp)
  out = []
  for step, g in enumerate(grads):
    jtheta, jstate, jstats = apply(jtheta, _Jax(g), step, jstate)
    before = {k: _LeafNumpy(v).copy() for k, v in tp.items()}
    tstats = tl.Apply(tp, {k: _PortLeaf(k, v) for k, v in g.items()}, step,
                      tstate)
    out.append(tstats)
    for name in jstats_names:
      np.testing.assert_allclose(float(tstats[name]), float(jstats[name]),
                                 atol=0, rtol=RTOL, err_msg=name)
    if float(tstats.skipped_step):
      for k, v in tp.items():
        np.testing.assert_array_equal(_LeafNumpy(v), before[k])
    for k in params:
      np.testing.assert_allclose(_LeafNumpy(tp[k]), np.asarray(jtheta[k]),
                                 atol=ATOL, rtol=RTOL, err_msg=k)
    _CheckState(tstate, jstate)
    if start_from_reference and step == 0:
      # the rest of the run starts from the reference's state
      convert.LoadJaxOptState(
          tstate, jax.tree_util.tree_map(np.asarray, jstate))
  return out


OPTIMIZERS = ["sgd", "momentum", "nesterov", "rmsprop", "adagrad", "adam",
              "adamw", "adafactor", "accum_adam", "accum_sgd", "composite"]


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_update_with_a_skipped_step_matches_reference(name):
  params, grads = _Case(0)
  jl, tl = _Learners(name)
  stats = _Run(jl, tl, params, grads, start_from_reference=True)
  assert [float(s.skipped_step) for s in stats] == [0.0, 1.0, 0.0]


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_state_layout_matches_reference(name):
  """The port's slots carry the reference's names and shapes, a repeat
  stack's stacked, and the parameters move on an unskipped step."""
  params, grads = _Case(1, nan_step=None)
  jl, tl = _Learners(name)
  jstate = jl.InitState(_Jax(params))
  tp = {k: _PortLeaf(k, v) for k, v in params.items()}
  tstate = tl.InitState(tp)
  pairs = convert.OptStatePairs(tstate, jax.tree_util.tree_map(np.asarray,
                                                               jstate))
  n_ref = len(jax.tree_util.tree_leaves(jstate))
  assert len(pairs) == n_ref
  for _, t, a in pairs:
    np.testing.assert_array_equal(t.numpy(), a)
  for step in range(2):
    tl.Apply(tp, {k: _PortLeaf(k, v) for k, v in grads[step].items()}, step,
             tstate)
  moved = max(float(np.abs(_LeafNumpy(tp[k]) - params[k]).max())
              for k in params)
  assert moved > 1e-4


def test_adam_bias_correction_matches_jitted_reference():
  o = optimizer.Adam.Params().Set(beta2=0.98).Instantiate(device="cpu")

  def Corr(step, b1=0.9, b2=0.98):
    t = jnp.asarray(step, jnp.float32) + 1.0
    return jnp.sqrt(1.0 - b2**t) / (1.0 - b1**t)

  steps = np.arange(3000)
  want = np.asarray(jax.jit(jax.vmap(Corr))(jnp.asarray(steps)))
  got = np.array([float(o._Consts(int(s))["correction"]) for s in steps])
  np.testing.assert_allclose(got, want, atol=0, rtol=1e-6)
  assert (got == want).mean() > 0.99


def test_accumulator_mean_is_the_jitted_references():
  """accum_steps 3: the mean is accum * float32(1/3), as XLA compiles the
  reference's division by the constant. SGD at lr 1 from zero weights
  makes the new weights exactly minus the mean (from other weights XLA
  would fuse the product and the difference into one rounding). The
  eager reference divides and differs."""
  rng = np.random.RandomState(3)
  params = {"w": np.zeros((64, 64), np.float32)}
  grads = [{"w": rng.randn(64, 64).astype(np.float32)} for _ in range(3)]
  jopt = jax_optimizer.Accumulator.Params().Set(
      name="o", optimizer_tpl=jax_optimizer.SGD.Params(),
      accum_steps=3).Instantiate()
  topt = optimizer.Accumulator.Params().Set(
      optimizer_tpl=optimizer.SGD.Params(), accum_steps=3).Instantiate(
          device="cpu")
  lr = 1.0

  def Ref(update):
    th, st = _Jax(params), jopt.InitState(_Jax(params))
    for step, g in enumerate(grads):
      th, st = update(st, _Jax(g), th, jnp.float32(lr), step)
    return np.asarray(th["w"]), st

  jit_w, jit_state = Ref(jax.jit(jopt.Update))
  eager_w, _ = Ref(jopt.Update)
  tp = {"w": torch.tensor(params["w"])}
  tstate = topt.InitState(tp)
  for step, g in enumerate(grads):
    topt.Update(tstate, {"w": torch.tensor(g["w"])}, tp,
                torch.tensor(lr, dtype=torch.float32), step)
  np.testing.assert_array_equal(tp["w"].numpy(), jit_w)
  assert (eager_w != jit_w).any()   # the control: a true division differs
  assert int(tstate.count) == int(jit_state.count) == 0
  np.testing.assert_array_equal(tstate.accum["w"].numpy(),
                                np.zeros((64, 64), np.float32))


def _GradAgg(tree):
  return jax.tree_util.tree_map(lambda g: 0.5 * g, tree)


def _PortGradAgg(grads):
  out = {}
  for k, leaf in grads.items():
    if isinstance(leaf, base_layer.StackedLeaf):
      out[k] = base_layer.StackedLeaf(tuple(0.5 * g for g in leaf.layers))
    else:
      out[k] = 0.5 * leaf
  return out


@pytest.mark.parametrize("option", [
    "single_norm_clip", "clip_to_zero", "keep_nan", "aggregation",
    "global_clip_l1_l2"])
def test_learner_option_matches_reference(option):
  kw, nan_step, scale = {}, None, 0.01
  port_kw = {}
  if option == "single_norm_clip":
    kw = dict(clip_gradient_single_norm_to_value=0.05)
  elif option == "clip_to_zero":
    kw = dict(grad_norm_to_clip_to_zero=2.0)
    scale = 0.02   # a norm around 2.5: every step skipped except step 1's
  elif option == "keep_nan":
    kw = dict(skip_nan_gradients=False)
    nan_step = 1
  elif option == "aggregation":
    kw = dict(grad_aggregation_fn=_GradAgg)
    port_kw = dict(grad_aggregation_fn=_PortGradAgg)
  else:
    kw = dict(clip_gradient_norm_to_value=0.3, l2_regularizer_weight=1e-3,
              l1_regularizer_weight=1e-4)
  params, grads = _Case(4, nan_step=nan_step, scale=scale)
  if option == "clip_to_zero":
    grads[1] = {k: v * 0.5 for k, v in grads[1].items()}
  jopt, topt = _Opts("adam")
  jl = jax_learner.Learner.Params().Set(
      name="lrn", optimizer=jopt, learning_rate=0.01, **kw).Instantiate()
  tl = learner.Learner.Params().Set(
      optimizer=topt, learning_rate=0.01, **dict(kw, **port_kw)).Instantiate(
          device="cpu")
  names = ("learning_rate", "grad_scale", "skipped_step") + (
      () if option == "keep_nan" else ("grad_norm",))
  stats = _Run(jl, tl, params, grads, jstats_names=names)
  skipped = [float(s.skipped_step) for s in stats]
  if option == "clip_to_zero":
    assert skipped == [1.0, 0.0, 1.0]
  else:
    assert skipped == [0.0, 0.0, 0.0]
  if option == "global_clip_l1_l2":
    assert all(float(s.grad_scale) < 1.0 for s in stats)
    jreg = float(jl.RegularizationLoss(_Jax(params)))
    treg = float(tl.RegularizationLoss(
        {k: _PortLeaf(k, v) for k, v in params.items()}))
    np.testing.assert_allclose(treg, jreg, rtol=1e-6)
    assert treg > 0
