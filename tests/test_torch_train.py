"""The training slice of lingvo_tpu_torch against the JAX reference on the CPU.

- `SyntheticLmInput` batches are byte-identical to the reference's.
- `LinearRampupCosineDecay`, `Adafactor.Update` (a factored [128, 256]
  weight, the same weight stacked over 3 layers as a repeat stack keeps
  it, an unfactored [32, 4, 8] weight and a vector) and `Learner.Apply`
  (global-norm clip; a NaN gradient skips the step and rolls parameters
  and slots back) match the reference on the same numpy trees.
- `TransformerLm.FProp` (the loss and metrics) and the gradient of every
  theta leaf match `jax.value_and_grad` on the conftest `TinyLmParams`
  repeat stack with packed segments and padding, with the flash and fused
  xent switches on and off.
- Three `TrainStep`s of the DenseLm learner (warmup 2, so that theta
  moves) match the reference's `TrainStep`: metrics, grad_norm,
  learning_rate and every theta leaf within atol 1e-5, rtol 1e-4
  (float32: the per-op differences of the forward and backward pass the
  Adafactor update divides by sqrt(v), so they carry into theta at the
  gradients' relative precision, 1e-6 to 1e-5).
- remat 'full' and 'none' give the same gradients; 'dots' raises;
  `TrainProgram.Run` returns weighted means; a served step leaves the
  page pools out of autograd.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lingvo_tpu.core import attention as jax_attention
from lingvo_tpu.core import learner as jax_learner
from lingvo_tpu.core import optimizer as jax_optimizer
from lingvo_tpu.core import schedule as jax_schedule
from lingvo_tpu.models.lm import input_generator as jax_input
from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import attention
from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import learner
from lingvo_tpu_torch.core import optimizer
from lingvo_tpu_torch.core import ragged
from lingvo_tpu_torch.core import schedule
from lingvo_tpu_torch.core.nested_map import NestedMap
from lingvo_tpu_torch.models.lm import input_generator
from lingvo_tpu_torch.models.lm import layers as lm_layers
from lingvo_tpu_torch.runners import program

from tests.conftest import InstantiateLm, TinyLmParams

B, T = 2, 32


def _Learners(warmup_steps=2):
  """The DenseLm learner (synthetic_packed_input.py) on both sides."""
  kw = dict(learning_rate=3e-3, clip_gradient_norm_to_value=1.0)
  jax_p = jax_learner.Learner.Params().Set(
      optimizer=jax_optimizer.Adafactor.Params().Set(
          beta1=0.9, multiply_by_parameter_scale=False),
      lr_schedule=jax_schedule.LinearRampupCosineDecay.Params().Set(
          warmup_steps=warmup_steps, total_steps=100), **kw)
  port_p = learner.Learner.Params().Set(
      optimizer=optimizer.Adafactor.Params().Set(
          beta1=0.9, multiply_by_parameter_scale=False),
      lr_schedule=schedule.LinearRampupCosineDecay.Params().Set(
          warmup_steps=warmup_steps, total_steps=100), **kw)
  return jax_p, port_p


def _Lms(switches, seed=0, **port_overrides):
  """(jax task, jax theta as numpy, port task with the same weights)."""
  jax_lrn, port_lrn = _Learners()
  jax_p = TinyLmParams()
  port_p = lm_layers.TransformerLm.Params().Set(
      name=jax_p.name, vocab_size=jax_p.vocab_size,
      model_dim=jax_p.model_dim, num_layers=jax_p.num_layers,
      num_heads=jax_p.num_heads, hidden_dim=jax_p.hidden_dim,
      use_rotary=jax_p.use_rotary, use_repeat_layer=jax_p.use_repeat_layer)
  if switches:
    jax_p.atten_tpl = jax_attention.MultiHeadedAttention.Params().Set(
        use_flash_attention=True)
    port_p.atten_tpl = attention.MultiHeadedAttention.Params().Set(
        use_flash_attention=True)
    jax_p.xent_block_size = port_p.xent_block_size = 24   # ragged tail
  jax_p.train.learner = jax_lrn
  port_p.train.learner = port_lrn
  port_p.Set(**port_overrides)
  task, theta = InstantiateLm(jax_p, seed=seed)
  rng = np.random.RandomState(seed + 100)
  # perturb the zero-initialized leaves (norm scales, biases) so they matter
  theta = jax.tree_util.tree_map(
      lambda x: np.asarray(x) + 0.1 * rng.randn(*x.shape).astype(np.float32),
      theta)
  port = port_p.Instantiate(device="cpu")
  convert.LoadJaxTheta(port, theta)
  return task, theta, port


def _Batch(seed=0):
  """Packed rows: row 0 splits mid-block at 11 and ends in 5 padding
  tokens (segment 0); row 1 splits at 20."""
  rng = np.random.RandomState(seed)
  seg = np.zeros((B, T), np.int32)
  seg[0, :11], seg[0, 11:27] = 1, 2
  seg[1, :20], seg[1, 20:] = 1, 2
  return NestedMap(
      ids=rng.randint(1, 64, (B, T)).astype(np.int32),
      labels=rng.randint(1, 64, (B, T)).astype(np.int32),
      paddings=(seg == 0).astype(np.float32), segment_ids=seg)


def _ToJax(batch):
  from lingvo_tpu.core.nested_map import NestedMap as JaxNestedMap
  return JaxNestedMap({k: jnp.asarray(v) for k, v in batch.items()})


def _ToTorch(batch):
  return batch.Transform(torch.as_tensor)


def _Close(a, b, atol=2e-5, rtol=1e-5):
  np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                             rtol=rtol)


def test_synthetic_input_matches_reference():
  kw = dict(batch_size=3, seq_len=40, vocab_size=100, seed=5)
  jg = jax_input.SyntheticLmInput.Params().Set(**kw).Instantiate()
  tg = input_generator.SyntheticLmInput.Params().Set(**kw).Instantiate()
  for _ in range(3):
    jb, tb = jg.GetPreprocessedInputBatch(), tg.GetPreprocessedInputBatch()
    assert sorted(jb) == sorted(tb)
    for k in jb:
      assert jb[k].dtype == tb[k].dtype and jb[k].tobytes() == tb[k].tobytes()


def test_lr_schedule_matches_reference():
  kw = dict(warmup_steps=1000, total_steps=100000, min_ratio=0.1)
  js = jax_schedule.LinearRampupCosineDecay.Params().Set(
      name="s", **kw).Instantiate()
  ts = schedule.LinearRampupCosineDecay.Params().Set(**kw).Instantiate(
      device="cpu")
  for step in (0, 1, 2, 500, 999, 1000, 1001, 30000, 99999, 100000, 200000):
    assert float(ts.Value(step)) == float(js.Value(step)), step
  assert float(schedule.Constant.Params().Set(value=0.5).Instantiate(
      device="cpu").Value(3)) == 0.5


def _AdafactorCase(seed):
  rng = np.random.RandomState(seed)
  shapes = dict(f=(128, 256), s=(3, 128, 256), u=(32, 4, 8), vec=(7,))
  params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
  grads = [{k: rng.randn(*s).astype(np.float32) * 0.01
            for k, s in shapes.items()} for _ in range(3)]
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


@pytest.mark.parametrize("fields", [
    dict(beta1=0.9, multiply_by_parameter_scale=False),   # the DenseLm recipe
    dict()])                                               # the defaults
def test_adafactor_matches_reference(fields):
  params, grads = _AdafactorCase(0)
  jopt = jax_optimizer.Adafactor.Params().Set(name="o", **fields).Instantiate()
  topt = optimizer.Adafactor.Params().Set(**fields).Instantiate(device="cpu")
  from lingvo_tpu.core.nested_map import NestedMap as JaxNestedMap
  jp = JaxNestedMap({k: jnp.asarray(v) for k, v in params.items()})
  jstate = jopt.InitState(jp)
  tp = {k: _PortLeaf(k, v) for k, v in params.items()}
  tstate = topt.InitState(tp)
  first = {"m"} if fields.get("beta1") else set()
  assert set(tstate.slots["f"]) == set(tstate.slots["s"]) == {"vr", "vc"} | first
  assert set(tstate.slots["u"]) == set(tstate.slots["vec"]) == {"v"} | first
  for step, g in enumerate(grads):
    lr = 0.01 * (step + 1)
    jp, jstate = jopt.Update(
        jstate, JaxNestedMap({k: jnp.asarray(v) for k, v in g.items()}), jp,
        jnp.float32(lr), step)
    topt.Update(tstate, {k: _PortLeaf(k, v) for k, v in g.items()}, tp,
                torch.tensor(lr, dtype=torch.float32), step)
  for k in params:
    _Close(_LeafNumpy(tp[k]), jp[k], atol=1e-6, rtol=1e-5)
    for name, slot in jstate.slots[k].items():
      _Close(tstate.slots[k][name].numpy(), slot, atol=1e-6, rtol=1e-5)


def test_adafactor_factoring_rule_of_dense_lm_1b_shapes():
  """[2048, 16, 128] attention weights are not factored (16 < 128); the
  [2048, 8192] FFN and the [32000, 2048] table are, stacked or not."""
  topt = optimizer.Adafactor.Params().Instantiate(device="cpu")
  assert not topt._ShouldFactor((24, 2048, 16, 128))
  assert topt._ShouldFactor((24, 2048, 8192))
  assert topt._ShouldFactor((32000, 2048))
  assert not topt._ShouldFactor((24, 2048))


def test_learner_clips_and_skips_nan_with_rollback():
  jax_p, port_p = _Learners(warmup_steps=0)
  jl = jax_p.Copy().Set(name="lrn").Instantiate()
  tl = port_p.Instantiate(device="cpu")
  params, grads = _AdafactorCase(1)
  grads[0] = {k: v * 1000 for k, v in grads[0].items()}   # clipped to 1.0
  grads[1]["u"][0, 0, 0] = np.nan                          # skipped
  from lingvo_tpu.core.nested_map import NestedMap as JaxNestedMap
  jtheta = JaxNestedMap({k: jnp.asarray(v) for k, v in params.items()})
  jstate = jl.InitState(jtheta)
  tp = {k: _PortLeaf(k, v) for k, v in params.items()}
  tstate = tl.InitState(tp)
  for step, g in enumerate(grads):
    jtheta, jstate, jstats = jl.Apply(
        jtheta, JaxNestedMap({k: jnp.asarray(v) for k, v in g.items()}),
        step, jstate)
    before = {k: _LeafNumpy(v).copy() for k, v in tp.items()}
    tstats = tl.Apply(tp, {k: _PortLeaf(k, v) for k, v in g.items()}, step,
                      tstate)
    for name in ("grad_norm", "learning_rate", "grad_scale", "skipped_step"):
      if step == 1 and name == "grad_norm":
        assert not np.isfinite(float(tstats[name]))
        continue
      _Close(float(tstats[name]), float(jstats[name]), atol=0, rtol=1e-5)
    if step == 0:
      assert float(tstats.grad_scale) < 1.0     # the global-norm clip
    if step == 1:
      assert float(tstats.skipped_step) == 1.0
      for k, v in tp.items():
        np.testing.assert_array_equal(_LeafNumpy(v), before[k])
    for k in params:
      _Close(_LeafNumpy(tp[k]), jtheta[k], atol=1e-6, rtol=1e-5)


def _PortGrads(port):
  out = {}
  for k, leaf in port.ThetaTree().FlattenItems():
    members = optimizer.Members(leaf)
    g = [m.grad.numpy() for m in members]
    out[k] = np.stack(g) if isinstance(leaf, base_layer.StackedLeaf) else g[0]
  return out


@pytest.mark.parametrize("switches", [False, True])
def test_fprop_loss_and_grads_match_reference(switches):
  task, theta, port = _Lms(switches)
  batch = _Batch()

  def Loss(th):
    metrics, _ = task.FProp(th, _ToJax(batch))
    return metrics.loss[0], metrics

  (_, jm), jgrads = jax.jit(jax.value_and_grad(Loss, has_aux=True))(
      jax.tree_util.tree_map(jnp.asarray, theta))
  tm, _ = port.FProp(_ToTorch(batch))
  tm.loss[0].backward()
  for k in ("loss", "log_pplx", "fraction_of_correct_next_step_preds",
            "num_predictions"):
    for i in (0, 1):
      _Close(float(torch.as_tensor(tm[k][i]).detach()), float(jm[k][i]),
             atol=1e-5)
  tgrads = _PortGrads(port)
  jflat = dict(jgrads.FlattenItems())
  assert sorted(tgrads) == sorted(jflat)
  for k, g in tgrads.items():
    _Close(g, jflat[k], atol=2e-5, rtol=1e-4)


def test_train_steps_match_reference():
  task, theta, port = _Lms(True, seed=1)
  jstate = task.CreateTrainState(jax.random.PRNGKey(0))
  jstate.theta = jax.tree_util.tree_map(jnp.asarray, theta)
  jstate.opt_states = [task.learners[0].InitState(jstate.theta)]
  step_fn = jax.jit(task.TrainStep)
  tstate = port.CreateTrainState()
  for i in range(3):
    batch = _Batch(seed=10 + i)
    jstate, jout = step_fn(jstate, _ToJax(batch))
    tout = port.TrainStep(tstate, _ToTorch(batch))
    for k in ("loss", "fraction_of_correct_next_step_preds"):
      _Close(float(tout.metrics[k][0]), float(jout.metrics[k][0]), atol=1e-5)
    for k in ("grad_norm", "learning_rate", "skipped_step"):
      _Close(float(tout.stats[k]), float(jout.stats[k]), atol=1e-5,
             rtol=1e-5)
  assert tstate.step == int(jstate.step) == 3
  assert float(jout.stats.learning_rate) > 0   # theta moved on steps 1, 2
  tnp = convert.ThetaToNumpy(port)
  jflat = dict(jstate.theta.FlattenItems())
  moved = max(float(np.abs(np.asarray(jflat[k]) - np.asarray(v)).max())
              for k, v in dict(theta.FlattenItems()).items())
  assert moved > 1e-3
  for k, v in tnp.FlattenItems():
    _Close(v, jflat[k], atol=1e-5, rtol=1e-4)


def test_remat_full_and_none_give_the_same_grads():
  grads = []
  for policy in ("full", "none"):
    _, _, port = _Lms(True, remat_policy=policy)
    metrics, _ = port.FProp(_ToTorch(_Batch()))
    metrics.loss[0].backward()
    grads.append(_PortGrads(port))
  for k in grads[0]:
    np.testing.assert_allclose(grads[0][k], grads[1][k], atol=1e-6, rtol=0)


def test_remat_dots_raises_naming_a_later_slice():
  _, _, port = _Lms(False, remat_policy="dots")
  with pytest.raises(NotImplementedError, match="later training slice"):
    port.FProp(_ToTorch(_Batch()))


def test_train_program_returns_weighted_means():
  _, _, port = _Lms(True)
  gen = input_generator.SyntheticLmInput.Params().Set(
      batch_size=2, seq_len=32, vocab_size=64).Instantiate()
  ref_gen = input_generator.SyntheticLmInput.Params().Set(
      batch_size=2, seq_len=32, vocab_size=64).Instantiate()
  # the same steps on a copy of the task, metrics read step by step
  _, _, twin = _Lms(True)
  twin_state = twin.CreateTrainState()
  per_step = [twin.TrainStep(twin_state, ref_gen.GetPreprocessedInputBatch()
                             .Transform(torch.as_tensor)) for _ in range(3)]
  prog = program.TrainProgram(
      program.TrainProgram.Params().Set(steps_per_loop=3), task=port,
      input_generator=gen)
  state, result = prog.Run(port.CreateTrainState())
  assert state.step == 3
  vals = [float(o.metrics.loss[0]) for o in per_step]
  wts = [float(o.metrics.loss[1]) for o in per_step]
  _Close(result["loss"], np.dot(vals, wts) / np.sum(wts), atol=1e-6)
  _Close(result["grad_norm"],
         np.mean([float(o.stats.grad_norm) for o in per_step]), atol=1e-6)
  assert result["num_predictions"] == 64.0
  assert result["steps_per_second"] > 0


def test_parameters_train_but_served_pools_stay_out_of_autograd():
  _, _, port = _Lms(False)
  assert all(p.requires_grad for p in port.parameters())
  states = port.InitPagedDecodeState(9, 8)
  rows = ragged.ToTorch(ragged.BuildRaggedRows([3, 1], [0, 5], 4, 3), "cpu")
  logits, states = port.RaggedStep(
      torch.tensor([[1, 2, 3, 4]], dtype=torch.int32), states,
      torch.tensor([[0, 1], [2, 3]], dtype=torch.int32), rows)
  assert not logits.requires_grad
  assert not any(x.requires_grad for x in states.Flatten())
