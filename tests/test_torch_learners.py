"""Multiple learners and DistillationTask against the JAX reference on the CPU.

- A tiny LM (residual dropout 0.1, a repeat stack) with two learners
  split by `bprop_variable_filter` (Adam over the embedding and the norms,
  DistributedShampoo over the rest but the key biases, whose exact
  gradient is zero; the stacked weights take Shampoo's diagonal
  fallback, the stacked vectors are preconditioned [L, n] matrices, as
  in the reference) takes 3 `TrainStep`s beside the jitted reference's
  `TrainStep` under one base key: every prefixed stat of each learner
  (`{name}_grad_norm`, ...), the metrics (the last learner's) and the
  final theta within atol 1e-5, rtol 1e-4 (the tolerance of
  tests/test_torch_train.py's steps), and both learners' states through
  `convert.TrainStatePairs` (Shampoo's roots of the rank-deficient
  statistics of stacked vectors within 1e-3 of their largest entry:
  ROADMAP §3). The second learner's forward sees the first
  learner's update, and both draw the step's dropout masks.
- A state with two learners' entries round-trips through the
  checkpointer; restoring it into a one-learner state is refused.
- `DistillationTask` (a 2-layer teacher, a 1-layer student, temperature
  2): the losses (`loss`, `hard_loss`, `distill_loss`) within 1e-5 and
  the student's gradients within atol 1e-6, rtol 1e-4 against
  `jax.value_and_grad` of the reference's FProp (the teacher gets no
  gradient); two TrainSteps with two learners (Adam over the student's
  embedding, Momentum over the rest) leave the teacher's theta
  bitwise unchanged and match the reference's theta; a learner that
  already sets an exclusion is refused.
"""

import numpy as np
import pytest

import jax
import torch

from lingvo_tpu.core import distillation_task as jax_distillation
from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import checkpointer
from lingvo_tpu_torch.core import distillation_task
from lingvo_tpu_torch.core import threefry

from tests import torch_train_helpers as h

EMB_AND_NORMS = r"^emb\.|\bln\.|^final_ln\."
# the key biases' exact gradient is zero (the softmax is shift-invariant),
# so their float32 gradients are rounding noise, which a diagonal AdaGrad
# step normalizes to up to lr: neither learner trains them
NOISE_ONLY = r"\.b_key$"


def _TwoLearners(pkg):
  adam = pkg.learner.Learner.Params().Set(
      name="emb_lrn", learning_rate=0.01,
      bprop_variable_filter=EMB_AND_NORMS,
      optimizer=pkg.optimizer.Adam.Params().Set(beta2=0.98))
  rest = pkg.learner.Learner.Params().Set(
      name="rest_lrn", learning_rate=0.01,
      bprop_variable_exclusion=f"{EMB_AND_NORMS}|{NOISE_ONLY}",
      clip_gradient_norm_to_value=1.0,
      optimizer=pkg.optimizer.DistributedShampoo.Params().Set(
          block_size=64, statistics_compute_steps=2))
  return [adam, rest]


def _Pair(pkg):
  p = h.TinyLm(pkg, residual_dropout_prob=0.1)
  p.train.learner = _TwoLearners(pkg)
  return p


def test_two_learners_match_reference_over_three_steps():
  task, theta, port = h.Instantiate(_Pair(h.JAX), _Pair(h.PORT))
  jstate = task.CreateTrainState(jax.random.PRNGKey(0))
  jstate.theta = jax.tree_util.tree_map(jax.numpy.asarray, theta)
  jstate.opt_states = [lrn.InitState(task._TrainableSubset(jstate.theta, lrn))
                       for lrn in task.learners]
  step_fn = jax.jit(task.TrainStep)
  tstate = port.CreateTrainState()
  assert len(tstate.opt_states) == 2
  for i in range(3):
    batch = h.Batch(seed=10 + i)
    jstate, jout = step_fn(jstate, h.ToJax(batch), jax.random.PRNGKey(1234))
    tout = port.TrainStep(tstate, h.ToTorch(batch), threefry.PRNGKey(1234))
    assert sorted(tout.stats) == sorted(jout.stats)
    assert "emb_lrn_grad_norm" in tout.stats
    for k in tout.stats:
      np.testing.assert_allclose(float(tout.stats[k]), float(jout.stats[k]),
                                 atol=1e-5, rtol=1e-5, err_msg=k)
    for k in ("loss", "fraction_of_correct_next_step_preds"):
      np.testing.assert_allclose(float(tout.metrics[k][0]),
                                 float(jout.metrics[k][0]), atol=1e-5)
  assert tstate.step == int(jstate.step) == 3
  h.CheckTheta(port, jstate.theta, atol=1e-5, rtol=1e-4)
  pairs = convert.TrainStatePairs(tstate, h.Numpy(jstate))
  assert len(pairs) == len(jax.tree_util.tree_leaves(jstate.opt_states))
  for name, t, a in pairs:
    if ".root_" in name:
      # the [L, n] stacked vectors' R = G^T G has rank L: its null-space
      # roots are eigh rounding (ROADMAP §3), held to 1e-3 of the largest
      err = np.abs(t.numpy() - a).max() / max(np.abs(a).max(), 1e-30)
      assert err < 1e-3, (name, err)
    else:
      np.testing.assert_allclose(t.numpy(), a, atol=1e-5, rtol=1e-4,
                                 err_msg=name)


def test_checkpoint_keeps_one_state_per_learner(tmp_path):
  _, _, port = h.Instantiate(_Pair(h.JAX), _Pair(h.PORT))
  state = port.CreateTrainState()
  port.TrainStep(state, h.ToTorch(h.Batch()))
  ckpt = checkpointer.Checkpointer(str(tmp_path))
  ckpt.Save(1, port, state, force=True)
  fresh = port.CreateTrainState()
  restored, step = ckpt.Restore(port, state=fresh)
  assert step == 1 and restored.step == 1
  saved = dict(checkpointer._OptItems(state))
  for k, v in checkpointer._OptItems(restored):
    assert torch.equal(v, saved[k]), k
  one_p = h.TinyLm(h.PORT, residual_dropout_prob=0.1)
  one_p.train.learner = _TwoLearners(h.PORT)[:1]
  one = one_p.Instantiate(device="cpu")
  with pytest.raises(ValueError, match="structure differs"):
    ckpt.Restore(one, state=one.CreateTrainState())


def _Distill(pkg, learners=None):
  cls = (jax_distillation if pkg is h.JAX else distillation_task)
  p = cls.DistillationTask.Params().Set(
      name="distill", teacher=h.TinyLm(pkg, name="teacher"),
      student=h.TinyLm(pkg, name="student", num_layers=1),
      distill_weight=0.3, temperature=2.0)
  if learners is not None:
    p.train.learner = learners
  return p


def test_distillation_losses_and_student_grads_match_reference():
  task, theta, port = h.Instantiate(_Distill(h.JAX), _Distill(h.PORT))
  batch = h.Batch(seed=4)

  def Loss(student, teacher):
    full = dict(theta)
    full = type(theta)(teacher=teacher, student=student)
    metrics, _ = task.FProp(full, h.ToJax(batch))
    return metrics.loss[0], metrics

  (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(Loss, has_aux=True))(
      theta["student"], theta["teacher"])
  metrics, _ = port.FProp(h.ToTorch(batch))
  for k in ("loss", "hard_loss", "distill_loss"):
    np.testing.assert_allclose(float(metrics[k][0].detach()),
                               float(jmetrics[k][0]),
                               atol=1e-5, rtol=1e-5, err_msg=k)
  metrics.loss[0].backward()
  for prm in port.teacher.parameters():
    assert prm.grad is None
  want = dict(type(theta)(student=jgrads).FlattenItems())
  for k, leaf in port.ThetaTree().FlattenItems():
    if not k.startswith("student."):
      continue
    g = (np.stack([m.grad.numpy() for m in leaf.layers])
         if hasattr(leaf, "layers") else leaf.grad.numpy())
    np.testing.assert_allclose(g, np.asarray(want[k]), atol=1e-6, rtol=1e-4,
                               err_msg=k)


def test_distillation_train_steps_keep_the_teacher_and_match_reference():
  def Learners(pkg):
    return [pkg.learner.Learner.Params().Set(
                name="emb", learning_rate=0.01,
                bprop_variable_filter=r"^student\.emb\."),
            pkg.learner.Learner.Params().Set(
                name="rest", learning_rate=0.01,
                bprop_variable_filter=r"^student\.(?!emb\.)",
                optimizer=pkg.optimizer.Momentum.Params())]
  task, theta, port = h.Instantiate(_Distill(h.JAX, Learners(h.JAX)),
                                    _Distill(h.PORT, Learners(h.PORT)))
  for lrn in port.Learners():
    assert lrn.p.bprop_variable_exclusion == r"^teacher\."
  teacher = {k: v.clone() for k, v in port.teacher.state_dict().items()}
  jstate = task.CreateTrainState(jax.random.PRNGKey(0))
  jstate.theta = jax.tree_util.tree_map(jax.numpy.asarray, theta)
  jstate.opt_states = [lrn.InitState(task._TrainableSubset(jstate.theta, lrn))
                       for lrn in task.learners]
  step_fn = jax.jit(task.TrainStep)
  tstate = port.CreateTrainState()
  for i in range(2):
    batch = h.Batch(seed=20 + i)
    jstate, jout = step_fn(jstate, h.ToJax(batch))
    tout = port.TrainStep(tstate, h.ToTorch(batch))
    for k in ("loss", "hard_loss", "distill_loss"):
      np.testing.assert_allclose(float(tout.metrics[k][0]),
                                 float(jout.metrics[k][0]), atol=1e-5,
                                 err_msg=k)
  for k, v in port.teacher.state_dict().items():
    assert torch.equal(v, teacher[k]), k
  h.CheckTheta(port, jstate.theta, atol=1e-5, rtol=1e-4)


def test_distillation_refuses_a_learner_with_its_own_exclusion():
  p = _Distill(h.PORT)
  p.train.learner.bprop_variable_exclusion = "x"
  with pytest.raises(AssertionError, match="bprop_variable_exclusion"):
    p.Instantiate(device="cpu")
