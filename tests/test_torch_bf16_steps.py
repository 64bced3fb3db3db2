"""Three mixed-precision TrainSteps of the tiny LM against the JAX reference on the CPU.

The DenseLm learner (Adafactor, warmup 2) with the flash and fused-xent
switches on, at fprop_dtype bfloat16 (weights and slots float32), op by
op on the reference side. The rank-1 leaves stay frozen on both sides
(`bprop_variable_exclusion`): their gradients are sums over tokens that
the reference takes in bfloat16 in XLA's own order (see
`test_torch_bf16_train.py`), and Adafactor, which divides by the root
of the second moment, turns that rounding noise into full-size updates.
The weight matrices, whose gradients agree bit for bit at the first
step, train.

- Steps 1 and 2: loss and grad_norm within 5e-5; the control (the port
  at float32) must miss each by 10x.
- Step 3: loss within 1e-3 (by then bf16 roundings that a float32 ulp of
  the master weights moved have spread; no control).
- Theta after three steps: the relative error of the update,
  ||theta_port - theta_jax|| / ||theta_jax - theta_0|| over every leaf,
  within 1e-2; the control must miss by 10x.

The vector leaves train in a second run, against the reference's own
learner applied to gradients whose vector leaves are the reference's
per-token cotangents summed in float32 (`RankOneReference`, the port's
order); its bars are in its test.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from lingvo_tpu_torch import convert

from tests import test_torch_train as tt
from tests.test_torch_bf16_train import BF16Lms, RankOneReference, VECTOR_LEAF


def _Steps(port_fprop):
  learners = tt._Learners

  def Frozen(warmup_steps=2):
    return tuple(p.Set(bprop_variable_exclusion=VECTOR_LEAF)
                 for p in learners(warmup_steps))

  tt._Learners = Frozen
  try:
    task, theta, port = BF16Lms(True, seed=1, port_fprop=port_fprop)
  finally:
    tt._Learners = learners
  jstate = task.CreateTrainState(jax.random.PRNGKey(0))
  jstate.theta = jax.tree_util.tree_map(jnp.asarray, theta)
  jstate.opt_states = [task.learners[0].InitState(
      task._TrainableSubset(jstate.theta, task.learners[0]))]
  tstate = port.CreateTrainState()
  diffs = []
  for i in range(3):
    batch = tt._Batch(seed=10 + i)
    with jax.disable_jit():
      jstate, jout = task.TrainStep(jstate, tt._ToJax(batch))
    tout = port.TrainStep(tstate, tt._ToTorch(batch))
    diffs.append((abs(float(tout.metrics.loss[0]) - float(jout.metrics.loss[0])),
                  abs(float(tout.stats.grad_norm) - float(jout.stats.grad_norm))))
  start = {k: np.asarray(v) for k, v in theta.FlattenItems()}
  final = {k: np.asarray(v) for k, v in jstate.theta.FlattenItems()}
  got = dict(convert.ThetaToNumpy(port).FlattenItems())
  err = np.sqrt(sum(np.sum((got[k] - final[k]) ** 2) for k in final))
  moved = np.sqrt(sum(np.sum((final[k] - start[k]) ** 2) for k in final))
  return diffs, err / moved


def test_bf16_train_steps_match_reference():
  diffs, theta_err = _Steps(torch.bfloat16)
  ctl_diffs, ctl_err = _Steps(None)
  for step in (0, 1):
    for got, ctl in zip(diffs[step], ctl_diffs[step]):
      assert got <= 5e-5 and ctl >= 5e-4, (step, got, ctl)
  assert diffs[2][0] <= 1e-3
  assert theta_err <= 1e-2 and ctl_err >= 1e-1, (theta_err, ctl_err)


def _StepsTrainingEveryLeaf(port_fprop):
  """Three steps with the vector leaves trained, against the reference's
  learner applied to `RankOneReference` gradients (the vector leaves'
  per-token bf16 cotangents summed in float32)."""
  task, theta, port = BF16Lms(True, seed=1, port_fprop=port_fprop)
  lrn = task.learners[0]
  jtheta = jax.tree_util.tree_map(jnp.asarray, theta)
  opt = lrn.InitState(task._TrainableSubset(jtheta, lrn))
  tstate = port.CreateTrainState()
  start = {k: np.asarray(v) for k, v in theta.FlattenItems()}
  diffs = []
  for i in range(3):
    batch = tt._Batch(seed=10 + i)
    loss, grads = RankOneReference(task, jtheta, batch)
    trainable = task._TrainableSubset(jtheta, lrn)
    jgrads = trainable.Pack([jnp.asarray(grads[k])
                             for k, _ in trainable.FlattenItems()])
    with jax.disable_jit():
      new, opt, stats = lrn.Apply(trainable, jgrads, jnp.asarray(i, jnp.int32),
                                  opt)
    jtheta = task._MergeSubset(jtheta, new)
    tout = port.TrainStep(tstate, tt._ToTorch(batch))
    final = {k: np.asarray(v) for k, v in jtheta.FlattenItems()}
    got = dict(convert.ThetaToNumpy(port).FlattenItems())
    err = np.sqrt(sum(np.sum((got[k] - final[k]) ** 2) for k in final))
    moved = np.sqrt(sum(np.sum((final[k] - start[k]) ** 2) for k in final))
    diffs.append((abs(float(tout.metrics.loss[0]) - loss),
                  abs(float(tout.stats.grad_norm) - float(stats.grad_norm)),
                  err / max(moved, 1e-30)))
  return diffs


def test_bf16_train_steps_with_vector_leaves_match_float32_sums():
  """Every leaf trains (vector leaves included, as DenseLm1B trains them)
  against the reference's learner on `RankOneReference` gradients. Steps
  1 and 2: loss and grad_norm within 5e-5, the relative update error
  after step 2 within 1e-2; the control (the port at float32) must miss
  each by 10x. Step 3: loss within 1e-3 and the update within 2e-2, with
  no 10x control (as above, by then bf16 roundings that float32 ulps of
  the master weights moved have spread, and Adafactor scales each vector
  element's update by its own second moment)."""
  diffs = _StepsTrainingEveryLeaf(torch.bfloat16)
  ctl = _StepsTrainingEveryLeaf(None)
  for step in (0, 1):
    for got, miss in zip(diffs[step][:2], ctl[step][:2]):
      assert got <= 5e-5 and miss >= 5e-4, (step, got, miss)
  assert diffs[1][2] <= 1e-2 and ctl[1][2] >= 1e-1, (diffs[1], ctl[1])
  assert diffs[2][0] <= 1e-3 and diffs[2][2] <= 2e-2, diffs[2]
