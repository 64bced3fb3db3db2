"""BaseTask and BaseModel: the trainable unit and its container (port of lingvo_tpu/core/base_model.py).

A task splits into `ComputePredictions` / `ComputeLoss`, returning a
metrics NestedMap of (value, weight) pairs, as in the reference. The
reference's `TrainStep(state) -> new_state` is pure; here the parameters
are the module's own and `TrainStep` updates them and the optimizer slots
IN PLACE: the gradient comes from `loss.backward()`, the learner applies
it under `torch.no_grad()`, and `state` carries the step counter and the
optimizer state.

`TrainStep` runs the forward under the step's seed, as the reference:
the key fold_in(base_step_key, step) (base_step_key PRNGKey(0) unless
the caller gives one; `TrainProgram` gives PRNGKey(base_step_seed)) in
`py_utils.StepSeedContext`, with `GlobalStepContext(step)`; dropout and
the sampled softmax draw from it. The learner's regularization loss is
added to the loss it differentiates. `backward()` runs after those
contexts have been left, so a rematerialized layer must carry the seeds
it saw into its recompute (`transformer.RepeatedTransformerLayer`).
`EvalStep` is the eval-mode FProp (`EvalContext`, no step seed) under
`torch.no_grad()`, and
`VariableSpecs()` lists the weights' shapes under the reference's theta
paths (a repeat stack's leaves with their leading [num_layers] axis), as
`model_analysis.txt` and `--mode=inspect_model` print them.

`train.learner` may be a list: each learner then runs its own forward and
backward over its `TrainableFilter` subset, in list order, all under the
step's key (so they draw the same dropout masks), the second forward
seeing the first learner's update; the metrics returned are the last
learner's, and with more than one learner each stat is prefixed
`{learner name}_`. `state.opt_states` holds one entry per learner. A
learner's backward differentiates only its own subset: the other
parameters are taken out of autograd for its pass.

With `train.ema_decay > 0` the state also keeps `ema_theta`, {theta
path: float32 tensor} (a repeat stack's leaf stacked on its leading
axis), updated after every learner has applied:
ema = ema * d + theta * (1 - d), d = min(ema_decay, (1 + step) /
(10 + step)) from the step before the increment, a float32 host scalar.
Every leaf is smoothed: `ema_decay_moving_vars=False`, the reference's
mask for non-trainable variables, raises, as the port has none.
`EmaThetaActive(state)` makes the parameters hold those values for an
eval and gives theta back bit for bit.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import hyperparams
from lingvo_tpu_torch.core import learner as learner_lib
from lingvo_tpu_torch.core import optimizer as optimizer_lib
from lingvo_tpu_torch.core import py_utils
from lingvo_tpu_torch.core import threefry
from lingvo_tpu_torch.core.nested_map import NestedMap


class BaseTask(base_layer.BaseLayer):
  """A trainable task: model graph + loss."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("input", None, "Input generator params for this task.")
    tp = hyperparams.Params()
    tp.Define("learner", learner_lib.Learner.Params(),
              "Learner (or list of Learners, e.g. GAN or distillation).")
    tp.Define("ema_decay", 0.0, "If >0, keep an EMA copy of theta.")
    tp.Define("ema_decay_moving_vars", True,
              "Whether EMA also covers non-trainable vars. False (those "
              "vars track theta) raises: the port has no non-trainable "
              "variables (batch-norm moving statistics) for it to act on.")
    tp.Define("max_steps", 4_000_000, "Training halts after this step.")
    tp.Define("tpu_steps_per_loop", 100, "Device steps per host loop.")
    tp.Define("save_interval_steps", 1000, "Checkpoint every N steps.")
    tp.Define("save_max_to_keep", 10, "Checkpoints kept by GC.")
    tp.Define("early_stop_window", 0,
              "Stop after this many steps without eval-loss improvement "
              "(0 = disabled; core/early_stop.py).")
    tp.Define("early_stop_tolerance", 0.0, "Improvement margin.")
    tp.Define("early_stop_metric", "loss", "Eval metric to watch.")
    tp.Define("early_stop_program", "eval_test",
              "Which eval program's results feed the plateau detector.")
    tp.Define("init_from_checkpoint_rules", {},
              "Warm start: {ckpt_train_dir: [(target_var_regex, "
              "source_var_template), ...]}, applied only when the run's own "
              "train dir has no checkpoint "
              "(checkpointer.ApplyInitFromCheckpointRules).")
    tp.Define("init_from_npz", "",
              "Warm start from an npz of reference-layout arrays keyed by "
              "the reference's theta paths; applied on a fresh run like "
              "init_from_checkpoint_rules (checkpointer.ImportNpzCheckpoint).")
    tp.Define("init_from_npz_rules", None,
              "Optional [(target_regex, source_template)] name mapping for "
              "init_from_npz (None = npz keys are the theta paths).")
    tp.Define("pruning", None,
              "Optional core.pruning.PruningSchedule params: magnitude "
              "masks recomputed at the schedule's cadence and re-applied to "
              "theta and ema_theta after every program run (the "
              "executor's _MaybePrune).")
    p.Define("train", tp, "Training hyperparams.")
    ep = hyperparams.Params()
    ep.Define("samples_per_summary", 1000, "Max eval examples per run.")
    p.Define("eval", ep, "Eval hyperparams.")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    if self.p.train.ema_decay > 0 and not self.p.train.ema_decay_moving_vars:
      raise NotImplementedError(
          "train.ema_decay_moving_vars=False leaves the non-trainable "
          "variables out of the EMA; the port has none yet (batch-norm "
          "moving statistics are not ported), so the mask comes with them")
    lp = self.p.train.learner
    self._learner_params = (list(lp) if isinstance(lp, (list, tuple))
                            else [lp])

  def Learners(self):
    """The learners, built on first use: serving never needs one."""
    if "learners" not in self._modules:
      self.CreateChildren("learners", self._learner_params)
    return self.learners

  @property
  def learner(self) -> learner_lib.Learner:
    """The first learner."""
    return self.Learners()[0]

  # ---- subclass points -------------------------------------------------------

  def ComputePredictions(self, input_batch: NestedMap) -> NestedMap:
    raise NotImplementedError

  def ComputeLoss(self, predictions: NestedMap,
                  input_batch: NestedMap) -> tuple[NestedMap, NestedMap]:
    """(metrics NestedMap of (value, weight), per_example NestedMap);
    metrics holds the learner's loss_name entry ('loss' by default)."""
    raise NotImplementedError

  def FProp(self, input_batch: NestedMap) -> tuple[NestedMap, NestedMap]:
    predictions = self.ComputePredictions(input_batch)
    return self.ComputeLoss(predictions, input_batch)

  def EvalStep(self, input_batch: NestedMap) -> tuple[NestedMap, NestedMap]:
    """One eval step: the eval-mode FProp, without gradients. Returns
    (metrics, per_example), every value detached."""
    with torch.no_grad(), py_utils.EvalContext():
      return self.FProp(input_batch)

  def VariableSpecs(self) -> NestedMap:
    """The weights' shapes under the reference's theta paths: a NestedMap
    of objects with `.shape`, a repeat stack's leaves [num_layers, ...]."""
    return self.ThetaTree().Transform(
        lambda leaf: _Spec(tuple(leaf.shape)))

  # ---- train state -------------------------------------------------------------

  def TrainableTheta(self, lrn=None) -> dict:
    """{theta path: parameter or StackedLeaf} that `lrn` (default: the
    first learner) trains."""
    lrn = self.learner if lrn is None else lrn
    return {k: v for k, v in self.ThetaTree().FlattenItems()
            if lrn.TrainableFilter(k)}

  def CreateTrainState(self, generator: torch.Generator | None = None
                       ) -> NestedMap:
    """NestedMap(step=0, opt_states=[slots per learner], ema_theta=... if
    train.ema_decay > 0): the step counter, the optimizer states and the
    EMA of the weights the module holds now. With a generator, initializes
    the weights from it first."""
    if generator is not None:
      self.InstantiateVariables(generator)
    state = NestedMap(step=0, opt_states=[
        lrn.InitState(self.TrainableTheta(lrn)) for lrn in self.Learners()])
    if self.p.train.ema_decay > 0:
      with torch.no_grad():
        state.ema_theta = {
            k: torch.stack([m.detach().clone()
                            for m in optimizer_lib.Members(leaf)])
            if isinstance(leaf, base_layer.StackedLeaf)
            else leaf.detach().clone()
            for k, leaf in self.ThetaTree().FlattenItems()}
    return state

  def _LearnerPass(self, lrn, state, i, input_batch, step_key):
    """One learner's forward, backward and Apply over its own subset.
    Returns (metrics, per_example, stats)."""
    params = self.TrainableTheta(lrn)
    mine = {id(m) for leaf in params.values()
            for m in optimizer_lib.Members(leaf)}
    for prm in self.parameters():
      prm.grad = None
      prm.requires_grad_(id(prm) in mine)
    with torch.enable_grad():
      with py_utils.StepSeedContext(step_key), \
          py_utils.GlobalStepContext(state.step):
        metrics, per_example = self.FProp(input_batch)
      loss = metrics[lrn.p.loss_name][0].float()
      if mine:
        (loss + lrn.RegularizationLoss(params)).backward()
    grads = {}
    for key, leaf in params.items():
      members = [m.grad if m.grad is not None else torch.zeros_like(m)
                 for m in optimizer_lib.Members(leaf)]
      grads[key] = (base_layer.StackedLeaf(tuple(members))
                    if isinstance(leaf, base_layer.StackedLeaf) else
                    members[0])
    stats = lrn.Apply(params, grads, state.step, state.opt_states[i])
    return metrics, per_example, stats

  def TrainStep(self, state: NestedMap, input_batch: NestedMap,
                base_step_key=None) -> NestedMap:
    """One training step, IN PLACE: the parameters, state.opt_states and
    state.ema_theta are updated and state.step advances by one.
    base_step_key: the threefry key the step's seed folds the step into
    (PRNGKey(0) if None). Returns NestedMap(metrics, stats, per_example),
    every value detached."""
    if self._path is None:
      self.FinalizePaths()   # the seeds are functions of the layer paths
    step_key = threefry.FoldIn(
        threefry.PRNGKey(0) if base_step_key is None else base_step_key,
        state.step)
    learners = self.Learners()
    all_stats = NestedMap()
    try:
      for i, lrn in enumerate(learners):
        metrics, per_example, stats = self._LearnerPass(
            lrn, state, i, input_batch, step_key)
        prefix = f"{lrn.p.name}_" if len(learners) > 1 else ""
        for k, v in stats.FlattenItems():
          all_stats[f"{prefix}{k}"] = v
    finally:
      for prm in self.parameters():
        prm.grad = None
        prm.requires_grad_(True)
    if "ema_theta" in state:
      self._UpdateEma(state)
    state.step += 1
    detach = lambda x: x.detach() if isinstance(x, torch.Tensor) else x
    return NestedMap(metrics=metrics.Transform(detach), stats=all_stats,
                     per_example=per_example.Transform(detach))

  @torch.no_grad()
  def _UpdateEma(self, state: NestedMap) -> None:
    """ema = ema * d + theta * (1 - d), d = min(ema_decay, (1 + step) /
    (10 + step)) in float32 from the pre-increment step. Every leaf, a
    frozen one's too (a leaf that does not move still moves its EMA by
    rounding)."""
    s = torch.tensor(np.float32(state.step))
    decay = torch.minimum(torch.tensor(np.float32(self.p.train.ema_decay)),
                          (1.0 + s) / (10.0 + s))
    rest = 1.0 - decay
    for k, leaf in self.ThetaTree().FlattenItems():
      ema = state.ema_theta[k]
      stacked = isinstance(leaf, base_layer.StackedLeaf)
      for i, t in enumerate(optimizer_lib.Members(leaf)):
        e = ema[i] if stacked else ema
        e.copy_(e * decay + t.to(e.dtype) * rest)

  @contextlib.contextmanager
  def EmaThetaActive(self, state: NestedMap):
    """Inside, every parameter holds its `state.ema_theta` value (its
    storage is swapped, nothing is copied); on exit theta is given back
    bit for bit. Without an EMA in the state, theta stays as it is."""
    swaps = []
    if "ema_theta" in state:
      for k, leaf in self.ThetaTree().FlattenItems():
        ema = state.ema_theta[k]
        stacked = isinstance(leaf, base_layer.StackedLeaf)
        for i, prm in enumerate(optimizer_lib.Members(leaf)):
          swaps.append((prm, prm.data))
          prm.data = ema[i] if stacked else ema
    try:
      yield
    finally:
      for prm, data in swaps:
        prm.data = data


class _Spec:
  """A weight's shape, as the reference's WeightParams carries it."""

  def __init__(self, shape: tuple):
    self.shape = shape


class BaseModel(base_layer.BaseLayer):
  """Container of one or more tasks (ref base_model.py:276)."""

  def GetTask(self, task_name: str | None = None) -> BaseTask:
    raise NotImplementedError

  @property
  def tasks(self) -> list[BaseTask]:
    raise NotImplementedError


class SingleTaskModel(BaseModel):
  """Model with exactly one task (ref base_model.py:296)."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("task", None, "The task params.")
    p.Define("input", None, "Input params (attached by the registry).")
    return p

  def __init__(self, params, device=None):
    if params.task is not None and params.input is not None:
      if params.task.input is None:
        params = params.Copy()
        params.task.input = params.input
    super().__init__(params, device)
    self.CreateChild("task", self.p.task)

  def GetTask(self, task_name: str | None = None) -> BaseTask:
    return self.task

  @property
  def tasks(self):
    return [self.task]


class MultiTaskModel(BaseModel):
  """Model with several named tasks sampled by a schedule (ref
  base_model.py:321): one child `task_{name}` per entry of task_params,
  or per entry of `tasks`, task instances built already. It is the
  module that `MultiTaskProgramSchedule` checkpoints."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("task_params", None,
             "Params with one sub-Params per task name.")
    p.Define("task_probs", None,
             "Params with one float per task name (sampling weights).")
    return p

  def __init__(self, params, device=None, tasks: dict | None = None):
    super().__init__(params, device)
    if tasks is None:
      for name, task_p in self.p.task_params.IterParams():
        self.CreateChild(f"task_{name}", task_p)
      self._task_names = sorted(k for k, _ in self.p.task_params.IterParams())
    else:
      for name, task in tasks.items():
        self.add_module(f"task_{name}", task)
      self._task_names = sorted(tasks)

  @property
  def task_names(self):
    return list(self._task_names)

  def GetTask(self, task_name: str | None = None) -> BaseTask:
    if task_name is None:
      task_name = self._task_names[0]
    return self._modules[f"task_{task_name}"]

  @property
  def tasks(self):
    return [self.GetTask(n) for n in self._task_names]
