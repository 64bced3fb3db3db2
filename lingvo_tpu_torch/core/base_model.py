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

One learner per task; the EMA of theta and multiple learners (GANs) raise
NotImplementedError until a later slice ports them.
"""

from __future__ import annotations

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
              "The Learner (a list of several is not ported).")
    tp.Define("ema_decay", 0.0, "If >0, keep an EMA copy of theta (not "
              "ported: raises).")
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
              "Magnitude pruning schedule (not ported: the executor raises "
              "when it is set).")
    p.Define("train", tp, "Training hyperparams.")
    ep = hyperparams.Params()
    ep.Define("samples_per_summary", 1000, "Max eval examples per run.")
    p.Define("eval", ep, "Eval hyperparams.")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    tp = self.p.train
    lp = tp.learner
    if isinstance(lp, (list, tuple)):
      if len(lp) != 1:
        raise NotImplementedError(
            "multiple learners come with a later training slice")
      lp = lp[0]
    if tp.ema_decay > 0:
      raise NotImplementedError(
          "the EMA of theta comes with a later training slice")
    self._learner_params = lp

  @property
  def learner(self) -> learner_lib.Learner:
    """The learner, built on first use: serving never needs one."""
    if "learners" not in self._modules:
      self.CreateChildren("learners", [self._learner_params])
    return self.learners[0]

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

  def TrainableTheta(self) -> dict:
    """{theta path: parameter or StackedLeaf} this task's learner trains."""
    lrn = self.learner
    return {k: v for k, v in self.ThetaTree().FlattenItems()
            if lrn.TrainableFilter(k)}

  def CreateTrainState(self, generator: torch.Generator | None = None
                       ) -> NestedMap:
    """NestedMap(step=0, opt_states=[slots]): the step counter and the
    optimizer state of the weights the module holds now. With a
    generator, initializes the weights from it first."""
    if generator is not None:
      self.InstantiateVariables(generator)
    return NestedMap(step=0,
                     opt_states=[self.learner.InitState(self.TrainableTheta())])

  def TrainStep(self, state: NestedMap, input_batch: NestedMap,
                base_step_key=None) -> NestedMap:
    """One training step, IN PLACE: the parameters and state.opt_states
    are updated and state.step advances by one. base_step_key: the
    threefry key the step's seed folds the step into (PRNGKey(0) if
    None). Returns NestedMap(metrics, stats, per_example), every value
    detached."""
    if self._path is None:
      self.FinalizePaths()   # the seeds are functions of the layer paths
    lrn = self.learner
    params = self.TrainableTheta()
    for prm in self.parameters():
      prm.grad = None
    step_key = threefry.FoldIn(
        threefry.PRNGKey(0) if base_step_key is None else base_step_key,
        state.step)
    with torch.enable_grad():
      with py_utils.StepSeedContext(step_key), \
          py_utils.GlobalStepContext(state.step):
        metrics, per_example = self.FProp(input_batch)
      loss = metrics[lrn.p.loss_name][0].float()
      (loss + lrn.RegularizationLoss(params)).backward()
    grads = {}
    for key, leaf in params.items():
      members = [m.grad if m.grad is not None else torch.zeros_like(m)
                 for m in optimizer_lib.Members(leaf)]
      grads[key] = (base_layer.StackedLeaf(tuple(members))
                    if isinstance(leaf, base_layer.StackedLeaf) else
                    members[0])
    stats = lrn.Apply(params, grads, state.step, state.opt_states[0])
    for prm in self.parameters():
      prm.grad = None
    state.step += 1
    detach = lambda x: x.detach() if isinstance(x, torch.Tensor) else x
    return NestedMap(metrics=metrics.Transform(detach), stats=stats,
                     per_example=per_example.Transform(detach))


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
