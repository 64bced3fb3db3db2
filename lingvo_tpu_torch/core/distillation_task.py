"""Teacher/student distillation task wrapper (port of lingvo_tpu/core/distillation_task.py).

Both models live in one task, as the children `teacher` and `student`.
The teacher is frozen: every learner excludes its variables
(`bprop_variable_exclusion = r"^teacher\\."`, set here; a learner that
already sets an exclusion is refused), and its forward runs under
`torch.no_grad()` (the values of the reference's `stop_gradient`, and no
activations kept). The loss mixes the student's ground-truth loss with
the soft-label KL against the teacher's logits, in float32:

  loss = (1 - w) * hard_loss + w * T^2 * KL(softmax(t / T) || softmax(s / T))

the KL averaged over the tokens that are not padding, and the metrics
also report `hard_loss` and `distill_loss`. Both tasks must give dense
`predictions.logits` (the LM's `xent_block_size` 0 and no sampled
softmax), as the reference needs. Teacher weights usually arrive by a
warm start mapping `teacher\\..*`.
"""

from __future__ import annotations

import torch

from lingvo_tpu_torch.core import base_model
from lingvo_tpu_torch.core import jit_arith
from lingvo_tpu_torch.core.nested_map import NestedMap


class DistillationTask(base_model.BaseTask):
  """Wraps a teacher task and a student task of the same interface."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("teacher", None, "Teacher task Params (frozen).")
    p.Define("student", None, "Student task Params (trained).")
    p.Define("distill_weight", 0.5,
             "Mix: loss = (1-w) * student_loss + w * distill_KL.")
    p.Define("temperature", 1.0, "Soft-label temperature.")
    return p

  def __init__(self, params, device=None):
    params = params.Copy()
    learners = params.train.learner
    for lp in (learners if isinstance(learners, (list, tuple))
               else [learners]):
      assert lp.bprop_variable_exclusion is None, (
          "DistillationTask owns bprop_variable_exclusion")
      lp.bprop_variable_exclusion = r"^teacher\."
    super().__init__(params, device)
    p = self.p
    assert p.teacher is not None and p.student is not None
    self.CreateChild("teacher", p.teacher)
    self.CreateChild("student", p.student)

  def ComputePredictions(self, input_batch):
    with torch.no_grad():
      teacher_preds = self.teacher.ComputePredictions(input_batch)
    student_preds = self.student.ComputePredictions(input_batch)
    return NestedMap(teacher=teacher_preds, student=student_preds)

  def ComputeLoss(self, predictions, input_batch):
    p = self.p
    metrics, per_example = self.student.ComputeLoss(predictions.student,
                                                    input_batch)
    hard_loss, weight = metrics.loss
    t = p.temperature
    inv_t = jit_arith.Reciprocal(t)
    t_logits = predictions.teacher.logits.float() * inv_t
    s_logits = predictions.student.logits.float() * inv_t
    t_log_probs = torch.log_softmax(t_logits, dim=-1)
    kl = torch.sum(torch.softmax(t_logits, dim=-1) *
                   (t_log_probs - torch.log_softmax(s_logits, dim=-1)),
                   dim=-1)
    if "paddings" in input_batch:
      w = 1.0 - input_batch.paddings
      distill_loss = torch.sum(kl * w) / torch.clamp(torch.sum(w), min=1e-8)
    else:
      distill_loss = torch.mean(kl)
    distill_loss = distill_loss * (t * t)   # the classic T^2 scaling
    total = (1.0 - p.distill_weight) * hard_loss + (
        p.distill_weight * distill_loss)
    metrics.loss = (total, weight)
    metrics.hard_loss = (hard_loss, weight)
    metrics.distill_loss = (distill_loss, weight)
    return metrics, per_example
