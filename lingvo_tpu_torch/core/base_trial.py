"""Trial API for hyperparameter-tuning services (port of lingvo_tpu/core/base_trial.py).

A Trial can override model params before construction, receives eval
measures, and can request early stopping. NoOpTrial is the default.
"""

from __future__ import annotations


class Trial:

  def OverrideModelParams(self, model_params):
    """Mutates/returns model params for this trial."""
    raise NotImplementedError

  def ReportEvalMeasure(self, global_step: int, metrics: dict,
                        checkpoint_path: str = "") -> bool:
    """Reports metrics; returns True if the trial should stop early."""
    raise NotImplementedError

  def ReportDone(self, infeasible: bool = False, reason: str = "") -> None:
    raise NotImplementedError

  def ShouldStop(self) -> bool:
    raise NotImplementedError

  @property
  def Name(self) -> str:
    return ""


class NoOpTrial(Trial):
  """Training without a tuning service (ref NoOpTrial)."""

  def OverrideModelParams(self, model_params):
    return model_params

  def ReportEvalMeasure(self, global_step, metrics, checkpoint_path=""):
    return False

  def ReportDone(self, infeasible=False, reason=""):
    pass

  def ShouldStop(self):
    return False
