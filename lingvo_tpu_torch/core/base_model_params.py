"""Base classes for experiment definitions (port of lingvo_tpu/core/base_model_params.py).

An experiment is a class with dataset methods (`Train()/Dev()/Test()`), a
`Task()` returning the task Params, and `Model()` wrapping it into a
`SingleTaskModel` Params tree, as in the reference; a multi-task
experiment's `Task()` returns one sub-Params per task name, which
`Model()` wraps into a `MultiTaskModel`.
"""

from __future__ import annotations

import inspect

from lingvo_tpu_torch.core import hyperparams


class DatasetError(Exception):
  pass


class _BaseModelParams:
  """Shared dataset-reflection machinery."""

  _registry_key: str = ""

  def GetAllDatasetParams(self) -> dict:
    return {name: self.GetDatasetParams(name)
            for name in self.GetDatasetNames()}

  def GetDatasetNames(self) -> list[str]:
    """Dataset methods the experiment defines (not the base stubs)."""
    base_owners = ("_BaseModelParams", "SingleTaskModelParams",
                   "MultiTaskModelParams")
    names = []
    for name, member in inspect.getmembers(type(self), inspect.isfunction):
      if name.startswith("_") or name in (
          "Task", "Model", "ProgramSchedule", "GetDatasetParams",
          "GetAllDatasetParams", "GetDatasetNames"):
        continue
      if member.__qualname__.split(".")[0] in base_owners:
        continue  # an inherited raising stub, not a dataset
      if len(inspect.signature(member).parameters) == 1:  # only self
        names.append(name)
    return sorted(set(names))

  def GetDatasetParams(self, dataset: str) -> hyperparams.Params:
    method = getattr(self, dataset, None)
    if method is None or dataset.startswith("_"):
      raise DatasetError(
          f"Dataset {dataset!r} not found on {type(self).__name__}; "
          f"available: {self.GetDatasetNames()}")
    return method()

  def ProgramSchedule(self):
    """Optional override: returns a ProgramSchedule params tree."""
    return None


class SingleTaskModelParams(_BaseModelParams):
  """One-task experiment: defines Task() and dataset methods."""

  def Train(self) -> hyperparams.Params:
    raise DatasetError("Train() dataset not defined")

  def Dev(self) -> hyperparams.Params:
    raise DatasetError("Dev() dataset not defined")

  def Test(self) -> hyperparams.Params:
    raise DatasetError("Test() dataset not defined")

  def Task(self) -> hyperparams.InstantiableParams:
    raise NotImplementedError

  def Model(self) -> hyperparams.InstantiableParams:
    from lingvo_tpu_torch.core import base_model
    p = base_model.SingleTaskModel.Params()
    p.task = self.Task()
    p.name = p.task.name or type(self).__name__
    return p


class MultiTaskModelParams(_BaseModelParams):
  """Multi-task experiment: defines per-task params."""

  def Task(self) -> hyperparams.Params:
    raise NotImplementedError

  def Model(self) -> hyperparams.InstantiableParams:
    from lingvo_tpu_torch.core import base_model
    p = base_model.MultiTaskModel.Params()
    p.task_params = self.Task()
    p.name = type(self).__name__
    return p
