"""Global model registry: name -> ModelParams class (port of lingvo_tpu/model_registry.py).

Experiment classes register themselves under
`<task_dir>.<module>.<ClassName>` (`lm.synthetic_packed_input.DenseLmTiny`,
the reference's keys) and the trainer looks them up by name, applying a
dataset method to produce the final Params tree.
"""

from __future__ import annotations

import importlib
from typing import Type

from lingvo_tpu_torch.core import base_model_params

_MODEL_REGISTRY: dict[str, Type[base_model_params._BaseModelParams]] = {}

# Module prefixes probed by _MaybeImportFor: `lm.foo.Bar` ->
# `lingvo_tpu_torch.models.lm.params.foo`.
_TASK_ROOT = "lingvo_tpu_torch.models"


def _RegisterModel(cls, task_hint: str | None = None):
  parts = cls.__module__.split(".")
  if "models" in parts:
    idx = parts.index("models")
    task = parts[idx + 1] if len(parts) > idx + 1 else (task_hint or "misc")
    leaf = parts[-1] if parts[-1] != "params" else task
  else:
    task, leaf = (task_hint or "misc"), parts[-1]
  key = f"{task}.{leaf}.{cls.__name__}"
  _MODEL_REGISTRY[key] = cls
  cls._registry_key = key
  return cls


def RegisterSingleTaskModel(cls):
  """Class decorator registering a SingleTaskModelParams subclass."""
  if not issubclass(cls, base_model_params.SingleTaskModelParams):
    raise TypeError(f"{cls} must subclass SingleTaskModelParams")
  return _RegisterModel(cls)


def RegisterMultiTaskModel(cls):
  """Class decorator registering a MultiTaskModelParams subclass."""
  if not issubclass(cls, base_model_params.MultiTaskModelParams):
    raise TypeError(f"{cls} must subclass MultiTaskModelParams")
  return _RegisterModel(cls)


def _MaybeImportFor(name: str) -> None:
  parts = name.split(".")
  if len(parts) < 3:
    return
  task, module = parts[0], parts[1]
  for candidate in (f"{_TASK_ROOT}.{task}.params.{module}",
                    f"{_TASK_ROOT}.{task}.{module}"):
    try:
      importlib.import_module(candidate)
      return
    except ModuleNotFoundError as e:
      # only "the candidate itself does not exist" is skipped; a missing
      # dependency inside an experiment module is a real error
      if e.name and (candidate == e.name or candidate.startswith(e.name + ".")):
        continue
      raise


def GetClass(name: str) -> Type[base_model_params._BaseModelParams]:
  if name not in _MODEL_REGISTRY:
    _MaybeImportFor(name)
  if name not in _MODEL_REGISTRY:
    known = "\n  ".join(sorted(_MODEL_REGISTRY))
    raise LookupError(f"Model {name!r} not registered. Known:\n  {known}")
  return _MODEL_REGISTRY[name]


def GetParams(name: str, dataset_name: str):
  """The model Params for `name` with the `dataset_name` input attached."""
  inst = GetClass(name)()
  model_params = inst.Model()
  model_params.input = inst.GetDatasetParams(dataset_name)
  return model_params


def GetRegisteredModels():
  return dict(_MODEL_REGISTRY)
