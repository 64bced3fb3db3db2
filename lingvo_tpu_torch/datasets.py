"""Dataset discovery by reflection (port of lingvo_tpu/datasets.py).

Every public zero-argument method of a ModelParams class that is not part
of the base interface is a dataset (Train/Dev/Test/...); `GetDatasets`
lists them for `trainer.py --list_models`.
"""

from __future__ import annotations

import inspect
import logging
from typing import Any, List

NON_DATASET_MEMBERS = [
    "GetAllDatasetParams", "GetDatasetParams", "GetDatasetNames", "Model",
    "Search", "Task", "ProgramSchedule", "UpdateParamsFromSpec",
    "CreateDynamicDatasetMethods", "Params",
]


class DatasetFunctionError(TypeError):
  pass


def GetDatasets(cls: Any, warn_on_error: bool = True) -> List[str]:
  """Dataset method names (e.g. ['Test', 'Train']), sorted.

  A dataset method is public, not in NON_DATASET_MEMBERS, and callable
  with no positional arguments. `GetDatasetNames`, where the class has
  it, answers without building any Params tree.
  """
  instance = None
  if inspect.isclass(cls):
    try:
      instance = cls()
    except TypeError:
      pass
  else:
    instance = cls
  if instance is not None and hasattr(instance, "GetDatasetNames"):
    try:
      return sorted(instance.GetDatasetNames())
    except Exception:  # noqa: BLE001 - fall through to reflection
      pass

  datasets = []
  target = cls if inspect.isclass(cls) else type(cls)
  for name, fn in inspect.getmembers(target, inspect.isroutine):
    if name.startswith("_") or name in NON_DATASET_MEMBERS:
      continue
    try:
      sig_params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
      continue
    if sig_params and sig_params[0].name in ("self", "cls"):
      sig_params = sig_params[1:]
    required = [a for a in sig_params
                if a.default is inspect.Parameter.empty
                and a.kind in (inspect.Parameter.POSITIONAL_ONLY,
                               inspect.Parameter.POSITIONAL_OR_KEYWORD)]
    if required:
      msg = (f"{target.__name__}.{name} has required args and cannot be "
             f"a dataset")
      if warn_on_error:
        logging.warning(msg)
        continue
      raise DatasetFunctionError(msg)
    datasets.append(name)
  return sorted(datasets)
