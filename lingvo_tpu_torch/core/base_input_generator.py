"""Input generators: host-side batch producers (port of part of lingvo_tpu/core/base_input_generator.py).

A generator yields NestedMap batches of numpy arrays; the train program
moves each batch to the task's device. Only the base class the synthetic
LM input needs is ported; the file-backed and bucketing generators come
with a later slice.
"""

from __future__ import annotations

from lingvo_tpu_torch.core import hyperparams
from lingvo_tpu_torch.core.nested_map import NestedMap


class BaseInputGenerator:
  """Produces NestedMap batches (numpy, host-side)."""

  @classmethod
  def Params(cls) -> hyperparams.InstantiableParams:
    p = hyperparams.InstantiableParams(cls)
    p.Define("name", "", "Generator name.")
    p.Define("batch_size", 0, "Per-host batch size.")
    return p

  def __init__(self, params):
    self._params = params.Copy()
    self._params.Freeze()

  @property
  def p(self) -> hyperparams.InstantiableParams:
    return self._params

  def GlobalBatchSize(self) -> int:
    """Total batch (one host in the port)."""
    return self.p.batch_size

  def InfeedBatchSize(self) -> int:
    """This host's batch."""
    return self.p.batch_size

  def _InputBatch(self) -> NestedMap:
    """Subclass point: produce one batch."""
    raise NotImplementedError

  def GetPreprocessedInputBatch(self) -> NestedMap:
    return self._InputBatch()

  def __iter__(self):
    while True:
      yield self.GetPreprocessedInputBatch()

  def Seek(self, batch_index: int) -> None:
    """Makes batch `batch_index` of the stream the next one. A stream
    whose batches are not addressable raises NotImplementedError; the
    train program then resumes it where it stands, as the reference
    resumes every stream."""
    raise NotImplementedError(f"{type(self).__name__} cannot seek")
