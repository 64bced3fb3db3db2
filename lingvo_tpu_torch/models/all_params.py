"""Imports every params module of the port so the registry is complete
(port of lingvo_tpu/models/all_params.py, whose other model families the
port does not have yet)."""

from lingvo_tpu_torch.models.lm.params import synthetic_packed_input  # noqa: F401
from lingvo_tpu_torch.models.lm.params import one_billion_wds  # noqa: F401
