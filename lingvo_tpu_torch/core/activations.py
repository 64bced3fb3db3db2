"""Activation registry: name -> fn (port of lingvo_tpu/core/activations.py).

Same names and the same functions as the reference's table; only the
entries the served models use are carried over so far.
"""

from __future__ import annotations

import torch

_ACTIVATIONS = {
    "NONE": lambda x: x,
    "RELU": torch.relu,
}


def GetFn(name: str):
  if name not in _ACTIVATIONS:
    raise ValueError(f"Unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}")
  return _ACTIVATIONS[name]


def Register(name: str, fn) -> None:
  _ACTIVATIONS[name.upper()] = fn
