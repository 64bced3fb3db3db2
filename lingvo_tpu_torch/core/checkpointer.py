"""Checkpointing: the save policy and the port's own checkpoint format (port of the policy surface of lingvo_tpu/core/checkpointer.py).

The reference's policy surface: save by steps or by wall clock
(`ShouldSave`), a synchronous `Save(step, task, state, force)`,
restore-or-init (`Restore`), `LatestStep`, `max_to_keep` garbage
collection of the oldest steps, and `Close`.

The format is the port's own. Orbax checkpoints of the JAX package need
JAX to read, so a reference theta crosses over through
`convert.LoadJaxTheta` instead. One directory per step,
`<train_dir>/ckpt_<step, 8 digits>/`, holds

- `theta.pt`: the task's weights, `{parameter name: CPU tensor}` under the
  names of the module's `state_dict`;
- `train_state.pt` (when a train state is saved): the step counter and
  the optimizer state, `{path: CPU tensor}` flattened in the state's
  order.

A step is written under a temporary name and renamed when complete, so a
reader polling the directory never sees half a step. The weights sit in a
file of their own, so a decoder reads only them. Files are read with
`torch.load(weights_only=True)`: tensors and plain containers, nothing
that runs code.
"""

from __future__ import annotations

import os
import re
import shutil
import time

import torch

from lingvo_tpu_torch.core.nested_map import NestedMap

THETA_FILE = "theta.pt"
TRAIN_STATE_FILE = "train_state.pt"
_STEP_DIR = re.compile(r"^ckpt_(\d{8,})$")


class Checkpointer:
  """Save cadence, synchronous save, restore-or-init and retention."""

  def __init__(self, train_dir: str, save_interval_steps: int = 1000,
               save_interval_seconds: float | None = None,
               max_to_keep: int = 10):
    if max_to_keep < 1:
      raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
    self._train_dir = os.path.abspath(train_dir)
    os.makedirs(self._train_dir, exist_ok=True)
    self._save_interval_steps = save_interval_steps
    self._save_interval_seconds = save_interval_seconds
    self._max_to_keep = max_to_keep
    self._last_save_time = time.time()
    self._last_save_step = -1

  @property
  def train_dir(self) -> str:
    return self._train_dir

  def ShouldSave(self, step: int) -> bool:
    """Save cadence by steps, or by wall clock when save_interval_seconds
    is set (the reference's single-process rule)."""
    if step == self._last_save_step:
      return False
    if self._save_interval_seconds is not None:
      return time.time() - self._last_save_time >= self._save_interval_seconds
    return step % max(1, self._save_interval_steps) == 0

  def _StepDir(self, step: int) -> str:
    return os.path.join(self._train_dir, f"ckpt_{step:08d}")

  def Steps(self) -> list[int]:
    """The steps with a complete checkpoint, ascending."""
    steps = []
    for name in os.listdir(self._train_dir):
      match = _STEP_DIR.match(name)
      if match and os.path.isdir(os.path.join(self._train_dir, name)):
        steps.append(int(match.group(1)))
    return sorted(steps)

  def LatestStep(self) -> int | None:
    steps = self.Steps()
    return steps[-1] if steps else None

  def Save(self, step: int, task: torch.nn.Module,
           state: NestedMap | None = None, force: bool = False) -> bool:
    """Writes `task`'s weights (and `state`'s step and optimizer state, if
    given) as checkpoint `step` if the policy says so or `force`; returns
    True if it wrote. Synchronous: the files are complete on return. The
    oldest steps beyond max_to_keep are deleted afterwards."""
    if not force and not self.ShouldSave(step):
      return False
    final = self._StepDir(step)
    tmp = f"{final}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({k: v.detach().cpu() for k, v in task.state_dict().items()},
               os.path.join(tmp, THETA_FILE))
    if state is not None:
      torch.save({"step": int(state.step),
                  "opt_states": {k: v.detach().cpu() for k, v in
                                 _OptItems(state)}},
                 os.path.join(tmp, TRAIN_STATE_FILE))
    if os.path.isdir(final):   # a forced save over an existing step
      shutil.rmtree(final)
    os.replace(tmp, final)
    self._last_save_time = time.time()
    self._last_save_step = step
    for old in self.Steps()[:-self._max_to_keep]:
      shutil.rmtree(self._StepDir(old))
    return True

  def Restore(self, task: torch.nn.Module, step: int | None = None,
              state: NestedMap | None = None) -> tuple[NestedMap | None, int]:
    """Restore-or-init: loads checkpoint `step` (default: the latest) into
    `task`'s weights in place, and into `state` (a train state of the same
    structure) if given. Returns (state, restored step); with no
    checkpoint at all, (state, 0) and nothing changes. A missing `step`
    raises FileNotFoundError."""
    target = self.LatestStep() if step is None else step
    if target is None:
      return state, 0
    path = self._StepDir(target)
    if not os.path.isdir(path):
      raise FileNotFoundError(f"no checkpoint for step {target} in "
                              f"{self._train_dir}")
    task.load_state_dict(torch.load(os.path.join(path, THETA_FILE),
                                    map_location="cpu", weights_only=True))
    if state is not None:
      saved = torch.load(os.path.join(path, TRAIN_STATE_FILE),
                         map_location="cpu", weights_only=True)
      items = _OptItems(state)
      if [k for k, _ in items] != list(saved["opt_states"]):
        raise ValueError(f"checkpoint {target}: optimizer state structure "
                         "differs from the given train state")
      with torch.no_grad():
        for k, v in items:
          v.copy_(saved["opt_states"][k])
      state.step = saved["step"]
    return state, int(target)

  def Close(self) -> None:
    """Every save is synchronous, so nothing is in flight; kept for the
    reference's surface."""


def _OptItems(state: NestedMap) -> list:
  """[(path, tensor)] of a train state's optimizer state, in order."""
  return NestedMap(opt_states=state.opt_states).FlattenItems()
