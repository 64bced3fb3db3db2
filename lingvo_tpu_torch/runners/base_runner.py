"""Checkpoint-polling runner: eval jobs that follow a training run (port of lingvo_tpu/runners/base_runner.py).

A separate job (`trainer --job=evaler`) watches the trainer's checkpoint
directory; each time a new checkpoint appears it restores the train
state (the weights, the optimizer state and the EMA of the weights, which
an eval program reads by default) and runs its programs against it,
writing summaries tagged with the checkpoint's step. It exits when a
checkpoint at or after the task's max_steps has been processed, when the
trainer's `FINISHED` marker appears, or when no new checkpoint appears
within `timeout_secs`.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Sequence

from lingvo_tpu_torch.core import checkpointer as checkpointer_lib


class CheckpointPollingRunner:
  """Runs programs against every new checkpoint in a training directory."""

  def __init__(self, task, programs: Sequence, train_dir: str,
               poll_interval_secs: float = 10.0,
               timeout_secs: float = 3600.0):
    self._task = task
    self._programs = list(programs)
    self._train_dir = train_dir
    self._checkpointer = checkpointer_lib.Checkpointer(train_dir)
    self._poll_interval = poll_interval_secs
    self._timeout = timeout_secs
    self._last_evaled_step = -1
    # the state every restore writes into, built once: its values are
    # all overwritten, so the weights are not drawn
    self._state = task.CreateTrainState()

  def _FindNewCheckpoint(self) -> int | None:
    """The latest unseen checkpoint step, or None."""
    latest = self._checkpointer.LatestStep()
    if latest is None or latest <= self._last_evaled_step:
      return None
    return latest

  def RunOnce(self, step: int) -> dict:
    """Restores checkpoint `step` and runs all programs against it."""
    state, restored_step = self._checkpointer.Restore(
        self._task, step=step, state=self._state)
    results = {}
    for prog in self._programs:
      _, results[prog.p.name] = prog.Run(state)
    self._last_evaled_step = restored_step
    return results

  def _TrainFinished(self) -> bool:
    return os.path.exists(os.path.join(self._train_dir, "FINISHED"))

  def Run(self, on_results: Callable[[int, dict], None] | None = None):
    """Polls until the final checkpoint is processed or timeout expires."""
    max_steps = self._task.p.train.max_steps
    last_new = time.time()
    try:
      while True:
        step = self._FindNewCheckpoint()
        if step is not None:
          results = self.RunOnce(step)
          last_new = time.time()
          print(f"[poller] evaluated checkpoint @ step {step}", flush=True)
          if on_results is not None:
            on_results(step, results)
          if step >= max_steps or self._TrainFinished():
            return
        elif self._TrainFinished():
          print("[poller] trainer FINISHED marker seen; exiting", flush=True)
          return
        elif time.time() - last_new > self._timeout:
          print(f"[poller] no new checkpoint in {self._timeout:.0f}s; "
                "exiting", flush=True)
          return
        else:
          time.sleep(self._poll_interval)
    finally:
      for prog in self._programs:
        prog.Shutdown()
      self._checkpointer.Close()
