"""Cross-task variable sharing by regex (port of lingvo_tpu/core/multitask_model.py).

`SharedVariableRules(rules)` maps a task's theta path to a canonical key
by `re.sub` (the first rule that fully matches wins; a path no rule
matches stays the task's own). Two (task, path) leaves with one key are
shared. In the reference each task's train state owns its theta and
sharing is a relation between states; in the port each task owns its
parameters, so the relation is between the tasks' modules:

- `UnifyStates(tasks)` copies the first task's (in sorted order) value
  of each shared leaf into every other task's at init;
- `Propagate(tasks, from_task)` copies `from_task`'s values of its shared
  leaves into every tied leaf after its train cycle.

The copies are in place, so shared leaves are bitwise equal after each
cycle. Only theta is shared: the optimizer slots stay per task, as the
reference's. `runners/program.MultiTaskProgramSchedule` applies these
when its `variable_renaming_rules` are set. `tasks` is {task name: task};
each leaf is a parameter or a repeat stack's StackedLeaf.
"""

from __future__ import annotations

import re
from typing import Sequence, Tuple

import torch

from lingvo_tpu_torch.core import optimizer


class SharedVariableRules:
  """Compiled (pattern, replacement) rules over variable paths."""

  def __init__(self, rules: Sequence[Tuple[str, str]]):
    self._rules = [(re.compile(pat), repl) for pat, repl in rules]
    self._shared_paths = None  # computed once; the mapping is static

  def CanonicalKey(self, path: str) -> str | None:
    r"""Canonical share key for a theta path, or None if task-private.
    Replacement supports backrefs (`\1`)."""
    for pat, repl in self._rules:
      if pat.fullmatch(path):
        return pat.sub(repl, path)
    return None

  def SharedPaths(self, tasks: dict) -> dict[str, list[tuple[str, str]]]:
    """canonical key -> [(task_name, theta_path), ...], tasks in sorted
    order. Cached after the first call: the path structure is fixed."""
    if self._shared_paths is None:
      out: dict[str, list[tuple[str, str]]] = {}
      for task_name in sorted(tasks):
        for path, _ in tasks[task_name].ThetaTree().FlattenItems():
          key = self.CanonicalKey(path)
          if key is not None:
            out.setdefault(key, []).append((task_name, path))
      self._shared_paths = out
    return self._shared_paths

  @torch.no_grad()
  def UnifyStates(self, tasks: dict) -> None:
    """Makes shared leaves identical: the first task in sorted order
    donates. Raises if two leaves under one key differ in shape: a wrong
    rule silently pairing unrelated variables is the dangerous failure."""
    flat = {n: dict(t.ThetaTree().FlattenItems()) for n, t in tasks.items()}
    for key, entries in self.SharedPaths(tasks).items():
      donor_task, donor_path = entries[0]
      donor = flat[donor_task][donor_path]
      for task_name, path in entries[1:]:
        leaf = flat[task_name][path]
        if tuple(leaf.shape) != tuple(donor.shape):
          raise ValueError(
              f"rule key {key!r} pairs {donor_task}/{donor_path} "
              f"{tuple(donor.shape)} with {task_name}/{path} "
              f"{tuple(leaf.shape)}")
        for dst, src in zip(optimizer.Members(leaf), optimizer.Members(donor)):
          dst.copy_(src)

  @torch.no_grad()
  def Propagate(self, tasks: dict, from_task: str) -> None:
    """Copies `from_task`'s shared values into every tied leaf, its own
    other paths under the same key included (one variable in the
    reference cannot diverge, so neither may these)."""
    flat = {n: dict(t.ThetaTree().FlattenItems()) for n, t in tasks.items()}
    for _, entries in self.SharedPaths(tasks).items():
      sources = [(t, p) for t, p in entries if t == from_task]
      if not sources:
        continue
      src_task, src_path = sources[0]
      value = flat[src_task][src_path]
      for task_name, path in entries:
        if (task_name, path) != (src_task, src_path):
          for dst, src in zip(optimizer.Members(flat[task_name][path]),
                              optimizer.Members(value)):
            dst.copy_(src)
