"""Checkpointing: the save policy and the port's own checkpoint format (port of lingvo_tpu/core/checkpointer.py).

The reference's policy surface: save by steps or by wall clock
(`ShouldSave`), `max_to_keep` garbage collection, the saved-value sanity
check (`_SanityCheck`: a non-finite float refuses the save), a synchronous
`Save`, the pipelined executor's `SaveAsync` with its barrier
`WaitForPendingSave`, restore-or-init (`Restore`), `LatestStep`, `Close`,
and the warm starts `ApplyInitFromCheckpointRules` and
`ImportNpzCheckpoint`. The reference's `keep_every_n_steps`, which no
executor sets, is not ported (ROADMAP item 1.13).

The format is the port's own. Orbax checkpoints of the JAX package need
JAX to read, so a reference theta crosses over through
`convert.LoadJaxTheta` or an npz of its leaves (`ImportNpzCheckpoint`).
One directory per step, `<train_dir>/ckpt_<step, 8 digits>/`, holds

- `theta.pt`: the task's weights, `{parameter name: CPU tensor}` under the
  names of the module's `state_dict`;
- `train_state.pt` (when a train state is saved): the step counter and
  the state's tensors, `{path: CPU tensor}` flattened in the state's
  order: one optimizer state per learner (`opt_states[i]...`) and, with
  an EMA, `ema_theta...`. A multi-task state (NestedMap(tasks={name:
  state}, step)) keeps each task's under `tasks.{name}.` and each task's
  step beside the total.

`Save` and `Restore` take the module whose `state_dict` holds the
weights: a task, or a multi-task schedule's `model` (its tasks as
children).

A step is written under a temporary name and renamed when complete, so a
reader polling the directory never sees half a step. The weights sit in a
file of their own, so a decoder reads only them. Files are read with
`torch.load(weights_only=True)`: tensors and plain containers, nothing
that runs code. They are memory-mapped, so each tensor is read from the
file once, where it is copied to. `torch.save` writes them without the
zip records' CRC32, which took 15–45% of a write on an H100's host
(`tools/torch_train_surface_probe.py`) and which `torch.load` never
checks.

`SaveAsync` copies every tensor to the host before it returns, so a later
in-place optimizer update cannot tear the snapshot; only the file write
runs on the background worker. The finiteness of the saved values is
reduced on their device first (one flag read with the copy), and a
non-finite snapshot fails in the worker, at the next barrier, as in the
reference.
"""

from __future__ import annotations

import os
import re
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core.nested_map import NestedMap

THETA_FILE = "theta.pt"
TRAIN_STATE_FILE = "train_state.pt"
_STEP_DIR = re.compile(r"^ckpt_(\d{8,})$")


class Checkpointer:
  """Save cadence, sanity-checked synchronous and background saves,
  restore-or-init and retention."""

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
    # one background writer, at most one write outstanding: SaveAsync
    # waits out the previous write, so a slow disk slows the cadence
    # instead of queueing snapshots in host memory
    self._save_pool: ThreadPoolExecutor | None = None
    self._pending_save: Future | None = None
    # one record per completed write: step, bytes, the caller's snapshot
    # seconds and the write's seconds
    self.writes: list[dict] = []

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

  def _Snapshot(self, task: torch.nn.Module, state: NestedMap | None
                ) -> tuple[dict, dict | None, bool]:
    """(theta, train state, all finite) as host copies. The finiteness
    of every float is reduced on its device and read once, with the
    copy."""
    theta = {k: v.detach() for k, v in task.state_dict().items()}
    opt = None if state is None else {k: v.detach()
                                      for k, v in _OptItems(state)}
    flags = [torch.isfinite(v).all() for v in
             list(theta.values()) + list((opt or {}).values())
             if v.is_floating_point()]
    finite = not flags or bool(torch.stack(flags).all())
    # .cpu() shares a CPU tensor's memory: clone those, as the device
    # copies are independent of later in-place updates
    host = lambda v: v.clone() if v.device.type == "cpu" else v.cpu()
    theta = {k: host(v) for k, v in theta.items()}
    if opt is not None:
      opt = {"step": int(state.step),
             "opt_states": {k: host(v) for k, v in opt.items()}}
      if "tasks" in state:
        opt["task_steps"] = {n: int(s.step) for n, s in state.tasks.items()}
    return theta, opt, finite

  @staticmethod
  def _SanityCheck(theta: dict, opt: dict | None) -> None:
    """Names the first non-finite saved leaf (ref saver.py IsFinite)."""
    items = list(theta.items()) + list((opt or {}).get("opt_states",
                                                       {}).items())
    for path, v in items:
      if v.is_floating_point() and not bool(torch.isfinite(v).all()):
        raise ValueError(
            f"Checkpoint sanity check failed: non-finite values in {path}")
    raise ValueError("Checkpoint sanity check failed: non-finite values")

  def _Submit(self, fn, *args) -> Future:
    if self._save_pool is None:
      self._save_pool = ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="ckpt-save")
    return self._save_pool.submit(fn, *args)

  def Save(self, step: int, task: torch.nn.Module,
           state: NestedMap | None = None, force: bool = False) -> bool:
    """Writes `task`'s weights (and `state`'s step and optimizer state, if
    given) as checkpoint `step` if the policy says so or `force`; returns
    True if it wrote. Synchronous: the files are complete on return (after
    any pending SaveAsync, so writes land in order). A non-finite value
    raises ValueError and writes nothing. The oldest steps beyond
    max_to_keep are deleted afterwards."""
    if not force and not self.ShouldSave(step):
      return False
    self.WaitForPendingSave()
    t0 = time.perf_counter()
    snap = self._Snapshot(task, state)
    self._last_save_time = time.time()
    self._last_save_step = step
    self._Write(step, *snap, time.perf_counter() - t0)
    return True

  def SaveAsync(self, step: int, task: torch.nn.Module,
                state: NestedMap | None = None, force: bool = False) -> bool:
    """Save with the file write on a background worker: the host snapshot
    is complete when this returns, so the caller may update the weights
    in place at once. Returns True if a write was scheduled. Errors of the
    write (a non-finite value included) surface at the next
    WaitForPendingSave barrier: Restore, Close, Save, the next
    SaveAsync."""
    if not force and not self.ShouldSave(step):
      return False
    self.WaitForPendingSave()
    t0 = time.perf_counter()
    snap = self._Snapshot(task, state)
    # the cadence advances at submit time: a save for this step exists
    # now, although its bytes land later
    self._last_save_time = time.time()
    self._last_save_step = step
    self._pending_save = self._Submit(self._Write, step, *snap,
                                      time.perf_counter() - t0)
    return True

  def _Write(self, step: int, theta: dict, opt: dict | None,
             finite: bool, snapshot_s: float) -> None:
    if not finite:
      self._SanityCheck(theta, opt)
    t0 = time.perf_counter()
    final = self._StepDir(step)
    tmp = f"{final}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    crc = torch.serialization.get_crc32_options()
    torch.serialization.set_crc32_options(False)
    try:
      torch.save(theta, os.path.join(tmp, THETA_FILE))
      if opt is not None:
        torch.save(opt, os.path.join(tmp, TRAIN_STATE_FILE))
    finally:
      torch.serialization.set_crc32_options(crc)
    nbytes = sum(os.path.getsize(os.path.join(tmp, f))
                 for f in os.listdir(tmp))
    if os.path.isdir(final):   # a forced save over an existing step
      shutil.rmtree(final)
    os.replace(tmp, final)
    self.writes.append(dict(step=step, bytes=nbytes, snapshot_s=snapshot_s,
                            write_s=time.perf_counter() - t0))
    for old in self.Steps()[:-self._max_to_keep]:
      shutil.rmtree(self._StepDir(old))

  def WaitForPendingSave(self) -> None:
    """Barrier for SaveAsync: blocks until the write in flight (if any)
    ends, and re-raises its error."""
    fut, self._pending_save = self._pending_save, None
    if fut is not None:
      fut.result()

  def Restore(self, task: torch.nn.Module, step: int | None = None,
              state: NestedMap | None = None) -> tuple[NestedMap | None, int]:
    """Restore-or-init: loads checkpoint `step` (default: the latest) into
    `task`'s weights in place, and into `state` (a train state of the same
    structure) if given. Returns (state, restored step); with no
    checkpoint at all, (state, 0) and nothing changes. A missing `step`
    raises FileNotFoundError."""
    self.WaitForPendingSave()   # never read around a write in flight
    target = self.LatestStep() if step is None else step
    if target is None:
      return state, 0
    path = self._StepDir(target)
    if not os.path.isdir(path):
      raise FileNotFoundError(f"no checkpoint for step {target} in "
                              f"{self._train_dir}")
    task.load_state_dict(_Load(os.path.join(path, THETA_FILE)))
    if state is not None:
      saved = _Load(os.path.join(path, TRAIN_STATE_FILE))
      items = _OptItems(state)
      if [k for k, _ in items] != list(saved["opt_states"]):
        raise ValueError(f"checkpoint {target}: optimizer state structure "
                         "differs from the given train state")
      with torch.no_grad():
        for k, v in items:
          v.copy_(saved["opt_states"][k])
      state.step = saved["step"]
      for name, step in saved.get("task_steps", {}).items():
        state.tasks[name].step = step
    return state, int(target)

  def Close(self) -> None:
    """Waits for the write in flight and stops the worker."""
    self.WaitForPendingSave()
    if self._save_pool is not None:
      self._save_pool.shutdown(wait=True)
      self._save_pool = None


def _Load(path: str) -> dict:
  return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def _TensorPart(state: NestedMap) -> NestedMap:
  part = NestedMap(opt_states=state.opt_states)
  if "ema_theta" in state:
    part.ema_theta = state.ema_theta
  return part


def _OptItems(state: NestedMap) -> list:
  """[(path, tensor)] of a train state's tensors (the optimizer states
  and the EMA; a multi-task state's per task), in order."""
  if "tasks" in state:
    return NestedMap(tasks={n: _TensorPart(s) for n, s in
                            state.tasks.items()}).FlattenItems()
  return _TensorPart(state).FlattenItems()


def _Members(leaf) -> tuple:
  return leaf.layers if isinstance(leaf, base_layer.StackedLeaf) else (leaf,)


@torch.no_grad()
def _Assign(path: str, leaf, value: np.ndarray, where: str) -> None:
  """Copies a reference-layout array into a theta leaf (a repeat stack's
  StackedLeaf split on its leading [num_layers] axis), cast to its
  dtype."""
  if tuple(value.shape) != tuple(leaf.shape):
    raise ValueError(f"{where}: shape mismatch for {path}: "
                     f"{tuple(leaf.shape)} vs source {tuple(value.shape)}")
  members = _Members(leaf)
  parts = value if isinstance(leaf, base_layer.StackedLeaf) else [value]
  for member, part in zip(members, parts):
    member.copy_(torch.as_tensor(np.ascontiguousarray(part)).to(member.dtype))


def _SourcePath(path: str, rules) -> tuple[str | None, bool]:
  """(source path, required) of a target theta path under
  [(target_regex, source_template)] rules; the first match wins."""
  for target_regex, source_tpl in rules:
    if re.fullmatch(target_regex, path):
      return re.sub(target_regex, source_tpl, path), True
  return None, False


def _ThetaOfStateDict(state_dict: dict) -> dict:
  """{theta path: numpy array in the reference layout} of a port
  `state_dict`: a repeat stack's `body.<i>.` members (the
  `RepeatedTransformerLayer.body` ModuleList) restacked on a leading
  axis, any other ModuleList index written `[i]`, as `ThetaTree`
  flattens them."""
  stacked: dict = {}
  out = {}
  for name, value in state_dict.items():
    parts = name.split(".")
    path, layer = [], None
    for i, part in enumerate(parts):
      if part.isdigit():
        if i > 0 and parts[i - 1] == "body" and layer is None:
          layer = int(part)
        else:
          path[-1] += f"[{part}]"
      else:
        path.append(part)
    key = ".".join(path)
    arr = value.detach().cpu().numpy()
    if layer is None:
      out[key] = arr
    else:
      stacked.setdefault(key, {})[layer] = arr
  for key, layers in stacked.items():
    out[key] = np.stack([layers[i] for i in sorted(layers)])
  return out


def _MirrorEma(state, path: str, leaf) -> None:
  """A warm-started leaf's value into the state's EMA too (ref
  checkpointer.py:381): eval on the EMA must not score the random init."""
  if state is not None and "ema_theta" in state:
    with torch.no_grad():
      ema = state.ema_theta[path]
      if isinstance(leaf, base_layer.StackedLeaf):
        ema.copy_(torch.stack(leaf.layers))
      else:
        ema.copy_(leaf)


def ApplyInitFromCheckpointRules(task: base_layer.BaseLayer,
                                 rules: dict, state=None) -> int:
  """Warm start (ref `checkpointer.py:214`): `rules` maps a source run's
  train dir to [(target_regex, source_template)]. Every theta leaf of
  `task` whose path fully matches a target regex takes the source's
  latest checkpoint's leaf at re.sub(target_regex, source_template,
  path), cast to the target dtype. Shapes must match, and a matching rule
  whose source leaf is missing raises. A train `state` with an EMA gets
  each loaded value in its `ema_theta` too. Returns the leaves loaded."""
  n_total = 0
  targets = task.ThetaTree().FlattenItems()
  for ckpt_dir, pairs in rules.items():
    n_loaded = 0
    source = Checkpointer(ckpt_dir)
    step = source.LatestStep()
    if step is None:
      raise FileNotFoundError(
          f"init_from_checkpoint_rules: no checkpoint in {ckpt_dir}")
    src = _ThetaOfStateDict(torch.load(
        os.path.join(source._StepDir(step), THETA_FILE), map_location="cpu",
        weights_only=True))
    for path, leaf in targets:
      src_path, _ = _SourcePath(path, pairs)
      if src_path is None:
        continue
      if src_path not in src:
        raise KeyError(
            f"init_from_checkpoint_rules: {path!r} maps to source var "
            f"{src_path!r} which is not in {ckpt_dir} (has {len(src)} vars)")
      _Assign(path, leaf, src[src_path], "init_from_checkpoint_rules")
      _MirrorEma(state, path, leaf)
      n_loaded += 1
    print(f"[checkpointer] warm start: {n_loaded} vars from {ckpt_dir} "
          f"@ step {step}", flush=True)
    n_total += n_loaded
  return n_total


def ImportNpzCheckpoint(task: base_layer.BaseLayer, npz_path: str,
                        rules=None, state=None) -> int:
  """Initializes `task`'s weights from an npz of reference-layout arrays
  keyed by the reference's dotted theta paths (`stack.body.fflayer.ffn_in.w`
  with its leading [num_layers] axis). `rules`: optional
  [(target_regex, source_template)] name mapping; None means the npz keys
  are the theta paths. Leaves without an npz entry keep their
  initialization, but a rule whose mapped source is missing raises. A
  train `state` with an EMA gets each loaded value in its `ema_theta`
  too. Returns the leaves loaded."""
  src = np.load(npz_path)
  src_keys = set(src.files)
  n_loaded = 0
  for path, leaf in task.ThetaTree().FlattenItems():
    if rules is None:
      src_path, required = (path if path in src_keys else None), False
    else:
      src_path, required = _SourcePath(path, rules)
    if src_path is None:
      continue
    if src_path not in src_keys:
      if required:
        raise KeyError(
            f"ImportNpzCheckpoint: {path!r} maps to {src_path!r} which is "
            f"not in {npz_path} ({len(src_keys)} vars)")
      continue
    _Assign(path, leaf, src[src_path], "ImportNpzCheckpoint")
    _MirrorEma(state, path, leaf)
    n_loaded += 1
  print(f"[checkpointer] npz import: {n_loaded} vars from {npz_path}",
        flush=True)
  return n_loaded
