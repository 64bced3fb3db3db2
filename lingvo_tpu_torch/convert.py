"""Carries reference (JAX) weights into the port's modules.

`LoadJaxTheta(module, theta_np)` takes a lingvo_tpu theta as a nested
dict (NestedMap) of numpy arrays, lists for stacked `x_layers`, and copies
every leaf into the module's parameter of the same path. Layouts are the
reference's (w_query [D, N, H], emb [V, D], ...), so each leaf copies
unchanged; the one structural difference is the repeat stack, whose
reference leaves carry a leading [num_layers] axis that is unstacked into
`RepeatedTransformerLayer.body[i]`. For the hybrid stacks the body is a
`StackedTransformerLayers` block, and each leaf of its `x_layers[j]`
(attention or SSM mixer) is [num_layers // n, ...] in the reference. A
missing, extra or mis-shaped leaf raises.

`ThetaToNumpy(module)` is the inverse: the module's parameters as the
reference's theta, a NestedMap of numpy arrays with the repeat stack's
per-layer parameters restacked on the leading [num_layers] axis.

`LoadJaxOptState(opt_state, ref_state)` carries the reference's
optimizer state (numpy, in its structure: Adam's `m` / `v` theta trees,
Adafactor's `slots`, the Accumulator's `accum` and `count`, a
CompositeOptimizer's `subs`, Shampoo's `stat_l` / `stat_r` / `root_l` /
`root_r` / `accum`, EGDD's `m` / `gbar` / `gain` / `lr_scale`,
AdaGraft's `mag` / `dir`) into the port's state of the same optimizer
in place, so that both packages can start mid-run from one state;
`OptStatePairs` lists the (name, port tensor, reference array) pairs it
matches, which a test compares after some steps. `TrainStatePairs` /
`LoadJaxTrainState` do the same for a whole train state: one optimizer
state per learner, `ema_theta`, and a multi-task state's tasks (the
steps, host ints in the port, are set by the load and compared by the
caller).

`Int8ArtifactToTorch(theta, int8_tree)` carries the reference's exported
int8 tree ({path: {"w_int8", "scale"}} as numpy) onto the device of the
port's theta, a repeat stack's pairs split per layer as `LoadJaxTheta`
splits its leaves; `quant/weights.Int8ServingThetaFromArtifact` builds the
serving theta from it.
"""

from __future__ import annotations

import numpy as np
import torch

from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import transformer
from lingvo_tpu_torch.core.nested_map import NestedMap


def _Unstack(tree, i):
  if isinstance(tree, dict):
    return {k: _Unstack(v, i) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return [_Unstack(v, i) for v in tree]
  return np.asarray(tree)[i]


def _Load(module, tree, path: str, loaded: list) -> None:
  if isinstance(module, transformer.RepeatedTransformerLayer):
    if set(tree) != {"body"}:
      raise ValueError(f"{path}: repeat theta has keys {sorted(tree)}, "
                       "expected ['body']")
    for i, layer in enumerate(module.body):
      _Load(layer, _Unstack(tree["body"], i), f"{path}.body[{i}]", loaded)
    return
  own = dict(module.named_parameters(recurse=False))
  kids = dict(module.named_children())
  for key, value in tree.items():
    sub = f"{path}.{key}" if path else key
    if key in own:
      param = own.pop(key)
      arr = np.asarray(value)
      if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{sub}: theta leaf {arr.shape} vs parameter "
                         f"{tuple(param.shape)}")
      with torch.no_grad():
        param.copy_(torch.tensor(arr))
      loaded.append(sub)
    elif key in kids:
      child = kids.pop(key)
      if isinstance(child, torch.nn.ModuleList):
        if len(value) != len(child):
          raise ValueError(f"{sub}: {len(value)} theta entries for "
                           f"{len(child)} layers")
        for i, (c, v) in enumerate(zip(child, value)):
          _Load(c, v, f"{sub}[{i}]", loaded)
      else:
        _Load(child, value, sub, loaded)
    else:
      raise ValueError(f"{sub}: theta leaf has no parameter in the port")
  missing = list(own) + [
      k for k, c in kids.items() if any(True for _ in c.parameters())]
  if missing:
    raise ValueError(f"{path or '<root>'}: no theta for {sorted(missing)}")


def LoadJaxTheta(module: torch.nn.Module, theta_np) -> list[str]:
  """Copies the reference theta into `module` in place.

  Returns the dotted paths of the theta leaves it consumed, each once."""
  loaded: list[str] = []
  _Load(module, theta_np, "", loaded)
  return loaded


def _ToNumpy(leaf) -> np.ndarray:
  if isinstance(leaf, base_layer.StackedLeaf):
    return np.stack([_ToNumpy(x) for x in leaf.layers])
  return leaf.detach().cpu().numpy()


def ThetaToNumpy(module: base_layer.BaseLayer):
  """The module's theta in the reference's structure, as numpy copies."""
  return module.ThetaTree().Transform(_ToNumpy)


def OptStatePairs(opt_state, ref_state, name: str = "opt_state") -> list:
  """[(name, port tensor, reference array)] for every leaf of the port's
  optimizer state. The port's state is NestedMaps (the reference's
  containers, by the same names), lists (CompositeOptimizer's subs), 0-d
  tensors (the Accumulator's count) and plain dicts {theta path: slot},
  where the reference holds a theta tree: each path is looked up in the
  flattened tree, an Adafactor slot's names below it. A repeat stack's
  slot is stacked on both sides. A missing leaf or a shape that differs
  raises."""
  out = []

  def _Pair(name, dst, src):
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(dst.shape):
      raise ValueError(f"{name}: reference state {arr.shape} vs port "
                       f"{tuple(dst.shape)}")
    out.append((name, dst, arr))

  def _Walk(dst, src, name):
    if isinstance(dst, NestedMap):
      for k in dst:
        if k not in src:
          raise ValueError(f"{name}.{k}: not in the reference's state")
        _Walk(dst[k], src[k], f"{name}.{k}")
    elif isinstance(dst, (list, tuple)):
      if len(dst) != len(src):
        raise ValueError(f"{name}: {len(src)} reference entries for "
                         f"{len(dst)}")
      for i, (d, s) in enumerate(zip(dst, src)):
        _Walk(d, s, f"{name}[{i}]")
    elif isinstance(dst, dict):
      flat = dict(NestedMap({"t": src}).FlattenItems())
      for path, slot in dst.items():
        if isinstance(slot, NestedMap):
          for k, t in slot.items():
            _Pair(f"{name}.{path}.{k}", t, flat[f"t.{path}.{k}"])
        else:
          _Pair(f"{name}.{path}", slot, flat[f"t.{path}"])
    else:
      _Pair(name, dst, src)

  _Walk(opt_state, ref_state, name)
  return out


def LoadJaxOptState(opt_state, ref_state) -> list[str]:
  """Copies the reference's optimizer state (a structure of numpy arrays)
  into the port's `opt_state` in place; returns the leaves' names."""
  names = []
  with torch.no_grad():
    for name, dst, arr in OptStatePairs(opt_state, ref_state):
      dst.copy_(torch.tensor(arr).to(dst.dtype))
      names.append(name)
  return names


def TrainStatePairs(state, ref_state, name: str = "state") -> list:
  """[(name, port tensor, reference array)] of a train state's tensors:
  each learner's optimizer state, the EMA (a theta tree in the
  reference, {theta path: tensor} in the port) and, for a multi-task
  state, every task's under `tasks.{task}`."""
  if "tasks" in state:
    out = []
    for task in sorted(state.tasks):
      out += TrainStatePairs(state.tasks[task], ref_state["tasks"][task],
                             f"{name}.tasks.{task}")
    return out
  if len(state.opt_states) != len(ref_state["opt_states"]):
    raise ValueError(f"{name}: {len(ref_state['opt_states'])} reference "
                     f"learner states for {len(state.opt_states)}")
  out = []
  for i, (s, r) in enumerate(zip(state.opt_states, ref_state["opt_states"])):
    out += OptStatePairs(s, r, f"{name}.opt_states[{i}]")
  if ("ema_theta" in state) != ("ema_theta" in ref_state):
    raise ValueError(f"{name}: ema_theta in only one of the states")
  if "ema_theta" in state:
    out += OptStatePairs(state.ema_theta, ref_state["ema_theta"],
                         f"{name}.ema_theta")
  return out


def LoadJaxTrainState(state, ref_state) -> list[str]:
  """Copies the reference's train state (numpy, its structure) into the
  port's `state` in place: the tensors of `TrainStatePairs` and the steps
  (a multi-task state's per task too). Theta goes through
  `LoadJaxTheta`. Returns the tensors' names."""
  names = []
  with torch.no_grad():
    for name, dst, arr in TrainStatePairs(state, ref_state):
      dst.copy_(torch.tensor(arr).to(dst.dtype))
      names.append(name)
  state.step = int(ref_state["step"])
  for task in state.get("tasks", {}):
    state.tasks[task].step = int(ref_state["tasks"][task]["step"])
  return names


def Int8ArtifactToTorch(theta, int8_tree) -> dict:
  """{path: {"w_int8", "scale"}} numpy -> {path: (w_int8, scale)} torch
  tensors (int8, float32) on the device of theta's leaf at path; where
  that leaf is a repeat stack's `StackedLeaf`, a list of per-layer pairs,
  the arrays split on their leading [num_layers] axis. A path with no leaf
  in theta, or a shape that does not match it, raises."""
  out = {}
  for path, pair in int8_tree.items():
    leaf = theta.Get(path)
    if leaf is None:
      raise ValueError(f"{path}: int8 artifact path has no theta leaf")
    stacked = isinstance(leaf, base_layer.StackedLeaf)
    device = (leaf.layers[0] if stacked else leaf).device
    if tuple(np.shape(pair["w_int8"])) != tuple(leaf.shape):
      raise ValueError(f"{path}: int8 artifact {np.shape(pair['w_int8'])} "
                       f"vs theta leaf {tuple(leaf.shape)}")

    def _Pair(p, device=device):
      return (torch.tensor(np.asarray(p["w_int8"], np.int8), device=device),
              torch.tensor(np.asarray(p["scale"], np.float32), device=device))

    out[path] = ([_Pair(_Unstack(pair, i)) for i in range(len(leaf.layers))]
                 if stacked else _Pair(pair))
  return out
