"""BaseLayer: Params-configured layers as `torch.nn.Module`s.

Port of lingvo_tpu/core/base_layer.py. The reference's layers only declare
weight specs and receive their weights as an explicit theta pytree; here
a layer owns its weights as `nn.Parameter`s, registered under the same
names the reference gives its theta leaves, and children are registered
under the same child names. So a module's `named_parameters()` paths are
the reference's theta paths (with a repeat stack's leading axis unrolled
into a `ModuleList`, see core/transformer.py), which is what lets
`convert.LoadJaxTheta` copy a reference theta leaf for leaf.

Lifecycle:
  p = MyLayer.Params().Set(...); layer = p.Instantiate(device="cuda")
  layer.InstantiateVariables(torch.Generator("cuda").manual_seed(0))
  out = layer.FProp(inputs)

Every layer lives on one explicit device, resolved once at construction
and inherited by its children: `device=None` means CUDA, and raises when
no CUDA device exists rather than running on the CPU unasked.

Weights are trainable `nn.Parameter`s (requires_grad=True): the train step
takes their gradients with `loss.backward()` and its optimizer updates
them in place. The serving step runs under `torch.no_grad()`.
`ThetaTree()` gives the reference's theta structure over the parameters,
which the learner walks and `convert.ThetaToNumpy` exports.

A served theta (`ServedTheta`, the int8 serving theta of
quant/weights.py) takes the reference's explicit theta argument where a
step needs leaves other than the parameters: bound to a module tree, and
active on the calling thread inside `ServedTheta.Active()`, it makes each
layer's `CastTheta()` return its served leaves (`Int8Weight`s) in place
of its parameters. Outside it, or on another thread, the layers compute
with their parameters as before.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Sequence

import torch
from torch import nn

from lingvo_tpu_torch.core import hyperparams
from lingvo_tpu_torch.core import py_utils
from lingvo_tpu_torch.core import quant_utils
from lingvo_tpu_torch.core.nested_map import NestedMap
from lingvo_tpu_torch.core.py_utils import WeightInit, WeightParams


def ResolveDevice(device: Any = None) -> torch.device:
  """The device an entry point runs on: CUDA unless the caller names one.

  Raises when CUDA is asked for (explicitly or by default) and absent."""
  dev = torch.device("cuda" if device is None else device)
  if dev.type == "cuda":
    if not torch.cuda.is_available():
      raise RuntimeError(
          "no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.index is None:
      dev = torch.device("cuda", torch.cuda.current_device())
  return dev


@dataclasses.dataclass(frozen=True)
class StackedLeaf:
  """One theta leaf of a repeat stack: the per-layer parameters that the
  reference keeps stacked on a leading [num_layers] axis, in layer order."""

  layers: tuple

  @property
  def shape(self) -> tuple:
    return (len(self.layers),) + tuple(self.layers[0].shape)


# The served theta active on this thread: {layer: the layer's theta, its
# parameters with the served leaves in their place}.
_SERVED = threading.local()


class _CastLeaves(NestedMap):
  """A layer's leaves bound by a `ServedTheta` already in its fprop dtype:
  `CastTheta()` returns them as they are."""


class ServedTheta:
  """A theta served in place of a module tree's own parameters.

  `theta` has the structure of `module.ThetaTree()`; each of its leaves
  that is not the module's own parameter (an `Int8Weight`, or a StackedLeaf
  whose per-layer members replace a repeat stack's parameters) is bound to
  the layer that owns that parameter. A layer whose fprop dtype is not its
  weights' dtype (fprop_dtype=bfloat16) has its leaves bound already cast
  to it, once, here (its own parameters too): `CastTheta()` then finds
  them in that dtype and copies nothing per step, and their values are
  the bits of the per-forward cast. Inside `Active()` the calling
  thread's layers see those leaves through `CastTheta()`; nothing changes
  for other threads or outside the context."""

  def __init__(self, module: nn.Module, theta: NestedMap):
    self.theta = theta
    self._leaves: dict = {}
    with torch.no_grad():
      self._Bind(module, theta)

  def _Bind(self, module, tree):
    params = dict(module.named_parameters(recurse=False))
    leaves = NestedMap({name: tree[name] for name in params})
    if params and isinstance(module, BaseLayer) and (
        module.fprop_dtype != module.p.dtype):
      self._leaves[module] = _CastLeaves(module.CastTheta(leaves))
    elif any(tree[name] is not prm for name, prm in params.items()):
      self._leaves[module] = leaves
    for cname, child in module.named_children():
      if cname not in tree:
        continue   # a child without weights
      sub = tree[cname]
      if isinstance(child, nn.ModuleList):
        if not isinstance(sub, list):
          # a repeat stack: every leaf a StackedLeaf, member i for layer i
          sub = [sub.Transform(lambda leaf, i=i: leaf.layers[i])
                 for i in range(len(child))]
        for c, s in zip(child, sub):
          self._Bind(c, s)
      else:
        self._Bind(child, sub)

  @contextlib.contextmanager
  def Active(self):
    """Makes this theta the one the calling thread's layers see."""
    prev = getattr(_SERVED, "leaves", None)
    _SERVED.leaves = self._leaves
    try:
      yield self
    finally:
      _SERVED.leaves = prev


class BaseLayer(nn.Module):
  """Base class for all layers of the port."""

  @classmethod
  def Params(cls) -> hyperparams.InstantiableParams:
    p = hyperparams.InstantiableParams(cls)
    p.Define("name", "", "Layer name; forms variable paths.")
    p.Define("dtype", torch.float32, "Weight dtype.")
    p.Define("fprop_dtype", None,
             "Activation dtype (torch.bfloat16 for mixed precision). None "
             "= use dtype.")
    p.Define("params_init", WeightInit.Xavier(),
             "Default weight initializer for this layer.")
    return p

  def __init__(self, params: hyperparams.InstantiableParams, device=None):
    super().__init__()
    if not params.name:
      params = params.Copy().Set(name=type(self).__name__.lower())
    self._params = params.Copy()
    self._params.Freeze()
    self.device = ResolveDevice(device)
    self._variable_specs: dict[str, WeightParams] = {}
    self._path: str | None = None

  # ---- properties ----------------------------------------------------------

  @property
  def params(self) -> hyperparams.InstantiableParams:
    return self._params

  @property
  def p(self) -> hyperparams.InstantiableParams:
    return self._params

  @property
  def fprop_dtype(self):
    p = self.p
    return p.fprop_dtype if p.fprop_dtype is not None else p.dtype

  @property
  def path(self) -> str:
    """Full slash path from the root layer (set by FinalizePaths)."""
    return self._path if self._path is not None else self.p.name

  def FinalizePaths(self, root_path: str | None = None) -> None:
    """Assigns full paths to this layer tree, as the reference names them."""
    self._AssignPaths(root_path or self.p.name)

  def _AssignPaths(self, path: str) -> None:
    self._path = path
    for cname, child in self.named_children():
      if isinstance(child, nn.ModuleList):
        for i, c in enumerate(child):
          c._AssignPaths(f"{path}/{cname}_{i}")
      else:
        child._AssignPaths(f"{path}/{cname}")

  # ---- construction API ----------------------------------------------------

  def CopyBaseParams(self, child_p: hyperparams.InstantiableParams
                     ) -> hyperparams.InstantiableParams:
    """Propagates dtype, fprop_dtype and a non-default init down to a
    child (the reference rule)."""
    p = self.p
    if ("dtype" in child_p and child_p.dtype == torch.float32 and
        p.dtype != torch.float32):
      child_p.dtype = p.dtype
    if "fprop_dtype" in child_p and child_p.fprop_dtype is None:
      child_p.fprop_dtype = p.fprop_dtype
    if ("params_init" in child_p and
        child_p.params_init == WeightInit.Xavier() and
        p.params_init != WeightInit.Xavier()):
      child_p.params_init = p.params_init
    return child_p

  def _Instantiate(self, child_params, default_name: str):
    cp = child_params.Copy()
    if "name" in cp and not cp.name:
      cp.name = default_name
    self.CopyBaseParams(cp)
    return cp.Instantiate(device=self.device)

  def CreateChild(self, name: str,
                  child_params: hyperparams.InstantiableParams):
    """Instantiates a child layer under `name`, on this layer's device."""
    if name in self._modules:
      raise ValueError(f"Child {name!r} already exists on {self.p.name}")
    child = self._Instantiate(child_params, name)
    self.add_module(name, child)
    return child

  def CreateChildren(self, name: str,
                     params_list: Sequence[hyperparams.InstantiableParams]):
    """Instantiates a list of child layers under `name` (a ModuleList)."""
    if name in self._modules:
      raise ValueError(f"Children {name!r} already exist on {self.p.name}")
    children = nn.ModuleList(
        [self._Instantiate(cp, f"{name}_{i}")
         for i, cp in enumerate(params_list)])
    self.add_module(name, children)
    return children

  def CreateVariable(self, name: str, wp: WeightParams):
    """Registers an (uninitialized) trainable parameter;
    InstantiateVariables fills it."""
    if name in self._variable_specs:
      raise ValueError(f"Variable {name!r} already declared on {self.p.name}")
    if wp.dtype != torch.float32:
      raise NotImplementedError(
          f"{self.p.name}/{name}: only float32 weights are ported; bf16 and "
          "int8 weights come with the quantized-serving slice")
    self._variable_specs[name] = wp
    self.register_parameter(name, nn.Parameter(
        torch.empty(wp.shape, dtype=wp.dtype, device=self.device),
        requires_grad=True))

  def ThetaTree(self) -> NestedMap:
    """This layer's parameters in the reference's theta structure: own
    weights by name, children by child name (a ModuleList as a list),
    children without weights left out. The tensors are the parameters
    themselves, not copies."""
    tree = NestedMap()
    for name, prm in self.named_parameters(recurse=False):
      tree[name] = prm
    for cname, child in self.named_children():
      if isinstance(child, nn.ModuleList):
        sub = [c.ThetaTree() for c in child]
      else:
        sub = child.ThetaTree()
      if any(True for _ in child.parameters()):
        tree[cname] = sub
    return tree

  # ---- fprop dtype -----------------------------------------------------------

  def ToFPropDtype(self, x):
    return py_utils.MaybeBfloat16(x, self.fprop_dtype)

  def CastTheta(self, theta: NestedMap | None = None) -> NestedMap:
    """Floating theta leaves cast to the fprop dtype (the bf16 activations
    policy), `StackedLeaf`s layer by layer; an `Int8Weight` keeps its
    integer values and casts its scale. The casts are differentiable: the
    float32 parameters get float32 gradients. theta=None: this layer's own
    parameters, with the leaves of the `ServedTheta` active on this thread
    in their place. With fprop_dtype unset (or equal to dtype) the leaves
    come back as they are."""
    if theta is None:
      # the parameter objects live as long as the layer (loads and moves
      # fill them in place), so the map of them is built once
      theta = self.__dict__.get("_own_theta")
      if theta is None:
        theta = NestedMap(dict(self.named_parameters(recurse=False)))
        self.__dict__["_own_theta"] = theta
      served = getattr(_SERVED, "leaves", None)
      if served:
        theta = served.get(self, theta)
        if isinstance(theta, _CastLeaves):
          return theta
    dtype = self.fprop_dtype
    if dtype == self.p.dtype:
      return theta

    def _Cast(leaf):
      if isinstance(leaf, StackedLeaf):
        return StackedLeaf(tuple(_Cast(x) for x in leaf.layers))
      if isinstance(leaf, quant_utils.Int8Weight):
        return leaf.WithScale(py_utils.MaybeBfloat16(leaf.scale, dtype))
      return py_utils.MaybeBfloat16(leaf, dtype)

    return theta.Transform(_Cast)

  # ---- variable materialization --------------------------------------------

  @torch.no_grad()
  def InstantiateVariables(self, generator: torch.Generator) -> "BaseLayer":
    """Initializes every weight of the tree from `generator`, in module
    registration order (deterministic for a given seed and generator
    device). A generator on another device than a weight fills a buffer
    on its own device that is then copied in: a CPU generator gives the
    same weights on the card as on the CPU."""
    if self._path is None:
      self.FinalizePaths()
    for module in self.modules():
      for name, wp in getattr(module, "_variable_specs", {}).items():
        prm = getattr(module, name)
        if prm.device == generator.device:
          py_utils.InitWeight(prm, wp, generator)
        else:
          buf = torch.empty(prm.shape, dtype=prm.dtype,
                            device=generator.device)
          prm.copy_(py_utils.InitWeight(buf, wp, generator))
    return self
