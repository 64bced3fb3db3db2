"""Int8 weight serving: rewrite a theta so the decode matmuls run in int8 (port of lingvo_tpu/quant/weights.py).

The consumer side of the reference's export path: it rewrites a theta,
either the live float theta (`Int8ServingTheta`) or a restored frozen one
with its exported (w_int8, scale) pairs (`Int8ServingThetaFromArtifact`),
so that the leaves the decode projections touch become
`quant_utils.Int8Weight` nodes, which ProjectionLayer, the attention
projections and SharedEmbeddingSoftmaxLayer route through the int8
matmul.

A theta here is the port's `BaseLayer.ThetaTree()`: the reference's paths,
with a repeat stack's leaves as `base_layer.StackedLeaf`s of per-layer
tensors. A stacked leaf is quantized layer by layer, one scale set per
layer (the reference's vmap over the repeat axis), into a StackedLeaf of
per-layer `Int8Weight`s. The rewrite returns a new theta and leaves the
module's float parameters as they are: the serving engine or decoder that
asked for it binds it to the module (`base_layer.ServedTheta`) for its own
steps only.

Layouts: an integer matmul can only fold a scale out of the accumulator
if the scale is constant along the contraction axes, so each leaf's
layout is keyed by how its einsum contracts it. MoE expert weights are not
in the port.
"""

from __future__ import annotations

import torch

from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import quant_utils
from lingvo_tpu_torch.core import ssm

# Leaf name -> (layout, contract_ndim) for serving-eligible weights, keyed
# by how each consuming einsum contracts the weight:
#   w        [in, out]   "...i,io->...o"    contract in      -> dv, 1
#   w_query/ [D, N, H]   "BTD,DNH->BTNH"    contract D       -> dv, 1
#   w_key/w_value
#   w_post   [D, N, H]   "BTNH,DNH->BTD"    contract (N, H)  -> vd, 2
#   emb      [V, D]      "...d,vd->...v"    contract D       -> vd, 1
#                        (EmbLookup gathers int8 rows and dequantizes by
#                         the per-row scale instead of a matmul)
SERVING_WEIGHT_LAYOUTS = {
    "w": ("dv", 1),
    "w_query": ("dv", 1),
    "w_key": ("dv", 1),
    "w_value": ("dv", 1),
    "w_post": ("vd", 2),
    "emb": ("vd", 1),
}


def WeightLayoutFor(name: str):
  """(layout, contract_ndim) for a leaf name; the legacy all-but-last-dim
  reduction (dv, None) for artifact-only names."""
  return SERVING_WEIGHT_LAYOUTS.get(name, ("dv", None))


def _LeafName(path: str) -> str:
  return path.rsplit(".", 1)[-1]


def IsStackedPath(path: str) -> bool:
  """Repeated stacks keep the body theta with a leading repeat axis that
  is sliced off before any einsum sees the weight: quantization treats it
  as a batch axis (one scale set PER REPEAT), never as a contraction
  axis."""
  return ".body." in f".{path}."


def QuantizeLeafInt8(leaf, layout, contract_ndim, stacked):
  """float leaf -> Int8Weight under the given layout; a stacked leaf (a
  StackedLeaf) -> a StackedLeaf of per-layer Int8Weights."""
  if not stacked:
    return quant_utils.Int8Weight.Quantize(leaf, layout=layout,
                                           contract_ndim=contract_ndim)
  return base_layer.StackedLeaf(tuple(
      quant_utils.Int8Weight.Quantize(w, layout=layout,
                                      contract_ndim=contract_ndim)
      for w in leaf.layers))


def _Dequant(w8, like):
  """An Int8Weight (or a StackedLeaf of them) as its float grid in the
  dtype of `like` (a tensor or a StackedLeaf)."""
  if isinstance(w8, base_layer.StackedLeaf):
    return base_layer.StackedLeaf(tuple(
        x.Dequant().to(y.dtype) for x, y in zip(w8.layers, like.layers)))
  return w8.Dequant().to(like.dtype)


def _Dtype(leaf):
  return (leaf.layers[0] if isinstance(leaf, base_layer.StackedLeaf)
          else leaf).dtype


def Int8ServingTheta(theta, mode: str = "int8"):
  """Rewrite serving-eligible leaves of `theta` -> (new_theta, paths).

  mode='int8' replaces each eligible float leaf with an `Int8Weight`
  (integer matmuls at serve time). mode='dequant' replaces it with the
  plain float dequantization grid `w_int8 * scale`."""
  assert mode in ("int8", "dequant"), mode
  new_theta = theta.DeepCopy()
  paths = []
  with torch.no_grad():
    for path, leaf in theta.FlattenItems():
      name = _LeafName(path)
      if name not in SERVING_WEIGHT_LAYOUTS:
        continue
      stacked = IsStackedPath(path)
      if not hasattr(leaf, "shape") or len(leaf.shape) < (3 if stacked
                                                          else 2):
        continue
      if not _Dtype(leaf).is_floating_point:
        continue
      layout, k = SERVING_WEIGHT_LAYOUTS[name]
      w8 = QuantizeLeafInt8(leaf, layout, k, stacked)
      new_theta.Set(path, _Dequant(w8, leaf) if mode == "dequant" else w8)
      paths.append(path)
  if not paths:
    raise ValueError("Int8ServingTheta: no serving-eligible leaves found")
  return new_theta, paths


def Int8ServingThetaFromArtifact(theta, int8_tree, mode: str = "int8"):
  """Build a serving theta from an exported `theta_int8` artifact.

  `theta` is the restored frozen theta (every eligible leaf already equals
  its dequantization grid); `int8_tree` is the reference's {path:
  {"w_int8", "scale"}} as numpy, a stacked path's arrays with their
  leading repeat axis (split per layer here, `convert.Int8ArtifactToTorch`).
  Only paths whose leaf name has a serving layout are rewritten;
  artifact-only paths stay as their frozen floats."""
  assert mode in ("int8", "dequant"), mode
  new_theta = theta.DeepCopy()
  paths = []
  pairs = convert.Int8ArtifactToTorch(
      theta, {p: v for p, v in int8_tree.items()
              if _LeafName(p) in SERVING_WEIGHT_LAYOUTS})
  for path, pair in pairs.items():
    layout, k = SERVING_WEIGHT_LAYOUTS[_LeafName(path)]
    if isinstance(pair, list):
      w8 = base_layer.StackedLeaf(tuple(
          quant_utils.Int8Weight(w, s, layout=layout, contract_ndim=k)
          for w, s in pair))
    else:
      w8 = quant_utils.Int8Weight(*pair, layout=layout, contract_ndim=k)
    new_theta.Set(path, _Dequant(w8, theta.GetItem(path))
                  if mode == "dequant" else w8)
    paths.append(path)
  if not paths:
    raise ValueError(
        "Int8ServingThetaFromArtifact: artifact has no serving-eligible "
        "paths")
  return new_theta, paths


def CheckInt8Servable(task) -> None:
  """Raises for a task whose int8 serving theta a layer cannot consume:
  the SSM mixer (`core/ssm.GatedSSMLayer`) contracts its eligible `w_post`
  leaf with a plain einsum, which takes no Int8Weight. The reference
  rewrites it all the same and fails at the first step; the port refuses
  the engine or decoder instead."""
  mixers = sorted({m.path for m in task.modules()
                   if isinstance(m, ssm.GatedSSMLayer)})
  if mixers:
    raise NotImplementedError(
        f"int8 weight serving of an SSM mixer (GatedSSMLayer at "
        f"{mixers[0]}{' and others' if len(mixers) > 1 else ''}): its "
        "w_post einsum takes no Int8Weight, in the reference too (which "
        "fails at its first step); the SSM stacks serve float weights")


def ServingTheta(task, serve_int8_weights: bool = False):
  """The theta a serving entry point (the engine, `GShardDecode`) binds
  to `task` for its steps: a `base_layer.ServedTheta` of the int8 rewrite
  of its parameters (`Int8ServingTheta`) with serve_int8_weights, else of
  its parameters, cast once to the fprop dtype where a layer's differs
  from its weights' (fprop_dtype=bfloat16; the ServedTheta does the
  cast). None when the task's own parameters serve as they are."""
  bf16 = any(m.fprop_dtype != m.p.dtype for m in task.modules()
             if isinstance(m, base_layer.BaseLayer))
  if not serve_int8_weights and not bf16:
    return None
  theta = task.ThetaTree()
  if serve_int8_weights:
    theta, _ = Int8ServingTheta(theta)
  return base_layer.ServedTheta(task, theta)
