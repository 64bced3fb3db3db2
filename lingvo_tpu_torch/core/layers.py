"""Core NN layers the served LM uses (port of part of lingvo_tpu/core/layers.py).

`ProjectionLayer`, `LayerNorm`, `RotaryPositionalEmbeddingLayer` and the
tied `SharedEmbeddingSoftmaxLayer` (lookup with the sqrt(d) scale, logits
with the tanh cap), with the reference's Params field names, weight names
and float32 op order. Only the fields the served models set are ported.
"""

from __future__ import annotations

import math

import torch

from lingvo_tpu_torch.core import activations
from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core.py_utils import WeightInit, WeightParams


class ProjectionLayer(base_layer.BaseLayer):
  """y = act(x @ w + b). Reference: layers.ProjectionLayer."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("input_dim", 0, "Input depth.")
    p.Define("output_dim", 0, "Output depth.")
    p.Define("activation", "NONE", "Activation name.")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    p = self.p
    assert p.input_dim > 0 and p.output_dim > 0, p.name
    self.CreateVariable(
        "w", WeightParams((p.input_dim, p.output_dim), p.params_init, p.dtype))
    self.CreateVariable(
        "b", WeightParams((p.output_dim,), WeightInit.Constant(0.0), p.dtype))

  def FProp(self, inputs):
    out = torch.matmul(inputs, self.w) + self.b
    return activations.GetFn(self.p.activation)(out)


class LayerNorm(base_layer.BaseLayer):
  """Layer normalization over the trailing dim (reference layers.LayerNorm)."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("input_dim", 0, "Depth of the input.")
    p.Define("epsilon", 1e-6, "Variance floor.")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    p = self.p
    assert p.input_dim > 0, p.name
    self.CreateVariable(
        "scale", WeightParams((p.input_dim,), WeightInit.Constant(0.0), p.dtype))
    self.CreateVariable(
        "bias", WeightParams((p.input_dim,), WeightInit.Constant(0.0), p.dtype))

  def FProp(self, inputs):
    p = self.p
    x32 = inputs.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    normed = ((x32 - mean) * torch.rsqrt(var + p.epsilon)).to(inputs.dtype)
    return normed * (1.0 + self.scale) + self.bias


class RotaryPositionalEmbeddingLayer(base_layer.BaseLayer):
  """Rotary position embedding (reference layers.RotaryPositionalEmbeddingLayer)."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("embedding_dim", 0, "Per-head dim to rotate (must be even).")
    p.Define("min_timescale", 1, "Min timescale.")
    p.Define("max_timescale", 1e4, "Max timescale.")
    return p

  def FProp(self, inputs, position):
    """inputs: [..., t, n, h]; position: float32, broadcastable to the
    leading [..., t] dims. Rotates the first embedding_dim features of h;
    the rest pass through (partial rotary).

    The timescale is built in float32 exactly as the reference builds it:
    min * (max / min) ** (arange(half) / half)."""
    p = self.p
    dim = p.embedding_dim or inputs.shape[-1]
    assert dim % 2 == 0 and dim <= inputs.shape[-1], (dim, inputs.shape)
    x_rot, x_pass = inputs[..., :dim], inputs[..., dim:]
    half = dim // 2
    fraction = torch.arange(half, dtype=torch.float32,
                            device=inputs.device) / half
    base = torch.tensor(p.max_timescale / p.min_timescale,
                        dtype=torch.float32, device=inputs.device)
    timescale = p.min_timescale * torch.pow(base, fraction)
    while position.ndim < inputs.ndim:
      position = position[..., None]
    sinusoid = position / timescale
    sin, cos = torch.sin(sinusoid), torch.cos(sinusoid)
    first, second = torch.chunk(x_rot.float(), 2, dim=-1)
    rotated = torch.cat(
        [first * cos - second * sin, second * cos + first * sin], dim=-1)
    rotated = rotated.to(inputs.dtype)
    if x_pass.shape[-1]:
      return torch.cat([rotated, x_pass], dim=-1)
    return rotated


class SharedEmbeddingSoftmaxLayer(base_layer.BaseLayer):
  """Ties the input embedding and the softmax weights (emb: [V, D])."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("vocab_size", 0, "Vocab.")
    p.Define("embedding_dim", 0, "Depth.")
    p.Define("logits_soft_max", 0.0, "If >0, cap logits with tanh.")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    p = self.p
    self.CreateVariable(
        "emb",
        WeightParams(
            shape=(p.vocab_size, p.embedding_dim),
            init=WeightInit.Gaussian(1.0 / math.sqrt(p.embedding_dim)),
            dtype=p.dtype))

  def EmbLookup(self, ids):
    """Rows of the table, scaled by sqrt(embedding_dim)."""
    return self.emb[ids.long()] * math.sqrt(self.p.embedding_dim)

  def Logits(self, inputs):
    logits = torch.matmul(inputs, self.emb.t())
    cap = self.p.logits_soft_max
    if cap > 0:
      logits = cap * torch.tanh(logits / cap)
    return logits
