"""Core NN layers the LM uses (port of part of lingvo_tpu/core/layers.py).

`ProjectionLayer`, `LayerNorm`, `RotaryPositionalEmbeddingLayer`, the
tied `SharedEmbeddingSoftmaxLayer` (lookup with the sqrt(d) scale, logits
with the tanh cap, and the training loss: the dense `XentLossFromLogits`
or, with `xent_block_size > 0`, the fused blockwise xent of
`ops/fused_xent.py`), the step-seeded `DeterministicDropoutLayer` and the
untied `SampledSoftmax` head (log-uniform negatives), with the
reference's Params field names, weight names and op order. Under `fprop_dtype` (bfloat16) each layer casts its
theta and inputs as the reference does (`CastTheta`, `ToFPropDtype`):
the norm's moments, the rotation and the losses stay float32. Only the
fields the DenseLm models set are ported.

Under an int8 serving theta (quant/weights.py, bound by
`base_layer.ServedTheta`) `w` and `emb` are `quant_utils.Int8Weight`s, as
in the reference: the projection and the tied logits run the int8 matmul,
the lookup gathers int8 rows and dequantizes them by their row scale, and
the fused-xent gate sends an int8 table to the dense path.
"""

from __future__ import annotations

import math

import torch

from lingvo_tpu_torch.core import activations
from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import jit_arith
from lingvo_tpu_torch.core import py_utils
from lingvo_tpu_torch.core import quant_utils
from lingvo_tpu_torch.core import threefry
from lingvo_tpu_torch.core.nested_map import NestedMap
from lingvo_tpu_torch.core.py_utils import WeightInit, WeightParams
from lingvo_tpu_torch.ops import fused_xent


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
    th = self.CastTheta()
    x = self.ToFPropDtype(inputs)
    if isinstance(th.w, quant_utils.Int8Weight):
      out = th.w.Einsum(x)   # the int8 serving theta: an integer matmul
    else:
      out = torch.matmul(x, th.w)
    return activations.GetFn(self.p.activation)(out + th.b)


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
    """The moments in float32 (also under bf16 activations); the output in
    the fprop dtype."""
    p = self.p
    th = self.CastTheta()
    x = self.ToFPropDtype(inputs)
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    normed = ((x32 - mean) * torch.rsqrt(var + p.epsilon)).to(x.dtype)
    return normed * (1.0 + th.scale) + th.bias


class RotaryPositionalEmbeddingLayer(base_layer.BaseLayer):
  """Rotary position embedding (reference layers.RotaryPositionalEmbeddingLayer)."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("embedding_dim", 0, "Per-head dim to rotate (must be even).")
    p.Define("min_timescale", 1, "Min timescale.")
    p.Define("max_timescale", 1e4, "Max timescale.")
    return p

  def FProp(self, inputs, position=None):
    """inputs: [..., t, n, h]; position: float32, broadcastable to the
    leading [..., t] dims, or None for arange(t) (the training step).
    Rotates the first embedding_dim features of h; the rest pass through
    (partial rotary).

    The timescale is built in float32 exactly as the reference builds it:
    min * (max / min) ** (arange(half) / half); the rotation runs in
    float32 and its result takes the inputs' dtype."""
    p = self.p
    dim = p.embedding_dim or inputs.shape[-1]
    assert dim % 2 == 0 and dim <= inputs.shape[-1], (dim, inputs.shape)
    x_rot, x_pass = inputs[..., :dim], inputs[..., dim:]
    half = dim // 2
    fraction = torch.arange(half, dtype=torch.float32,
                            device=inputs.device) / half
    # a 0-dim CPU base is the kernel's scalar argument: no copy to a card
    base = torch.tensor(p.max_timescale / p.min_timescale,
                        dtype=torch.float32)
    timescale = p.min_timescale * torch.pow(base, fraction)
    if position is None:
      t_ax = inputs.ndim - 3
      shape = [1] * inputs.ndim
      shape[t_ax] = inputs.shape[t_ax]
      position = torch.arange(inputs.shape[t_ax], dtype=torch.float32,
                              device=inputs.device).reshape(shape)
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
    p.Define("xent_block_size", 0,
             "If >0, FProp with class_ids computes the fused blockwise "
             "xent (ops/fused_xent.py) over the tied table and never "
             "materializes [..., V] logits. 0 = the dense path.")
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
    """Rows of the table (in the fprop dtype), scaled by
    sqrt(embedding_dim). An int8 table: the int8 rows times their row
    scale, in float32, then cast (a lookup has no matmul to run in int8;
    exact against the frozen grid)."""
    emb, ids = self.CastTheta().emb, ids.long()
    if isinstance(emb, quant_utils.Int8Weight):
      rows = (emb.w_int8[ids].float() * emb.scale.float()[ids]).to(
          self.fprop_dtype)
    else:
      rows = emb[ids]
    return rows * py_utils.WeakScalar(math.sqrt(self.p.embedding_dim), rows)

  def Logits(self, inputs):
    """[..., V] logits in the fprop dtype, tanh-capped; an int8 table's
    through the int8 matmul ('vd': [..., D] x [V, D])."""
    th = self.CastTheta()
    if isinstance(th.emb, quant_utils.Int8Weight):
      logits = th.emb.Einsum(self.ToFPropDtype(inputs))
    else:
      logits = torch.matmul(self.ToFPropDtype(inputs), th.emb.t())
    if self.p.logits_soft_max > 0:
      cap = py_utils.WeakScalar(self.p.logits_soft_max, logits)
      logits = cap * py_utils.Tanh(logits / cap)
    return logits

  def FProp(self, inputs, class_ids=None, class_probabilities=None,
            label_smoothing=0.0):
    """NestedMap(per_example_xent, log_probs, logits) on the dense path;
    on the fused path logits and log_probs are None and label_log_probs
    and argmax (int32) come out of the streaming pass instead. An int8
    table takes the dense path (the fused kernel slices a float table)."""
    emb = self.CastTheta().emb
    if (FusedXentEligible(self.p, class_ids, class_probabilities) and
        not isinstance(emb, quant_utils.Int8Weight)):
      # the fused kernel takes the inputs and the table in the fprop dtype
      out = fused_xent.FusedXent(
          self.ToFPropDtype(inputs), emb, class_ids,
          block_size=self.p.xent_block_size,
          logits_soft_max=self.p.logits_soft_max,
          label_smoothing=label_smoothing, weight_layout="vd")
      return NestedMap(per_example_xent=out.per_example_xent,
                       log_probs=None, logits=None,
                       label_log_probs=out.label_log_prob,
                       argmax=out.argmax)
    logits = self.Logits(inputs)
    out = XentLossFromLogits(logits, self.p.vocab_size, class_ids,
                             class_probabilities, label_smoothing)
    out.logits = logits
    return out


def FusedXentEligible(p, class_ids, class_probabilities) -> bool:
  """Gate for the blockwise fused LM-head xent: opted in via
  p.xent_block_size, needs integer labels (dense class_probabilities would
  re-materialize [..., V] anyway)."""
  return (p.xent_block_size > 0 and class_ids is not None
          and class_probabilities is None)


def XentLossFromLogits(logits, num_classes, class_ids=None,
                       class_probabilities=None, label_smoothing=0.0):
  """Softmax cross-entropy in float32; returns NestedMap(per_example_xent,
  log_probs)."""
  log_probs = torch.log_softmax(logits.float(), dim=-1)
  if class_probabilities is None:
    if class_ids is None:
      raise ValueError("XentLossFromLogits needs class_ids or "
                       "class_probabilities")
    class_probabilities = torch.nn.functional.one_hot(
        class_ids.long(), num_classes).float()
  if label_smoothing > 0.0:
    class_probabilities = ((1.0 - label_smoothing) * class_probabilities +
                           label_smoothing / num_classes)
  per_example_xent = -torch.sum(class_probabilities * log_probs, dim=-1)
  return NestedMap(per_example_xent=per_example_xent, log_probs=log_probs)


class DeterministicDropoutLayer(base_layer.BaseLayer):
  """Dropout seeded from the step-seed context (reference
  DeterministicDropoutLayer): the identity in eval mode or with no step
  seed active (serving, eval), so those callers need no keys.

  The mask is `threefry.Bernoulli` of StepSeed(f"{path}/{name_suffix}",
  extra_seed), bit for bit the reference's; kept values are divided by
  keep_prob in the inputs' dtype as the reference's jitted step divides
  by that constant: a product with its float32 reciprocal
  (`jit_arith.Reciprocal`; at bfloat16 the constant is 0.8984375 for
  0.9)."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("keep_prob", 1.0,
             "Keep probability (may be overridden per call).")
    return p

  def FProp(self, inputs, keep_prob=None, name_suffix="", extra_seed=None):
    p = self.p
    kp = p.keep_prob if keep_prob is None else keep_prob
    if kp >= 1.0 or py_utils.DoEval() or not py_utils.HasStepSeed():
      return inputs
    key = py_utils.StepSeed(f"{self.path}/{name_suffix}", extra_seed)
    mask = threefry.Bernoulli(key, kp, inputs.shape, inputs.device)
    scale = jit_arith.Reciprocal(
        torch.tensor(kp, dtype=inputs.dtype).item())
    return torch.where(mask, inputs * scale,
                       torch.zeros((), dtype=inputs.dtype,
                                   device=inputs.device))



class SampledSoftmax(base_layer.BaseLayer):
  """Sampled softmax for large vocabularies (reference SampledSoftmax):
  an untied [V, D] table `w` with its bias `b`.

  Training (a step seed active, not eval) scores each token's label and
  num_sampled log-uniform negatives drawn once per step from
  StepSeed(f"{path}/sampled_softmax"), each logit corrected by its log
  expected count, accidental hits of the label masked. `Logits` gives the dense [..., V] logits (decode,
  serving). The reference's jitted arithmetic is kept: its divisions by
  Python constants are products with their float32 reciprocals
  (`jit_arith.Reciprocal`), and an id is the truncation of
  exp(u * log(V + 1)) - 1 to int32."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("input_dim", 0, "Input depth.")
    p.Define("num_classes", 0, "Full vocabulary size.")
    p.Define("num_sampled", 4096, "Negatives sampled per batch.")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    p = self.p
    assert p.input_dim > 0 and p.num_classes > 0, p.name
    self.CreateVariable(
        "w", WeightParams((p.num_classes, p.input_dim), p.params_init,
                          p.dtype))
    self.CreateVariable(
        "b", WeightParams((p.num_classes,), WeightInit.Constant(0.0),
                          p.dtype))

  def _LogExpectedCount(self, ids):
    """log(num_sampled * P(id)) under the log-uniform sampler, float32."""
    p = self.p
    ids = ids.float()
    log_p = torch.log(torch.log((ids + 2.0) / (ids + 1.0)) *
                      jit_arith.Reciprocal(math.log(p.num_classes + 1.0)))
    return log_p + math.log(p.num_sampled)

  def SampleNegatives(self, key, device):
    """The step's num_sampled negative ids, int32 on `device`: the
    uniforms drawn there, floor(exp(u * log(V + 1))) - 1 clipped to
    [0, V). Above id 2^19 one float32 ulp of exp is 1/16 or more, so a
    device whose exp rounds another way moves a few ids by one."""
    p = self.p
    u = threefry.Uniform01(key, (p.num_sampled,), device)
    ids = torch.exp(u * math.log(p.num_classes + 1.0)) - 1.0
    return torch.clamp(ids.to(torch.int32), 0, p.num_classes - 1)

  def Logits(self, inputs):
    """Dense [..., V] logits in the fprop dtype: x w^T + b."""
    th = self.CastTheta()
    return torch.matmul(self.ToFPropDtype(inputs), th.w.t()) + th.b

  def XentLossFromInputs(self, inputs, class_ids):
    """inputs [..., D], class_ids [...] -> the per-token sampled xent [...]
    (training, under a step seed). The full softmax's loss is the LM's
    fused eval over `w` and `b`, which never builds [..., V] logits."""
    if py_utils.DoEval() or not py_utils.HasStepSeed():
      raise RuntimeError(
          "SampledSoftmax.XentLossFromInputs is the training loss: it needs "
          "a StepSeedContext outside eval mode")
    th = self.CastTheta()
    x = self.ToFPropDtype(inputs)
    neg_ids = self.SampleNegatives(
        py_utils.StepSeed(f"{self.path}/sampled_softmax"), x.device)
    ids = class_ids.long()
    # the label's logit with its correction
    true_logit = torch.sum(x * th.w[ids], -1) + th.b[ids]
    true_logit = true_logit.float() - self._LogExpectedCount(class_ids)
    # the negatives' logits with theirs; a negative equal to the label is
    # masked
    neg = neg_ids.long()
    neg_logits = torch.matmul(x, th.w[neg].t()) + th.b[neg]
    neg_logits = neg_logits.float() - self._LogExpectedCount(neg_ids)
    hit = neg_ids == class_ids[..., None]
    neg_logits = torch.where(hit, -1e9, neg_logits)
    all_logits = torch.cat([true_logit[..., None], neg_logits], -1)
    return -torch.log_softmax(all_logits, dim=-1)[..., 0]
