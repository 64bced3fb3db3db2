"""Transformer layers and stacks, training FProp and serving step (port of lingvo_tpu/core/transformer.py).

`TransformerFeedForwardLayer`, `TransformerAttentionLayer` and
`TransformerLayer` keep the reference's pre-LN/residual structure and child
names; `TransformerLayer.mixer_tpl` swaps the attention inside
`self_atten` for another sequence mixer (`core/ssm.GatedSSMLayer`).
`StackedTransformerLayers` holds N distinct layers, from one template or
from explicit per-layer `layer_tpls` (the hybrid attention/SSM stacks).
`RepeatedTransformerLayer` is where the port differs in form: the
reference keeps one body with every weight stacked on a leading axis and
scans it; here `body` is an `nn.ModuleList` of num_layers bodies walked
in a Python loop (the converter unstacks the reference's axis into it). A
body is a `TransformerLayer` or, for the hybrid, a
`StackedTransformerLayers` block such as [ssm x 5, attention].
Its `remat_policy='full'` wraps each layer of the loop in
`torch.utils.checkpoint` (the reference's `jax.checkpoint` of the scan
body): only the layer boundaries are saved and the backward recomputes
each layer's forward. The repeat's KV pools and decode caches stay
stacked, [num_layers, pages, P, N, H] and [num_layers, B, S, N, H], as in
the reference, and each layer updates its own slice in place (the SSM
layers' slot states likewise); the decode caches' host-int time_step is
one for the whole repeat.

Every layer serves the three decode contracts of the reference:
`InitStates` / `ExtendStep` / `Prefill` (incremental decode over a dense
per-batch cache, GShardDecode), `InitPagedStates` / `PagedStep` (the
legacy serving step, [B, C] rows) and `RaggedStep` (the packed serving
step). `PagedStep` dispatches per mixer, so an SSM layer's own
`PagedStep` serves its slot state.

Only the Params fields the DenseLm and 1B-words models set are ported
(the residual and ReLU dropouts, drawn from the step seed; no gating or
cross-attention fields). The repeat's layers all take the reference's one
body path, and layer i folds i into its dropout seeds (`StepSeedSalt`),
as the reference's scan does; under remat the forward's seed state is
passed into the checkpointed function, so the backward's recompute draws
the same masks.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils import checkpoint as checkpoint_lib

from lingvo_tpu_torch.core import activations
from lingvo_tpu_torch.core import attention as attention_lib
from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import layers as layers_lib
from lingvo_tpu_torch.core import py_utils
from lingvo_tpu_torch.core.nested_map import NestedMap


class TransformerFeedForwardLayer(base_layer.BaseLayer):
  """Pre-LN FFN with residual."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("input_dim", 0, "Model dim.")
    p.Define("hidden_dim", 0, "Inner dim.")
    p.Define("activation", "RELU", "Inner activation.")
    p.Define("residual_dropout_prob", 0.0, "Dropout on the residual add.")
    p.Define("relu_dropout_prob", 0.0, "Dropout after the inner activation.")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    p = self.p
    assert p.input_dim > 0 and p.hidden_dim > 0
    self.CreateChild("ln",
                     layers_lib.LayerNorm.Params().Set(input_dim=p.input_dim))
    self.CreateChild(
        "ffn_in",
        layers_lib.ProjectionLayer.Params().Set(
            input_dim=p.input_dim, output_dim=p.hidden_dim))
    self.CreateChild(
        "ffn_out",
        layers_lib.ProjectionLayer.Params().Set(
            input_dim=p.hidden_dim, output_dim=p.input_dim))
    self.CreateChild("dropout", layers_lib.DeterministicDropoutLayer.Params())

  def FProp(self, inputs, paddings=None):
    p = self.p
    h = activations.GetFn(p.activation)(
        self.ffn_in.FProp(self.ln.FProp(inputs)))
    if p.relu_dropout_prob > 0:
      h = self.dropout.FProp(h, keep_prob=1.0 - p.relu_dropout_prob,
                             name_suffix="relu")
    out = self.ffn_out.FProp(h)
    if p.residual_dropout_prob > 0:
      out = self.dropout.FProp(out, keep_prob=1.0 - p.residual_dropout_prob,
                               name_suffix="res")
    if paddings is not None:
      out = py_utils.ApplyPadding(paddings, out)
    return inputs + out


class TransformerAttentionLayer(base_layer.BaseLayer):
  """Pre-LN attention block with residual."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("input_dim", 0, "Model dim.")
    p.Define("num_heads", 8, "Heads.")
    p.Define("atten_tpl", attention_lib.MultiHeadedAttention.Params(),
             "Attention template.")
    p.Define("is_masked", False, "Causal self-attention.")
    p.Define("residual_dropout_prob", 0.0, "Residual dropout.")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    p = self.p
    self.CreateChild("ln",
                     layers_lib.LayerNorm.Params().Set(input_dim=p.input_dim))
    atten_p = p.atten_tpl.Copy().Set(
        input_dim=p.input_dim,
        hidden_dim=p.atten_tpl.hidden_dim or p.input_dim,
        num_heads=p.num_heads)
    self.CreateChild("atten", atten_p)
    self.CreateChild("dropout", layers_lib.DeterministicDropoutLayer.Params())

  def FProp(self, query_vec, paddings=None, atten_mask=None,
            segment_ids=None):
    """Self-attention; causality is passed as a flag (not a materialized
    mask) so the fused flash kernel can take over when eligible."""
    p = self.p
    x = self.ln.FProp(query_vec)
    out, probs = self.atten.FProp(x, paddings=paddings, atten_mask=atten_mask,
                                  segment_ids=segment_ids,
                                  causal=p.is_masked)
    if p.residual_dropout_prob > 0:
      out = self.dropout.FProp(out, keep_prob=1.0 - p.residual_dropout_prob)
    return query_vec + out, probs

  def InitStates(self, batch_size, max_len):
    return self.atten.InitStates(batch_size, max_len)

  def ExtendStep(self, query_vec, cached_states, cache_paddings=None):
    return self._Step("ExtendStep", query_vec, cached_states,
                      paddings=cache_paddings)

  def Prefill(self, query_vec, cached_states, cache_paddings=None,
              live_len=None):
    """Whole-chunk cache priming: query_vec [B, C, D] -> ([B, C, D],
    states)."""
    return self._Step("Prefill", query_vec, cached_states,
                      paddings=cache_paddings, live_len=live_len)

  def InitPagedStates(self, num_pages, page_size, num_slots=0,
                      kv_cache_dtype=None):
    return self.atten.InitPagedStates(num_pages, page_size,
                                      num_slots=num_slots,
                                      kv_cache_dtype=kv_cache_dtype)

  def PagedStep(self, query_vec, cached_states, block_tables, q_pos, in_len):
    return self._Step("PagedStep", query_vec, cached_states, block_tables,
                      q_pos, in_len)

  def RaggedStep(self, query_vec, cached_states, block_tables, rows):
    return self._Step("RaggedStep", query_vec, cached_states, block_tables,
                      rows)

  def _Step(self, method, query_vec, cached_states, *args, **kw):
    """The pre-LN/residual wrapper around the mixer's `method`."""
    x = self.ln.FProp(query_vec)
    out, new_states = getattr(self.atten, method)(x, cached_states, *args,
                                                  **kw)
    return query_vec + out, new_states


class TransformerLayer(base_layer.BaseLayer):
  """Self-attention + FFN (decoder-only)."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("input_dim", 0, "Model dim.")
    p.Define("num_heads", 8, "Heads.")
    p.Define("hidden_dim", 0, "FFN inner dim (0 = 4*input).")
    p.Define("mask_self_atten", False, "Causal self-attention (decoder).")
    p.Define("tr_atten_tpl", TransformerAttentionLayer.Params(),
             "Self-attention template.")
    p.Define("tr_fflayer_tpl", TransformerFeedForwardLayer.Params(),
             "FFN template.")
    p.Define(
        "mixer_tpl", None,
        "Optional sequence-mixer template replacing the self-attention "
        "inner layer (e.g. ssm.GatedSSMLayer.Params()); the pre-LN/residual "
        "wrapper and the serving contract are shared. None = keep "
        "tr_atten_tpl.atten_tpl.")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    p = self.p
    atten_p = p.tr_atten_tpl.Copy().Set(
        input_dim=p.input_dim, num_heads=p.num_heads,
        is_masked=p.mask_self_atten)
    if p.mixer_tpl is not None:
      atten_p.atten_tpl = p.mixer_tpl.Copy()
    self.CreateChild("self_atten", atten_p)
    self.CreateChild(
        "fflayer",
        p.tr_fflayer_tpl.Copy().Set(
            input_dim=p.input_dim,
            hidden_dim=p.hidden_dim or 4 * p.input_dim))

  def FProp(self, inputs, paddings=None, segment_ids=None):
    x, _ = self.self_atten.FProp(inputs, paddings=paddings,
                                 segment_ids=segment_ids)
    return self.fflayer.FProp(x, paddings)

  def InitStates(self, batch_size, max_len):
    return NestedMap(
        self_atten=self.self_atten.InitStates(batch_size, max_len))

  def ExtendStep(self, inputs, cached_states, cache_paddings=None):
    return self._Step("ExtendStep", inputs, cached_states,
                      cache_paddings=cache_paddings)

  def Prefill(self, inputs, cached_states, cache_paddings=None,
              live_len=None):
    return self._Step("Prefill", inputs, cached_states,
                      cache_paddings=cache_paddings, live_len=live_len)

  def InitPagedStates(self, num_pages, page_size, num_slots=0,
                      kv_cache_dtype=None):
    return NestedMap(self_atten=self.self_atten.InitPagedStates(
        num_pages, page_size, num_slots=num_slots,
        kv_cache_dtype=kv_cache_dtype))

  def PagedStep(self, inputs, cached_states, block_tables, q_pos, in_len):
    return self._Step("PagedStep", inputs, cached_states, block_tables,
                      q_pos, in_len)

  def RaggedStep(self, inputs, cached_states, block_tables, rows):
    return self._Step("RaggedStep", inputs, cached_states, block_tables,
                      rows)

  def _Step(self, method, inputs, cached_states, *args, **kw):
    x, new_sa = getattr(self.self_atten, method)(
        inputs, cached_states.self_atten, *args, **kw)
    return self.fflayer.FProp(x), NestedMap(self_atten=new_sa)


class StackedTransformerLayers(base_layer.BaseLayer):
  """N distinct transformer layers."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("num_layers", 0, "Depth.")
    p.Define("transformer_layer_params_tpl", TransformerLayer.Params(),
             "Per-layer template.")
    p.Define(
        "layer_tpls", None,
        "Optional explicit per-layer templates (a list of num_layers "
        "TransformerLayer Params) overriding transformer_layer_params_tpl: "
        "the hook of the heterogeneous (hybrid attention/SSM) stacks, and "
        "of the repeat body [ssm, ..., attention].")
    p.Define("final_ln", True, "LayerNorm on the final output.")
    p.Define("input_dim", 0, "Model dim (propagated to layers).")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    p = self.p
    assert p.num_layers > 0
    if p.layer_tpls:
      assert len(p.layer_tpls) == p.num_layers, (
          len(p.layer_tpls), p.num_layers)
      tpls = [t.Copy() for t in p.layer_tpls]
    else:
      tpls = [p.transformer_layer_params_tpl.Copy()
              for _ in range(p.num_layers)]
    if p.input_dim:
      for t in tpls:
        t.input_dim = p.input_dim
    self.CreateChildren("x_layers", tpls)
    if p.final_ln:
      self.CreateChild(
          "final_ln",
          layers_lib.LayerNorm.Params().Set(
              input_dim=p.input_dim or tpls[0].input_dim))

  def _FinalLn(self, x):
    return self.final_ln.FProp(x) if self.p.final_ln else x

  def FProp(self, inputs, paddings=None, segment_ids=None):
    x = inputs
    for layer in self.x_layers:
      x = layer.FProp(x, paddings, segment_ids)
    return self._FinalLn(x)

  def InitStates(self, batch_size, max_len):
    return NestedMap(x_layers=[
        layer.InitStates(batch_size, max_len) for layer in self.x_layers])

  def ExtendStep(self, inputs, cached_states, cache_paddings=None):
    return self._Step("ExtendStep", inputs, cached_states,
                      cache_paddings=cache_paddings)

  def Prefill(self, inputs, cached_states, cache_paddings=None,
              live_len=None):
    return self._Step("Prefill", inputs, cached_states,
                      cache_paddings=cache_paddings, live_len=live_len)

  def InitPagedStates(self, num_pages, page_size, num_slots=0,
                      kv_cache_dtype=None):
    return NestedMap(x_layers=[
        layer.InitPagedStates(num_pages, page_size, num_slots=num_slots,
                              kv_cache_dtype=kv_cache_dtype)
        for layer in self.x_layers
    ])

  def PagedStep(self, inputs, cached_states, block_tables, q_pos, in_len):
    return self._Step("PagedStep", inputs, cached_states, block_tables,
                      q_pos, in_len)

  def RaggedStep(self, inputs, cached_states, block_tables, rows):
    return self._Step("RaggedStep", inputs, cached_states, block_tables,
                      rows)

  def _Step(self, method, inputs, cached_states, *args, **kw):
    """Runs the layers' `method` in order; each updates its own states in
    place. Returns (out, the layers' returned states)."""
    x = inputs
    new_states = NestedMap(x_layers=[])
    for i, layer in enumerate(self.x_layers):
      x, ns = getattr(layer, method)(x, cached_states.x_layers[i], *args,
                                     **kw)
      new_states.x_layers.append(ns)
    return self._FinalLn(x), new_states


def _RematContexts():
  """`torch.utils.checkpoint`'s context_fn: nothing around a layer's
  forward, and a `remat_replay` profiler range around the backward's
  recompute of it, so that a profile can tell the replay's kernels from
  the forward's (a no-op when no profiler runs)."""
  return (contextlib.nullcontext(),
          torch.profiler.record_function("remat_replay"))


class RepeatedTransformerLayer(base_layer.BaseLayer):
  """N identical-architecture bodies; `body` is their ModuleList."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("num_layers", 0, "Repeat count.")
    p.Define("body", TransformerLayer.Params(),
             "The repeated layer: a TransformerLayer, or a "
             "StackedTransformerLayers block (the hybrid stacks).")
    p.Define(
        "remat_policy", "full",
        "What the per-layer checkpoint saves: 'full' = only the layer "
        "boundary, the backward recomputes the layer; 'none' = no remat; "
        "'dots' (save matmul outputs) comes with a later training slice.")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    assert self.p.num_layers > 0
    if self.p.remat_policy not in ("full", "dots", "none"):
      raise ValueError(f"remat_policy {self.p.remat_policy!r}")
    self.CreateChildren("body", [self.p.body] * self.p.num_layers)

  def _AssignPaths(self, path: str) -> None:
    """Every layer of the loop takes the reference's one body path,
    `{path}/body`: the reference scans a single body, and its layers'
    dropout seeds differ only by the layer index folded in as a salt."""
    self._path = path
    for layer in self.body:
      layer._AssignPaths(f"{path}/body")

  def ThetaTree(self) -> NestedMap:
    """The reference's repeat theta: each leaf of the body as a
    StackedLeaf of the num_layers per-layer parameters."""
    trees = [layer.ThetaTree() for layer in self.body]
    leaves = zip(*(t.Flatten() for t in trees))
    return NestedMap(body=trees[0].Pack(
        [base_layer.StackedLeaf(tuple(ls)) for ls in leaves]))

  def FProp(self, inputs, paddings=None, segment_ids=None):
    """Runs the layers in order. Under remat_policy='full' (and with grad
    enabled) each layer is a `torch.utils.checkpoint` region: its
    activations are freed after the forward and recomputed, flash forward
    kernel included, when the backward reaches it."""
    p = self.p
    remat = p.remat_policy != "none" and torch.is_grad_enabled()
    if remat and p.remat_policy == "dots":
      raise NotImplementedError(
          "remat_policy='dots' (save matmul outputs) comes with a later "
          "training slice of the port; use 'full' or 'none'")
    x = inputs
    for i, layer in enumerate(self.body):
      # layer i's dropout seeds fold in i, as the reference's scan index
      with py_utils.StepSeedSalt(i):
        if remat:
          # the seeds the forward saw go into the checkpointed function:
          # its recompute runs inside backward(), outside these contexts
          x = checkpoint_lib.checkpoint(
              py_utils.InSeedState, py_utils.CurrentSeedState(),
              layer.FProp, x, paddings, segment_ids, use_reentrant=False,
              context_fn=_RematContexts)
        else:
          x = layer.FProp(x, paddings, segment_ids)
    return x

  def _Stacked(self, one: NestedMap) -> NestedMap:
    """One body's states stacked on a leading [num_layers] axis; host ints
    (a decode cache's time_step) stay one value for the whole repeat."""
    n = self.p.num_layers
    return NestedMap(body=one.Transform(
        lambda x: x.new_zeros((n,) + tuple(x.shape))
        if isinstance(x, torch.Tensor) else x))

  @staticmethod
  def _Slice(body_states: NestedMap, i: int) -> NestedMap:
    return body_states.Transform(
        lambda s: s[i] if isinstance(s, torch.Tensor) else s)

  def InitStates(self, batch_size, max_len):
    """Every body's decode caches stacked on a leading [num_layers] axis."""
    return self._Stacked(self.body[0].InitStates(batch_size, max_len))

  def ExtendStep(self, inputs, cached_states, cache_paddings=None):
    return self._Step("ExtendStep", inputs, cached_states,
                      cache_paddings=cache_paddings)

  def Prefill(self, inputs, cached_states, cache_paddings=None,
              live_len=None):
    return self._Step("Prefill", inputs, cached_states,
                      cache_paddings=cache_paddings, live_len=live_len)

  def InitPagedStates(self, num_pages, page_size, num_slots=0,
                      kv_cache_dtype=None):
    """Every body's states (KV pools, SSM slot states) stacked on a
    leading [num_layers] axis."""
    return self._Stacked(self.body[0].InitPagedStates(
        num_pages, page_size, num_slots=num_slots,
        kv_cache_dtype=kv_cache_dtype))

  def PagedStep(self, inputs, cached_states, block_tables, q_pos, in_len):
    return self._Step("PagedStep", inputs, cached_states, block_tables,
                      q_pos, in_len)

  def RaggedStep(self, inputs, cached_states, block_tables, rows):
    return self._Step("RaggedStep", inputs, cached_states, block_tables,
                      rows)

  def _Step(self, method, inputs, cached_states, *args, **kw):
    """Runs the bodies' `method` in order; body i writes its slice of the
    stacked states in place. Returns (out, the stacked states, with the
    host ints a body advanced, such as a decode cache's time_step)."""
    x, ns = inputs, None
    for i, layer in enumerate(self.body):
      x, ns = getattr(layer, method)(x, self._Slice(cached_states.body, i),
                                     *args, **kw)
    return x, NestedMap(body=cached_states.body.Pack([
        old if isinstance(old, torch.Tensor) else new
        for old, new in zip(cached_states.body.Flatten(), ns.Flatten())]))
