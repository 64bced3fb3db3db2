"""Transformer layers and stacks, serving step (port of lingvo_tpu/core/transformer.py).

`TransformerFeedForwardLayer`, `TransformerAttentionLayer` and
`TransformerLayer` keep the reference's pre-LN/residual structure and child
names. `StackedTransformerLayers` holds N distinct layers.
`RepeatedTransformerLayer` is where the port differs in form: the
reference keeps one body with every weight stacked on a leading axis and
scans it; here `body` is an `nn.ModuleList` of num_layers layers walked
in a Python loop (the converter unstacks the reference's axis into it).
The repeat's KV pools stay stacked, [num_layers, pages, P, N, H], as in
the reference, and each layer updates its own slice in place.

Only the Params fields the served models set are ported (no dropout,
gating, remat or cross-attention fields: serving runs none of them).
"""

from __future__ import annotations

from lingvo_tpu_torch.core import activations
from lingvo_tpu_torch.core import attention as attention_lib
from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import layers as layers_lib
from lingvo_tpu_torch.core.nested_map import NestedMap


class TransformerFeedForwardLayer(base_layer.BaseLayer):
  """Pre-LN FFN with residual."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("input_dim", 0, "Model dim.")
    p.Define("hidden_dim", 0, "Inner dim.")
    p.Define("activation", "RELU", "Inner activation.")
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

  def FProp(self, inputs):
    h = activations.GetFn(self.p.activation)(
        self.ffn_in.FProp(self.ln.FProp(inputs)))
    return inputs + self.ffn_out.FProp(h)


class TransformerAttentionLayer(base_layer.BaseLayer):
  """Pre-LN attention block with residual."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("input_dim", 0, "Model dim.")
    p.Define("num_heads", 8, "Heads.")
    p.Define("atten_tpl", attention_lib.MultiHeadedAttention.Params(),
             "Attention template.")
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

  def InitPagedStates(self, num_pages, page_size, num_slots=0,
                      kv_cache_dtype=None):
    return self.atten.InitPagedStates(num_pages, page_size,
                                      num_slots=num_slots,
                                      kv_cache_dtype=kv_cache_dtype)

  def RaggedStep(self, query_vec, cached_states, block_tables, rows):
    x = self.ln.FProp(query_vec)
    out, new_states = self.atten.RaggedStep(x, cached_states, block_tables,
                                            rows)
    return query_vec + out, new_states


class TransformerLayer(base_layer.BaseLayer):
  """Self-attention + FFN (decoder-only serving)."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("input_dim", 0, "Model dim.")
    p.Define("num_heads", 8, "Heads.")
    p.Define("hidden_dim", 0, "FFN inner dim (0 = 4*input).")
    p.Define("tr_atten_tpl", TransformerAttentionLayer.Params(),
             "Self-attention template.")
    p.Define("tr_fflayer_tpl", TransformerFeedForwardLayer.Params(),
             "FFN template.")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    p = self.p
    self.CreateChild("self_atten", p.tr_atten_tpl.Copy().Set(
        input_dim=p.input_dim, num_heads=p.num_heads))
    self.CreateChild(
        "fflayer",
        p.tr_fflayer_tpl.Copy().Set(
            input_dim=p.input_dim,
            hidden_dim=p.hidden_dim or 4 * p.input_dim))

  def InitPagedStates(self, num_pages, page_size, num_slots=0,
                      kv_cache_dtype=None):
    return NestedMap(self_atten=self.self_atten.InitPagedStates(
        num_pages, page_size, num_slots=num_slots,
        kv_cache_dtype=kv_cache_dtype))

  def RaggedStep(self, inputs, cached_states, block_tables, rows):
    x, new_sa = self.self_atten.RaggedStep(
        inputs, cached_states.self_atten, block_tables, rows)
    return self.fflayer.FProp(x), NestedMap(self_atten=new_sa)


class StackedTransformerLayers(base_layer.BaseLayer):
  """N distinct transformer layers (as the LM builds them: no final LN)."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("num_layers", 0, "Depth.")
    p.Define("transformer_layer_params_tpl", TransformerLayer.Params(),
             "Per-layer template.")
    p.Define("input_dim", 0, "Model dim (propagated to layers).")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    p = self.p
    assert p.num_layers > 0
    tpls = [p.transformer_layer_params_tpl.Copy()
            for _ in range(p.num_layers)]
    if p.input_dim:
      for t in tpls:
        t.input_dim = p.input_dim
    self.CreateChildren("x_layers", tpls)

  def InitPagedStates(self, num_pages, page_size, num_slots=0,
                      kv_cache_dtype=None):
    return NestedMap(x_layers=[
        layer.InitPagedStates(num_pages, page_size, num_slots=num_slots,
                              kv_cache_dtype=kv_cache_dtype)
        for layer in self.x_layers
    ])

  def RaggedStep(self, inputs, cached_states, block_tables, rows):
    x = inputs
    for i, layer in enumerate(self.x_layers):
      x, _ = layer.RaggedStep(x, cached_states.x_layers[i], block_tables,
                              rows)
    return x, cached_states


class RepeatedTransformerLayer(base_layer.BaseLayer):
  """N identical-architecture layers; `body` is their ModuleList."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("num_layers", 0, "Repeat count.")
    p.Define("body", TransformerLayer.Params(), "The repeated layer.")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    assert self.p.num_layers > 0
    self.CreateChildren("body", [self.p.body] * self.p.num_layers)

  def InitPagedStates(self, num_pages, page_size, num_slots=0,
                      kv_cache_dtype=None):
    """Every layer's pool stacked on a leading [num_layers] axis."""
    one = self.body[0].InitPagedStates(num_pages, page_size,
                                       num_slots=num_slots,
                                       kv_cache_dtype=kv_cache_dtype)
    n = self.p.num_layers
    return NestedMap(body=one.Transform(
        lambda x: x.new_zeros((n,) + tuple(x.shape))))

  def RaggedStep(self, inputs, cached_states, block_tables, rows):
    """Runs the layers in order; layer i writes its slice of the stacked
    pools in place. Returns (out, cached_states)."""
    x = inputs
    for i, layer in enumerate(self.body):
      x, _ = layer.RaggedStep(x, cached_states.body.Transform(lambda s: s[i]),
                              block_tables, rows)
    return x, cached_states
