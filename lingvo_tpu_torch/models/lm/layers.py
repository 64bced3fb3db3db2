"""Decoder-only transformer LM, serving step (port of lingvo_tpu/models/lm/layers.py).

`TransformerLm` carries the reference's Params and builds the
attention-only stack: tied embedding/softmax (`emb`), a repeated or
stacked transformer (`stack`) and `final_ln`. It implements the
continuous-batching surface the serving engine drives:
`InitPagedDecodeState` and `RaggedStep`. Only the Params fields the served
models set are ported, plus those whose other values raise
NotImplementedError naming the slice that brings them (MoE, SSM mixers,
int8 KV pools, attention dropout, the sampled softmax).

Construct on an explicit device: `TransformerLm.Params().Set(...)
.Instantiate(device="cpu")`; with no device the model goes to CUDA and
raises when there is none.
"""

from __future__ import annotations

from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import layers as layers_lib
from lingvo_tpu_torch.core import transformer as transformer_lib


class TransformerLm(base_layer.BaseLayer):
  """Decoder-only transformer LM (serving step)."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("vocab_size", 32000, "Vocabulary size.")
    p.Define("model_dim", 512, "Model dim.")
    p.Define("num_layers", 6, "Depth.")
    p.Define("num_heads", 8, "Heads.")
    p.Define("hidden_dim", 2048, "FFN inner dim.")
    p.Define("use_repeat_layer", True,
             "Repeated (True) vs distinct (False) layers.")
    p.Define("use_rotary", True, "RoPE on q/k at the tokens' positions.")
    p.Define("softmax_logits_soft_max", 30.0, "Logit tanh cap.")
    # fields whose non-default values raise until their slice is ported
    p.Define("mixer_tpl", None,
             "O(1)-state sequence mixer template (the SSM-hybrid slice).")
    p.Define("kv_cache_dtype", None,
             "KV page pool dtype for every attention layer: None (float32); "
             "'int8' comes with the quantized-serving slice.")
    p.Define("atten_dropout_prob", 0.0,
             "Attention dropout (needs the gather-dense serving fallback).")
    p.Define("softmax_num_sampled", 0,
             "Sampled-softmax training head (comes with the training slice).")
    p.Define("num_experts", 0, "GShard MoE experts (the MoE slice).")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    p = self.p
    if p.num_experts > 0:
      raise NotImplementedError("MoE layers come with the MoE slice")
    if p.mixer_tpl is not None:
      raise NotImplementedError(
          "SSM sequence mixers come with the SSM-hybrid slice of the port")
    if p.softmax_num_sampled > 0:
      raise NotImplementedError(
          "the sampled-softmax head comes with the training slice")
    self.CreateChild(
        "emb",
        layers_lib.SharedEmbeddingSoftmaxLayer.Params().Set(
            vocab_size=p.vocab_size, embedding_dim=p.model_dim,
            logits_soft_max=p.softmax_logits_soft_max))
    layer_body = transformer_lib.TransformerLayer.Params().Set(
        input_dim=p.model_dim, num_heads=p.num_heads,
        hidden_dim=p.hidden_dim)
    layer_body.tr_atten_tpl.atten_tpl.Set(
        use_rotary_position_emb=p.use_rotary,
        kv_cache_dtype=p.kv_cache_dtype,
        atten_dropout_prob=p.atten_dropout_prob)
    if p.use_repeat_layer:
      self.CreateChild(
          "stack",
          transformer_lib.RepeatedTransformerLayer.Params().Set(
              num_layers=p.num_layers, body=layer_body))
    else:
      self.CreateChild(
          "stack",
          transformer_lib.StackedTransformerLayers.Params().Set(
              num_layers=p.num_layers, input_dim=p.model_dim,
              transformer_layer_params_tpl=layer_body))
    self.CreateChild(
        "final_ln", layers_lib.LayerNorm.Params().Set(input_dim=p.model_dim))

  def InitPagedDecodeState(self, num_pages: int, page_size: int,
                           num_slots: int = 0,
                           kv_cache_dtype: str | None = None):
    """Global KV page pools for the continuous-batching engine (the engine
    passes allocator pages + 1; the last page is the trash page)."""
    return self.stack.InitPagedStates(num_pages, page_size,
                                      num_slots=num_slots,
                                      kv_cache_dtype=kv_cache_dtype)

  def RaggedStep(self, ids, states, block_tables, rows):
    """Packed-token continuous-batching step: ids [1, T] -> (logits
    [1, T, vocab], states).

    Token t belongs to engine slot rows.row_of[t] at global kv slot
    rows.pos[t] (core/ragged.py RaggedRows). Rotary positions are the
    tokens' logical positions; no absolute position embedding is added
    (serve rotary models), as in the reference. The pools in `states` are
    updated in place."""
    x = self.emb.EmbLookup(ids)
    x, states = self.stack.RaggedStep(x, states, block_tables, rows)
    x = self.final_ln.FProp(x)
    return self.emb.Logits(x), states
