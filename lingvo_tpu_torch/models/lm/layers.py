"""Decoder-only transformer LM: training step and serving step (port of lingvo_tpu/models/lm/layers.py).

`TransformerLm` is a `BaseTask` with the reference's Params. It builds
tied embedding/softmax (`emb`), a repeated or stacked transformer
(`stack`) and `final_ln`. The stack is attention-only, or, with
`mixer_tpl` (`core/ssm.GatedSSMLayer`), a hybrid: attention every
`mixer_atten_every_n`-th layer and the O(1)-state mixer elsewhere, or the
mixer everywhere (`mixer_atten_every_n == 0`). It implements:

- the training surface: `ComputePredictions` / `ComputeLoss` over packed
  batches (ids, labels, paddings, segment_ids), with the dense head or,
  with `xent_block_size > 0`, the fused blockwise xent, or, with
  `softmax_num_sampled > 0`, an untied sampled-softmax head
  (`core/layers.SampledSoftmax`); `residual_dropout_prob` and
  `atten_dropout_prob` draw from the step seed; `BaseTask.TrainStep`
  drives them;
- incremental decode over a dense per-batch KV cache, which
  `runners/gshard_decode.GShardDecode` drives: `InitDecodeState`,
  `ExtendStep` and the chunked `Prefill`;
- the continuous-batching surface the serving engine drives:
  `InitPagedDecodeState`, `RaggedStep` (step_mode='ragged') and
  `PagedStep` (step_mode='legacy').

Decode follows the reference's position policy: rotary positions are the
global cache slots and no absolute position embedding is added.

A sampled-softmax task trains on its sampled loss under a step seed.
Its eval (and any FProp without a step seed) computes the reference's
full-softmax metrics through the fused xent statistics
(`ops/fused_xent.FusedXent`, the kernel on the card) over the untied
table and its bias: the same function as the reference's dense
`XentLossFromLogits` and `argmax`, its float32 sums in another order,
and the [B, T, V] logits (52 GB at the 1B-words eval's 793,470 words)
never exist. Decode and serving score with the untied head, as the
reference's do.

Only the Params fields the DenseLm and 1B-words models set are ported,
plus those whose other values raise NotImplementedError naming the slice
that brings them (MoE, absolute position embeddings, the bidirectional
encoder).

Construct on an explicit device: `TransformerLm.Params().Set(...)
.Instantiate(device="cpu")`; with no device the model goes to CUDA and
raises when there is none.
"""

from __future__ import annotations

import torch

from lingvo_tpu_torch.core import base_model
from lingvo_tpu_torch.core import layers as layers_lib
from lingvo_tpu_torch.core import py_utils
from lingvo_tpu_torch.core import transformer as transformer_lib
from lingvo_tpu_torch.core.nested_map import NestedMap
from lingvo_tpu_torch.ops import fused_xent

# the vocab block of a sampled-softmax task's fused eval statistics (the
# plain version's block; the kernel tiles the vocabulary its own way)
SAMPLED_EVAL_XENT_BLOCK = 1024


class TransformerLm(base_model.BaseTask):
  """Decoder-only transformer LM.

  Input batch fields (packed format), torch tensors on the model's device:
    ids: [b, t] int32        labels: [b, t] int32
    paddings: [b, t] f32     (optional) segment_ids: [b, t] int32
  """

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
    p.Define("remat_policy", "full",
             "Per-layer rematerialization under use_repeat_layer: 'full' | "
             "'none' ('dots' comes with a later training slice).")
    p.Define("atten_tpl", None, "Optional attention template override.")
    p.Define("use_rotary", True, "RoPE on q/k.")
    p.Define("bidirectional", False,
             "No causal mask (the BERT-style encoder slice; False only).")
    p.Define("label_smoothing", 0.0, "Label smoothing.")
    p.Define("softmax_logits_soft_max", 30.0, "Logit tanh cap.")
    p.Define("xent_block_size", 0,
             "If >0, the train loss runs the fused blockwise LM-head xent "
             "(ops/fused_xent.py) this many vocab entries at a time and the "
             "[B, T, V] logits never exist. 0 = the dense head.")
    p.Define(
        "mixer_tpl", None,
        "Optional O(1)-state sequence-mixer template (e.g. "
        "ssm.GatedSSMLayer.Params()). When set, SSM layers replace "
        "attention according to mixer_atten_every_n; the serving contract "
        "is unchanged (the mixer keeps a fixed [N, H, S] state per slot).")
    p.Define(
        "mixer_atten_every_n", 0,
        "Hybrid-stack layout with mixer_tpl: every n-th layer (layers n, "
        "2n, ... 1-indexed) keeps full attention, the rest run the mixer, "
        "e.g. 6 gives [ssm x5, attention] blocks. 0 = every layer runs the "
        "mixer (pure-SSM stack, pageless serving); 1 = plain attention. "
        "Under use_repeat_layer, num_layers must divide by n (the block is "
        "the repeat body).")
    p.Define("kv_cache_dtype", None,
             "KV cache / page pool dtype of every attention layer: None "
             "(float32), 'float32', 'bfloat16' or 'int8' (quantize on write "
             "with per-token-per-head scales; quant/kv.py). SSM state slots "
             "stay float32. Overridable per engine through "
             "InitPagedDecodeState(..., kv_cache_dtype=...).")
    p.Define("softmax_num_sampled", 0,
             "If >0, train with a sampled softmax over this many log-uniform "
             "negatives (untied output head; the word-level 793k-vocab "
             "1B-words recipe). Eval computes the full softmax's metrics "
             "through the fused xent statistics.")
    p.Define("residual_dropout_prob", 0.0, "Residual dropout.")
    p.Define("atten_dropout_prob", 0.0,
             "Attention dropout (the serving steps then take the "
             "gather-dense fallback, where it is the identity).")
    # fields whose non-default values raise until their slice is ported
    p.Define("num_experts", 0, "GShard MoE experts (the MoE slice).")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    p = self.p
    if p.num_experts > 0:
      raise NotImplementedError("MoE layers come with the MoE slice")
    if p.bidirectional:
      raise NotImplementedError(
          "the bidirectional (BERT-style) encoder comes with a later slice")
    self.CreateChild(
        "emb",
        layers_lib.SharedEmbeddingSoftmaxLayer.Params().Set(
            vocab_size=p.vocab_size, embedding_dim=p.model_dim,
            logits_soft_max=p.softmax_logits_soft_max,
            xent_block_size=p.xent_block_size))
    layer_body = transformer_lib.TransformerLayer.Params().Set(
        input_dim=p.model_dim, num_heads=p.num_heads,
        hidden_dim=p.hidden_dim, mask_self_atten=not p.bidirectional)
    if p.atten_tpl is not None:
      layer_body.tr_atten_tpl.atten_tpl = p.atten_tpl.Copy()
    layer_body.tr_atten_tpl.atten_tpl.Set(
        use_rotary_position_emb=p.use_rotary,
        kv_cache_dtype=p.kv_cache_dtype,
        atten_dropout_prob=p.atten_dropout_prob)
    layer_body.tr_atten_tpl.residual_dropout_prob = p.residual_dropout_prob
    layer_body.tr_fflayer_tpl.residual_dropout_prob = p.residual_dropout_prob
    ssm_body = None
    if p.mixer_tpl is not None:
      assert p.num_experts == 0, (
          "hybrid SSM stacks don't compose with the MoE interleave yet")
      assert not p.bidirectional, (
          "GatedSSMLayer is causal; bidirectional stacks keep attention")
      ssm_body = layer_body.Copy().Set(mixer_tpl=p.mixer_tpl.Copy())
      if p.mixer_atten_every_n == 1:
        # attention at every layer: the hybrid degenerates to the plain
        # attention stack and the mixer template is never instantiated
        ssm_body = None

    if ssm_body is not None and p.mixer_atten_every_n > 1:
      # hybrid stack: attention at layers n, 2n, ... (1-indexed), SSM
      # elsewhere, as [ssm x (n-1), attention] blocks
      n = p.mixer_atten_every_n
      assert p.num_layers % n == 0, (p.num_layers, n)
      if p.use_repeat_layer:
        block = transformer_lib.StackedTransformerLayers.Params().Set(
            num_layers=n, input_dim=p.model_dim,
            layer_tpls=[ssm_body.Copy() for _ in range(n - 1)]
            + [layer_body.Copy()],
            final_ln=False)
        self.CreateChild(
            "stack",
            transformer_lib.RepeatedTransformerLayer.Params().Set(
                num_layers=p.num_layers // n, body=block,
                remat_policy=p.remat_policy))
      else:
        tpls = [layer_body.Copy() if (i + 1) % n == 0 else ssm_body.Copy()
                for i in range(p.num_layers)]
        self.CreateChild(
            "stack",
            transformer_lib.StackedTransformerLayers.Params().Set(
                num_layers=p.num_layers, input_dim=p.model_dim,
                layer_tpls=tpls, final_ln=False))
    elif p.use_repeat_layer:
      self.CreateChild(
          "stack",
          transformer_lib.RepeatedTransformerLayer.Params().Set(
              num_layers=p.num_layers, body=ssm_body or layer_body,
              remat_policy=p.remat_policy))
    else:
      self.CreateChild(
          "stack",
          transformer_lib.StackedTransformerLayers.Params().Set(
              num_layers=p.num_layers, input_dim=p.model_dim,
              transformer_layer_params_tpl=ssm_body or layer_body,
              final_ln=False))
    if p.softmax_num_sampled > 0:
      assert p.xent_block_size == 0, (
          "sampled softmax and the fused blockwise xent are both "
          "no-[B,T,V]-logits training paths; pick one")
      assert p.label_smoothing == 0.0, (
          "label_smoothing is not supported with the sampled softmax")
      self.CreateChild(
          "sampled_softmax",
          layers_lib.SampledSoftmax.Params().Set(
              input_dim=p.model_dim, num_classes=p.vocab_size,
              num_sampled=p.softmax_num_sampled))
    self.CreateChild(
        "final_ln", layers_lib.LayerNorm.Params().Set(input_dim=p.model_dim))

  # -- training forward ----------------------------------------------------------

  def ComputePredictions(self, input_batch: NestedMap) -> NestedMap:
    """NestedMap(hidden [b, t, D]) with the fused or the sampled head,
    else NestedMap(logits [b, t, V])."""
    if not self.p.use_rotary:
      raise NotImplementedError(
          "absolute position embeddings come with a later training slice; "
          "the DenseLm models are rotary")
    x = self.emb.EmbLookup(input_batch.ids)
    x = self.stack.FProp(x, paddings=input_batch.paddings,
                         segment_ids=input_batch.Get("segment_ids"))
    x = self.final_ln.FProp(x)
    if self.p.xent_block_size > 0 or self.p.softmax_num_sampled > 0:
      return NestedMap(hidden=x)
    return NestedMap(logits=self.emb.Logits(x))

  def _FullLogits(self, predictions: NestedMap):
    """Dense [..., V] logits from a predictions map, for consumers that
    need the whole distribution: the head's logits over the hidden state
    where ComputePredictions deferred them."""
    if "logits" in predictions:
      return predictions.logits
    if self.p.softmax_num_sampled > 0:
      return self.sampled_softmax.Logits(predictions.hidden)
    return self.emb.Logits(predictions.hidden)

  def _SampledLoss(self, predictions, labels, weights, tot_weight):
    """The sampled-softmax task's metrics: its sampled loss in training,
    else the full softmax's loss, log_pplx and next-step accuracy from the
    fused xent statistics over the untied table and bias (no cap, no
    smoothing), which the reference takes from dense logits."""
    if not py_utils.DoEval() and py_utils.HasStepSeed():
      per_tok = self.sampled_softmax.XentLossFromInputs(predictions.hidden,
                                                        labels)
      avg_xent = torch.sum(per_tok * weights) / tot_weight
      return NestedMap(
          loss=(avg_xent, tot_weight), log_pplx=(avg_xent, tot_weight),
          num_predictions=(tot_weight, 1.0)), NestedMap(xent=per_tok)
    sm = self.sampled_softmax
    th = sm.CastTheta()
    out = fused_xent.FusedXent(
        sm.ToFPropDtype(predictions.hidden), th.w, labels,
        block_size=SAMPLED_EVAL_XENT_BLOCK, bias=th.b, logits_soft_max=0.0,
        label_smoothing=0.0, weight_layout="vd")
    avg_xent = torch.sum(out.per_example_xent * weights) / tot_weight
    correct = out.argmax == labels
    return NestedMap(
        loss=(avg_xent, tot_weight),
        log_pplx=(avg_xent, tot_weight),
        fraction_of_correct_next_step_preds=(
            torch.sum(correct * weights) / tot_weight, tot_weight),
        num_predictions=(tot_weight, 1.0)), NestedMap(
            xent=out.per_example_xent)

  def ComputeLoss(self, predictions: NestedMap, input_batch: NestedMap):
    """(metrics of (value, weight) pairs, NestedMap(xent [b, t])), as the
    reference: the loss is the padding-weighted mean xent."""
    p = self.p
    labels = input_batch.labels
    weights = py_utils.SequenceMask(input_batch.paddings)
    tot_weight = torch.clamp(torch.sum(weights), min=1e-8)
    if p.softmax_num_sampled > 0:
      return self._SampledLoss(predictions, labels, weights, tot_weight)
    if "hidden" in predictions:
      # fused blockwise xent: the per-token loss and the argmax metric come
      # out of the streaming pass
      out = self.emb.FProp(predictions.hidden, class_ids=labels,
                           label_smoothing=p.label_smoothing)
      correct = out.argmax == labels
    else:
      out = layers_lib.XentLossFromLogits(
          predictions.logits, p.vocab_size, class_ids=labels,
          label_smoothing=p.label_smoothing)
      correct = torch.argmax(predictions.logits, dim=-1) == labels
    avg_xent = torch.sum(out.per_example_xent * weights) / tot_weight
    metrics = NestedMap(
        loss=(avg_xent, tot_weight),
        log_pplx=(avg_xent, tot_weight),
        fraction_of_correct_next_step_preds=(
            torch.sum(correct * weights) / tot_weight, tot_weight),
        num_predictions=(tot_weight, 1.0))
    return metrics, NestedMap(xent=out.per_example_xent)

  # -- incremental decode ----------------------------------------------------

  def InitDecodeState(self, batch_size: int, max_len: int) -> NestedMap:
    """Dense [B, max_len] KV caches of every attention layer and one
    [B, N, H, S] state of every SSM mixer (host-int time_step 0)."""
    return self.stack.InitStates(batch_size, max_len)

  def _Head(self, x):
    """Decode and serving logits: the untied sampled-softmax head where
    there is one (the head that was trained), else the tied one."""
    x = self.final_ln.FProp(x)
    if self.p.softmax_num_sampled > 0:
      return self.sampled_softmax.Logits(x)
    return self.emb.Logits(x)

  @torch.no_grad()
  def ExtendStep(self, ids_t, states, cache_paddings=None):
    """ids_t: [b, 1] -> (logits [b, vocab], states); the caches update in
    place. cache_paddings: optional [b, max_len] float32, 1.0 marks cache
    slots never to attend (the left-pad of right-aligned prompts)."""
    x = self.emb.EmbLookup(ids_t)
    x, states = self.stack.ExtendStep(x, states,
                                      cache_paddings=cache_paddings)
    return self._Head(x)[:, 0, :], states

  @torch.no_grad()
  def Prefill(self, ids, states, cache_paddings=None, live_len=None):
    """Chunked prefill: ids [b, c] at cache slots [time_step, time_step +
    c) -> (logits [b, c, vocab], states), one attention pass per layer.
    live_len: optional bound (>= time_step + c) on the cache slots the
    read touches (MultiHeadedAttention.Prefill)."""
    x = self.emb.EmbLookup(ids)
    x, states = self.stack.Prefill(x, states, cache_paddings=cache_paddings,
                                   live_len=live_len)
    return self._Head(x), states

  # -- serving ---------------------------------------------------------------

  def InitPagedDecodeState(self, num_pages: int, page_size: int,
                           num_slots: int = 0,
                           kv_cache_dtype: str | None = None):
    """Global KV page pools for the continuous-batching engine (the engine
    passes allocator pages + 1; the last page is the trash page), and one
    state per slot for each O(1)-state mixer (num_slots = engine slots).
    kv_cache_dtype overrides p.kv_cache_dtype for these pools."""
    return self.stack.InitPagedStates(num_pages, page_size,
                                      num_slots=num_slots,
                                      kv_cache_dtype=kv_cache_dtype)

  @torch.no_grad()
  def PagedStep(self, ids, states, block_tables, q_pos, in_len):
    """Legacy continuous-batching step: ids [b, c] -> (logits [b, c,
    vocab], states).

    Row b's tokens land at its global slots [q_pos[b], q_pos[b] +
    in_len[b]) through block_tables [b, t_pages]; c == 1 is a decode-only
    step, c > 1 a mixed step (decode rows use in_len 1; padding columns
    past in_len give logits the engine discards). The KV pools and SSM
    slot states update in place."""
    x = self.emb.EmbLookup(ids)
    x, states = self.stack.PagedStep(x, states, block_tables, q_pos, in_len)
    return self._Head(x), states

  @torch.no_grad()
  def RaggedStep(self, ids, states, block_tables, rows):
    """Packed-token continuous-batching step: ids [1, T] -> (logits
    [1, T, vocab], states).

    Token t belongs to engine slot rows.row_of[t] at global kv slot
    rows.pos[t] (core/ragged.py RaggedRows). Rotary positions are the
    tokens' logical positions; no absolute position embedding is added
    (serve rotary models), as in the reference. The KV pools and SSM slot
    states in `states` are updated in place."""
    x = self.emb.EmbLookup(ids)
    x, states = self.stack.RaggedStep(x, states, block_tables, rows)
    return self._Head(x), states
