"""Multi-headed attention for the continuous-batching step.

Port of the serving half of lingvo_tpu/core/attention.py
`MultiHeadedAttention`: the projections (`_HeadsProj`, `_PostProj`), the
learned per-dim query scale, the global KV page pool (`InitPagedStates`)
and the packed-token `RaggedStep`. Weights keep the reference's layouts:
w_query/w_key/w_value/w_post [D, N, H], biases [N, H] and [D].
Activations are [B, T, N, H]. Only the Params fields the served models set
are ported, plus those whose other values must raise.

The page pool is updated IN PLACE (`index_put_`) where the reference
donated it to the jitted step and got a new array back: one KV pool per
layer lives for the life of the serving engine.
"""

from __future__ import annotations

import math

import torch

from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import layers as layers_lib
from lingvo_tpu_torch.core.nested_map import NestedMap
from lingvo_tpu_torch.core.py_utils import WeightInit, WeightParams
from lingvo_tpu_torch.ops import ragged_block_attend


class PerDimScaleLayer(base_layer.BaseLayer):
  """Learned per-dim query scaling (reference attention.PerDimScaleLayer)."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("dim", 0, "Per-head dim.")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    self.CreateVariable(
        "per_dim_scale",
        WeightParams((self.p.dim,), WeightInit.Constant(0.0), self.p.dtype))

  def FProp(self, inputs):
    r_softplus_0 = 1.442695041
    scale = r_softplus_0 / math.sqrt(self.p.dim)
    return inputs * (torch.nn.functional.softplus(self.per_dim_scale) * scale)


class MultiHeadedAttention(base_layer.BaseLayer):
  """Dot-product multi-headed attention, serving step only."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("input_dim", 0, "Query/output model dim.")
    p.Define("hidden_dim", 0, "Total attention hidden dim (N*H).")
    p.Define("num_heads", 1, "Number of heads.")
    p.Define("atten_dropout_prob", 0.0, "Attention prob dropout.")
    p.Define("atten_logit_cap", 0.0, "If >0, tanh-cap logits.")
    p.Define("use_rotary_position_emb", False, "Apply RoPE to q/k.")
    p.Define("kv_cache_dtype", None,
             "KV page pool storage dtype: None/'float32' (ported) or "
             "'int8' (the quantized-serving slice).")
    p.Define("rel_pos_emb_dim", 0,
             "If >0, learned relative position bias (not servable: the "
             "paged step computes positions from slots).")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    p = self.p
    assert p.input_dim > 0 and p.num_heads > 0
    if p.rel_pos_emb_dim > 0:
      raise NotImplementedError(
          "relative position bias is not ported: the paged serving step "
          "cannot serve it (the reference asserts the same)")
    self._dim_per_head = (p.hidden_dim or p.input_dim) // p.num_heads
    n, h, d = p.num_heads, self._dim_per_head, p.input_dim
    for name in ("query", "key", "value"):
      self.CreateVariable(f"w_{name}",
                          WeightParams((d, n, h), p.params_init, p.dtype))
      self.CreateVariable(
          f"b_{name}", WeightParams((n, h), WeightInit.Constant(0.0), p.dtype))
    self.CreateVariable("w_post",
                        WeightParams((d, n, h), p.params_init, p.dtype))
    self.CreateVariable(
        "b_post", WeightParams((d,), WeightInit.Constant(0.0), p.dtype))
    self.CreateChild("per_dim_scale", PerDimScaleLayer.Params().Set(dim=h))
    if p.use_rotary_position_emb:
      self.CreateChild(
          "rotary",
          layers_lib.RotaryPositionalEmbeddingLayer.Params().Set(
              embedding_dim=h))

  # -- projections -----------------------------------------------------------

  def _HeadsProj(self, name, x):
    """[B, T, D] x [D, N, H] -> [B, T, N, H] (+ bias [N, H])."""
    return (torch.einsum("btd,dnh->btnh", x, getattr(self, f"w_{name}"))
            + getattr(self, f"b_{name}"))

  def _PostProj(self, ctx):
    """[B, T, N, H] contracted with [D, N, H] over (N, H) -> [B, T, D]."""
    return torch.einsum("btnh,dnh->btd", ctx, self.w_post) + self.b_post

  # -- block-table paged serving ---------------------------------------------

  def InitPagedStates(self, num_pages: int, page_size: int,
                      num_slots: int = 0,
                      kv_cache_dtype: str | None = None) -> NestedMap:
    """Global KV page pool [num_pages, page_size, N, H] shared by all
    sequences (the engine passes allocator pages + 1: the last page is the
    trash page padding tokens write to). num_slots is for O(1)-state
    mixers and ignored here."""
    del num_slots
    dtype = kv_cache_dtype or self.p.kv_cache_dtype
    if dtype not in (None, "float32"):
      raise NotImplementedError(
          f"kv_cache_dtype={dtype!r}: only float32 KV pools are ported; "
          "int8 and bfloat16 pools come with the quantized-serving slice")
    shape = (num_pages, page_size, self.p.num_heads, self._dim_per_head)
    return NestedMap(
        key=torch.zeros(shape, dtype=torch.float32, device=self.device),
        value=torch.zeros(shape, dtype=torch.float32, device=self.device))

  def BlockDecodeEligible(self, page_size: int) -> bool:
    """Plain masked-softmax attention only: what the ragged kernel serves.
    (The reference also checks its TPU tiling here; the CUDA kernel's own
    limits are checked by its wrapper.)"""
    p = self.p
    return (page_size > 0 and p.rel_pos_emb_dim == 0
            and p.atten_logit_cap == 0 and p.atten_dropout_prob == 0.0)

  def RaggedStep(self, query_vec, cached_states: NestedMap, block_tables,
                 rows):
    """One PACKED continuous-batching step (core/ragged.py RaggedRows).

    query_vec: [1, T, D], all rows' tokens on one token axis; token t
    belongs to slot rows.row_of[t] and lands at global kv slot rows.pos[t]
    through that row's block table. Padding tokens (rows.valid False)
    scatter to the trash page and produce zeros the engine discards.
    block_tables: [B, t_pages] int32 on the layer's device. Writes the new
    K/V into cached_states in place and returns ([1, T, D], cached_states).
    """
    k_pool, v_pool = cached_states.key, cached_states.value
    np_total, page_size = k_pool.shape[0], k_pool.shape[1]
    if not self.BlockDecodeEligible(page_size):
      raise NotImplementedError(
          "attention with a logit cap, dropout or relative bias needs the "
          "gather-dense fallback, which comes with a later serving slice")
    b, t_pages = block_tables.shape
    t = query_vec.shape[1]
    dev = query_vec.device
    pos = rows.pos.to(torch.int64)                                 # [T]
    valid = rows.valid
    row = torch.clamp(rows.row_of.to(torch.int64), 0, b - 1)
    q_start = rows.row_q_pos[row].to(torch.int32)                  # [T]
    q = self._HeadsProj("query", query_vec)                        # [1,T,N,H]
    k_new = self._HeadsProj("key", query_vec)
    v_new = self._HeadsProj("value", query_vec)
    if self.p.use_rotary_position_emb:
      # tree rows embed at their logical position pos_ids (== pos on chains)
      posf = rows.pos_ids[None].to(torch.float32)
      q = self.rotary.FProp(q, posf)
      k_new = self.rotary.FProp(k_new, posf)
    q = self.per_dim_scale.FProp(q)
    # scatter each token's K/V through ITS row's block table before the
    # read (later tokens of a prefill chunk attend to earlier ones);
    # padding tokens write to the trash page (pool page np_total - 1)
    logical = torch.clamp(pos // page_size, 0, t_pages - 1)
    tables = torch.clamp(block_tables.to(torch.int64), 0, np_total - 1)
    phys = torch.where(valid, tables[row, logical], np_total - 1)
    off = torch.where(valid, pos % page_size,
                      torch.arange(t, dtype=torch.int64, device=dev)
                      % page_size)
    k_pool.index_put_((phys, off), k_new[0])
    v_pool.index_put_((phys, off), v_new[0])
    # token t attends over its row's slots [0, pos[t]]; q_end = 0 marks
    # padding (the ragged op emits exact zeros there)
    q_end = torch.where(valid, pos + 1, 0).to(torch.int32)
    ctx = ragged_block_attend.RaggedAttend(
        q[0].contiguous(), k_pool, v_pool, block_tables,
        row.to(torch.int32), q_end, page_size=page_size,
        q_start=q_start, anc_lo=rows.anc_lo, anc_hi=rows.anc_hi)[None]
    return self._PostProj(ctx), cached_states
