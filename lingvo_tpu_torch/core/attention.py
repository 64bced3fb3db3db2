"""Multi-headed attention: the training FProp, incremental decode and the serving steps.

Port of lingvo_tpu/core/attention.py `MultiHeadedAttention`: the
projections (`_HeadsProj`, `_PostProj`), the learned per-dim query scale,
the training `FProp` (causal, padding and segment masks; the fused flash
kernel of `ops/flash_attention.py` when `use_flash_attention` is set and
the call is eligible, else the einsum path `_Atten`), the dense
per-batch KV cache of incremental decode (`InitStates`, `ExtendStep`,
whose read goes through the paged flash-decode kernel of
`ops/flash_decode.py` when `decode_page_size` is set, and the chunked
`Prefill`), the global KV page pool (`InitPagedStates`), the legacy
serving step `PagedStep` (the block-decode kernel of
`ops/block_decode.py` on decode steps) and the packed-token
`RaggedStep`. A layer the paged kernels do not serve (a logit cap, or on
the card a shape outside their limits; `BlockDecodeEligible`) takes the
reference's gather-dense fallback in both paged steps: each row's pages
gathered into its logical cache and read by the einsum path `_Atten`.
Weights keep
the reference's layouts: w_query/w_key/w_value/w_post [D, N, H], biases
[N, H] and [D]. Activations are [B, T, N, H]. Only the Params fields the
DenseLm models set are ported, plus those whose other values must raise.

KV storage (`kv_cache_dtype`, quant/kv.py): float32 (the default),
bfloat16, or int8 with float32 per-(token, head) scales. An int8 cache is
quantized once, when a token is written, and carries `key_scale` /
`value_scale` ([B, L, N] beside the dense cache, [num_pages, N,
page_size] beside the page pool); every read dequantizes. The dense
cache's int8 read is the dequantize-then-attend einsum path, never the
flash-decode kernel, as in the reference; a bfloat16 cache takes the
kernel. The mode is read from the states themselves (`"key_scale" in
cached_states`), as in the reference.

Under an int8 serving theta (quant/weights.py) the projection weights are
`quant_utils.Int8Weight`s and `_HeadsProj` / `_PostProj` run the int8
matmul, as in the reference.

The page pool and the dense cache are updated IN PLACE (`index_put_`,
slice assignment) where the reference donated them to the jitted step and
got new arrays back: one KV pool per layer lives for the life of the
serving engine, one cache per layer for a decode call. The decode cache's
`time_step` is a host int (the next slot to write), so no device value is
read back per step. The serving and decode steps run under
`torch.no_grad()`: they take no gradient, and the pools and caches never
join an autograd graph.
"""

from __future__ import annotations

import math

import torch

from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import layers as layers_lib
from lingvo_tpu_torch.core import py_utils
from lingvo_tpu_torch.core import quant_utils
from lingvo_tpu_torch.core.nested_map import NestedMap
from lingvo_tpu_torch.core.py_utils import WeightInit, WeightParams
from lingvo_tpu_torch.ops import block_decode
from lingvo_tpu_torch.ops import flash_attention
from lingvo_tpu_torch.ops import flash_decode
from lingvo_tpu_torch.ops import ragged_block_attend
from lingvo_tpu_torch.quant import kv as kv_quant

_NEG_INF = -2.3819763e38  # the reference's additive mask value
# Prefill reads the cache in tiles of this many slots with an online
# softmax; a tile past every query is an exact no-op, so a trimmed read
# (live_len) gives bitwise the full read's result.
_PREFILL_TILE = 128


def CausalMask(t: int, device=None) -> torch.Tensor:
  """[1, 1, t, t] additive mask: 0 on/below the diagonal, _NEG_INF above."""
  keep = torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))
  return torch.where(keep, 0.0, _NEG_INF)[None, None]


def PaddingsToMask(paddings: torch.Tensor) -> torch.Tensor:
  """[b, s] paddings -> [b, 1, 1, s] additive key mask."""
  return (paddings[:, None, None, :] * _NEG_INF).float()


def SegmentMask(q_segment_ids: torch.Tensor,
                k_segment_ids: torch.Tensor) -> torch.Tensor:
  """Packed-sequence mask [b, 1, t, s]; cross-segment pairs masked."""
  same = q_segment_ids[:, :, None] == k_segment_ids[:, None, :]
  return torch.where(same, 0.0, _NEG_INF)[:, None]


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
    sp = py_utils.Softplus(self.CastTheta().per_dim_scale)
    return inputs * (sp * py_utils.WeakScalar(scale, sp)).to(inputs.dtype)


class MultiHeadedAttention(base_layer.BaseLayer):
  """Dot-product multi-headed attention: FProp and the serving step."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("input_dim", 0, "Query/output model dim.")
    p.Define("hidden_dim", 0, "Total attention hidden dim (N*H).")
    p.Define("num_heads", 1, "Number of heads.")
    p.Define("atten_dropout_prob", 0.0, "Attention prob dropout.")
    p.Define("atten_logit_cap", 0.0, "If >0, tanh-cap logits.")
    p.Define("use_rotary_position_emb", False, "Apply RoPE to q/k.")
    p.Define(
        "use_flash_attention", False,
        "FProp runs the fused flash kernel when eligible (self-attention "
        "with only causal/padding/segment masking, no logit cap or "
        "dropout, t a multiple of 16); the einsum path otherwise.")
    p.Define(
        "decode_page_size", 0,
        "If >0, ExtendStep reads the KV cache through the length-aware "
        "paged flash-decode kernel (ops/flash_decode.py) in pages of this "
        "many slots, touching only pages up to time_step. 0 = the dense "
        "read. Requires max_len % decode_page_size == 0 and no logit cap "
        "or dropout; ineligible configs take the dense read.")
    p.Define("kv_cache_dtype", None,
             "KV cache and page pool storage dtype: None (the fprop dtype, "
             "float32), 'float32', 'bfloat16', or 'int8' (quantize on "
             "write with per-token-per-head float32 scale sidecars; see "
             "quant/kv.py).")
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
    self.CreateChild("atten_dropout",
                     layers_lib.DeterministicDropoutLayer.Params())

  # -- projections -----------------------------------------------------------

  def _HeadsProj(self, name, x):
    """[B, T, D] x [D, N, H] -> [B, T, N, H] (+ bias [N, H]), in the fprop
    dtype; an int8 serving leaf through the int8 matmul ('dv', per-(N, H)
    scales)."""
    th = self.CastTheta()
    w = th[f"w_{name}"]
    if isinstance(w, quant_utils.Int8Weight):
      out = w.Einsum(self.ToFPropDtype(x))
    else:
      out = torch.einsum("btd,dnh->btnh", self.ToFPropDtype(x), w)
    return out + th[f"b_{name}"]

  def _PostProj(self, ctx):
    """[B, T, N, H] contracted with [D, N, H] over (N, H) -> [B, T, D]; an
    int8 serving leaf through the int8 matmul ('vd', per-D scales). A
    float32 context under bfloat16 weights (a float32 or int8 cache read
    by bfloat16 queries) promotes the product to float32, as the
    reference's einsum does."""
    th = self.CastTheta()
    if isinstance(th.w_post, quant_utils.Int8Weight):
      out = th.w_post.Einsum(ctx)
    else:
      out = py_utils.Einsum("btnh,dnh->btd", ctx, th.w_post)
    return out + th.b_post

  # -- training forward --------------------------------------------------------

  def _Atten(self, q, k, v, atten_mask):
    """q [B, T, N, H], k/v [B, S, N, H], additive mask broadcastable to
    [B, N, T, S] -> [B, T, N, H] context and the [B, N, T, S] probs.

    The two products promote mixed dtypes as the reference's einsums do:
    bfloat16 queries against a float32 (or dequantized int8) cache give
    float32 logits and a float32 context; against a bfloat16 cache,
    bfloat16 ones. The probabilities are rounded to q's dtype."""
    p = self.p
    # in the inputs' dtype, then float32 from the mask on (reference order)
    logits = py_utils.Einsum("btnh,bsnh->bnts", q, k)
    if p.atten_logit_cap > 0:
      cap = py_utils.WeakScalar(p.atten_logit_cap, logits)
      logits = cap * py_utils.Tanh(logits / cap)
    logits = logits.float()
    if atten_mask is not None:
      logits = logits + atten_mask.float()
    # stacked masks can sum below f32 min (-inf -> NaN softmax rows on
    # fully masked queries); the clamp keeps rows finite
    logits = torch.clamp(logits, min=_NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if p.atten_dropout_prob > 0:
      # the identity with no step seed (serving, eval)
      probs = self.atten_dropout.FProp(
          probs, keep_prob=1.0 - p.atten_dropout_prob)
    return py_utils.Einsum("bnts,bsnh->btnh", probs, v), probs

  def _OnCard(self) -> bool:
    """The layer runs the CUDA kernels: the gates then also hold its shapes
    to their limits, as the reference holds them to its TPU tiling
    (`jax.default_backend() == "tpu"`); the plain CPU versions take any."""
    return self.device.type == "cuda"

  def _FlashEligible(self, key_vec, atten_mask, t) -> bool:
    """Self-attention with only causal/padding/segment masking runs the
    fused kernel (paddings and segment ids fold into its segment mask).
    On the card the head dim must be one the kernels take
    (`flash_attention.KernelLimitError`); the CUDA kernels take any t."""
    p = self.p
    if not (p.use_flash_attention and key_vec is None and atten_mask is None
            and p.atten_logit_cap == 0 and p.atten_dropout_prob == 0
            and t % 16 == 0):
      return False
    return not self._OnCard() or flash_attention.KernelLimitError(
        self._dim_per_head) is None

  def FProp(self, query_vec, key_vec=None, value_vec=None, paddings=None,
            atten_mask=None, segment_ids=None, causal=False):
    """Returns ([B, T, D] output, [B, N, T, S] probs or None on the flash
    path).

    atten_mask: optional additive mask. paddings: key paddings [B, S].
    segment_ids: [B, T] packed-input ids for both q and k (self-attention).
    causal=True masks the future as a flag, so the flash kernel can run.
    Rotary positions are arange(T). Attention dropout (on the einsum
    path's probabilities, `_Atten`) draws from the step seed."""
    use_flash = self._FlashEligible(key_vec, atten_mask, query_vec.shape[1])
    key_vec = query_vec if key_vec is None else key_vec
    value_vec = key_vec if value_vec is None else value_vec
    q = self._HeadsProj("query", query_vec)
    k = self._HeadsProj("key", key_vec)
    v = self._HeadsProj("value", value_vec)
    if self.p.use_rotary_position_emb:
      q = self.rotary.FProp(q)
      k = self.rotary.FProp(k)
    q = self.per_dim_scale.FProp(q)
    if use_flash:
      # paddings and segment ids both become the kernel's segment mask:
      # padding gets segment 0, so pad keys never reach real queries
      seg = segment_ids
      if paddings is not None:
        base = segment_ids if segment_ids is not None else torch.ones_like(
            paddings, dtype=torch.int32)
        seg = torch.where(paddings > 0.5, 0, base).to(torch.int32)
      # the kernel scales by 1/sqrt(h) inside; q already carries the
      # learned query scale, so cancel the kernel's factor
      ctx = flash_attention.FlashAttention(
          (q * py_utils.WeakScalar(math.sqrt(self._dim_per_head), q))
          .contiguous(), k.contiguous(), v.contiguous(), causal=causal,
          segment_ids=seg)
      if paddings is not None:
        # pad queries attend only pad keys here and real keys on the
        # einsum path: both garbage, zeroed for path parity
        ctx = py_utils.ApplyPadding(paddings, ctx)
      return self._PostProj(ctx), None
    mask = atten_mask
    if causal:
      cm = CausalMask(query_vec.shape[1], device=query_vec.device)
      mask = cm if mask is None else mask + cm
    if paddings is not None:
      pm = PaddingsToMask(paddings)
      mask = pm if mask is None else mask + pm
    if segment_ids is not None:
      sm = SegmentMask(segment_ids, segment_ids)
      mask = sm if mask is None else mask + sm
    ctx, probs = self._Atten(q, k, v, mask)
    return self._PostProj(ctx), probs

  # -- incremental decode (GShardDecode) --------------------------------------

  def _KvDtype(self, kv_cache_dtype=None):
    """(cache storage dtype, quantized?): an explicit override beats the
    layer param; None on both keeps the cache in the fprop dtype (float32,
    or bfloat16 under fprop_dtype=bfloat16), as the reference does. A name
    outside quant/kv.KV_CACHE_DTYPES raises ValueError."""
    return kv_quant.ResolveKvCacheDtype(
        kv_cache_dtype or self.p.kv_cache_dtype, self.fprop_dtype)

  def KvCacheDtype(self, kv_cache_dtype=None) -> str:
    """The effective cache storage dtype's name (telemetry)."""
    return kv_quant.DtypeName(self._KvDtype(kv_cache_dtype)[0])

  def KvBytesPerToken(self, kv_cache_dtype=None) -> int:
    """K + V bytes per cached token in this layer, scale sidecars
    included (the reference `quant/kv.KvBytesPerToken`)."""
    return kv_quant.KvBytesPerToken(self.p.num_heads, self._dim_per_head,
                                    kv_cache_dtype or self.p.kv_cache_dtype,
                                    self.fprop_dtype)

  def InitStates(self, batch_size: int, max_len: int) -> NestedMap:
    """Dense KV cache [B, max_len, N, H] in the layer's kv_cache_dtype and
    time_step, the host int of the next slot to write; an int8 cache adds
    float32 key_scale / value_scale [B, max_len, N] (unwritten slots stay
    (0, scale 0): exact zeros, and masked anyway)."""
    dtype, quantized = self._KvDtype()
    shape = (batch_size, max_len, self.p.num_heads, self._dim_per_head)
    states = NestedMap(
        key=torch.zeros(shape, dtype=dtype, device=self.device),
        value=torch.zeros(shape, dtype=dtype, device=self.device),
        time_step=0)
    if quantized:
      for name in ("key_scale", "value_scale"):
        states[name] = torch.zeros(shape[:3], dtype=torch.float32,
                                   device=self.device)
    return states

  def PagedDecodeEligible(self, max_len: int) -> bool:
    """The paged flash-decode read serves plain masked-softmax attention
    on a cache that is a whole number of pages. On the card the head dim,
    page size and cache dtype must be ones the kernel takes
    (`flash_decode.KernelLimitError`); else ExtendStep takes the dense
    read, as the reference does off its TPU tiling."""
    p = self.p
    if not (flash_decode.SupportedShape(max_len, p.decode_page_size)
            and p.atten_logit_cap == 0 and p.atten_dropout_prob == 0.0):
      return False
    return not self._OnCard() or flash_decode.KernelLimitError(
        self._dim_per_head, p.decode_page_size,
        self._KvDtype()[0]) is None

  def _ProjectStep(self, query_vec, position):
    """q (scaled), k, v [B, C, N, H] of query_vec [B, C, D]; rotary at
    `position`, float32 broadcastable to [B, C]."""
    q = self._HeadsProj("query", query_vec)
    k = self._HeadsProj("key", query_vec)
    v = self._HeadsProj("value", query_vec)
    if self.p.use_rotary_position_emb:
      q = self.rotary.FProp(q, position)
      k = self.rotary.FProp(k, position)
    return self.per_dim_scale.FProp(q), k, v

  @torch.no_grad()
  def ExtendStep(self, query_vec, cached_states: NestedMap, paddings=None):
    """query_vec [B, 1, D] at slot time_step; returns ([B, 1, D], states).

    Writes the new K/V into the cache in place (quantized first for an
    int8 cache). paddings: optional [B, S] float32 cache paddings, 1.0 =
    never attend (left-pad slots). With `decode_page_size` set, an
    eligible shape and a float32 or bfloat16 cache the read is the paged
    flash-decode op (only pages up to time_step); else the dense masked
    softmax over the whole (dequantized) cache."""
    t = cached_states.time_step
    q, k_new, v_new = self._ProjectStep(
        query_vec, torch.full((1, 1), float(t), device=query_vec.device))
    new_states = self._WriteCache(cached_states, k_new, v_new, t)
    key_cache, value_cache = new_states.key, new_states.value
    max_len = key_cache.shape[1]
    if self.PagedDecodeEligible(max_len) and "key_scale" not in new_states:
      # q carries the learned scale already; the op applies none
      ctx = flash_decode.FlashDecode(
          q, key_cache, value_cache, t, page_size=self.p.decode_page_size,
          cache_paddings=paddings)
    else:
      slot = torch.arange(max_len, device=query_vec.device)
      mask = torch.where(slot <= t, 0.0, _NEG_INF)[None, None, None, :]
      if paddings is not None:
        mask = mask + PaddingsToMask(paddings)
      ctx, _ = self._Atten(q, *_ReadCache(new_states, slice(None)), mask)
    new_states.time_step = t + 1
    return self._PostProj(ctx), new_states

  @staticmethod
  def _WriteCache(cached_states, k_new, v_new, t):
    """Writes k_new / v_new [B, C, N, H] at dense-cache slots [t, t + C)
    in place, quantized first (scales beside them) for an int8 cache and
    rounded to the cache's dtype otherwise. Returns the states without
    time_step, which the caller advances."""
    new_states = NestedMap(key=cached_states.key, value=cached_states.value)
    c = k_new.shape[1]
    if "key_scale" in cached_states:
      k_new, k_s = kv_quant.QuantizeKv(k_new)
      v_new, v_s = kv_quant.QuantizeKv(v_new)
      cached_states.key_scale[:, t:t + c] = k_s
      cached_states.value_scale[:, t:t + c] = v_s
      new_states.key_scale = cached_states.key_scale
      new_states.value_scale = cached_states.value_scale
    new_states.key[:, t:t + c] = k_new
    new_states.value[:, t:t + c] = v_new
    return new_states

  @torch.no_grad()
  def Prefill(self, query_vec, cached_states: NestedMap, paddings=None,
              live_len: int | None = None):
    """Chunked prefill: query_vec [B, C, D] at slots [time_step,
    time_step + C), K/V written in one slice assignment. Returns
    ([B, C, D], states).

    live_len: optional bound, time_step + C <= live_len: the read touches
    only the cache tiles that hold slots [0, live_len). The read walks
    the cache in tiles of _PREFILL_TILE slots with an online softmax, the
    reference `_PageAttend` op order with queries batched; tiles past a
    query are exact no-ops, so a trimmed read equals the full read
    bitwise (the reference's dense read over [0, live_len) sums the
    softmax in another order for each live_len and only matches to float
    tolerance). An int8 cache is quantized on write and its tiles are
    dequantized on read. bfloat16 queries (fprop_dtype=bfloat16) take a
    two-pass tile read that rounds where the reference's dense read does
    (`_RoundedTileRead`)."""
    t = cached_states.time_step
    c = query_vec.shape[1]
    dev = query_vec.device
    qpos = t + torch.arange(c, device=dev)                        # [C]
    q, k_new, v_new = self._ProjectStep(query_vec, qpos.float()[None])
    new_states = self._WriteCache(cached_states, k_new, v_new, t)
    s_len = new_states.key.shape[1]
    live = s_len if live_len is None else live_len
    if q.dtype != torch.float32:
      ctx = _RoundedTileRead(q, new_states, qpos, paddings, live,
                             self.p.atten_logit_cap)
      new_states.time_step = t + c
      return self._PostProj(ctx), new_states
    b, _, n, h = q.shape
    m = torch.full((b, c, n, 1), ragged_block_attend.NEG_INF, device=dev)
    l = torch.zeros((b, c, n, 1), device=dev)
    acc = torch.zeros((b, c, n, h), device=dev)
    for start in range(0, live, _PREFILL_TILE):
      sl = slice(start, min(start + _PREFILL_TILE, s_len))
      keep = _TileKeep(sl, qpos, paddings)
      k_tile, v_tile = _ReadCache(new_states, sl)
      m, l, acc = _TileAttend(q, k_tile.float(), v_tile.float(), keep, m, l,
                              acc, self.p.atten_logit_cap)
    ctx = ragged_block_attend._Finish(l, acc, q.dtype)
    if paddings is not None:
      ctx = _PadQueryContext(ctx, l, new_states, live)
    new_states.time_step = t + c
    return self._PostProj(ctx), new_states

  # -- block-table paged serving ---------------------------------------------

  def InitPagedStates(self, num_pages: int, page_size: int,
                      num_slots: int = 0,
                      kv_cache_dtype: str | None = None) -> NestedMap:
    """Global KV page pool [num_pages, page_size, N, H] shared by all
    sequences (the engine passes allocator pages + 1: the last page is the
    trash page padding tokens write to). num_slots is for O(1)-state
    mixers and ignored here. kv_cache_dtype overrides the layer's
    p.kv_cache_dtype; 'int8' adds the float32 key_scale / value_scale
    sidecars [num_pages, N, page_size]."""
    del num_slots
    dtype, quantized = self._KvDtype(kv_cache_dtype)
    n, h = self.p.num_heads, self._dim_per_head
    shape = (num_pages, page_size, n, h)
    states = NestedMap(
        key=torch.zeros(shape, dtype=dtype, device=self.device),
        value=torch.zeros(shape, dtype=dtype, device=self.device))
    if quantized:
      for name in ("key_scale", "value_scale"):
        states[name] = torch.zeros((num_pages, n, page_size),
                                   dtype=torch.float32, device=self.device)
    return states

  def BlockDecodeEligible(self, page_size: int, kv_dtype=None,
                          t_pages: int | None = None,
                          ragged: bool = False) -> bool:
    """Plain masked-softmax attention only: what the paged kernels serve;
    the paged steps take the gather-dense fallback for the rest, decided
    here before any launch. On the card the shape must also be one the
    step's kernel takes: the block-decode kernel's
    (`block_decode.KernelLimitError`, for the pool dtype kv_dtype, default
    the layer's, and a table of t_pages), or with ragged=True the ragged
    kernel's (`ragged_block_attend.KernelLimitError`), as the reference
    checks its TPU tiling."""
    p = self.p
    if not (page_size > 0 and p.rel_pos_emb_dim == 0
            and p.atten_logit_cap == 0 and p.atten_dropout_prob == 0.0):
      return False
    if not self._OnCard():
      return True
    h = self._dim_per_head
    if ragged:
      return ragged_block_attend.KernelLimitError(h, page_size) is None
    dtype = kv_dtype if kv_dtype is not None else self._KvDtype()[0]
    return block_decode.KernelLimitError(h, page_size, dtype,
                                         t_pages) is None

  def QuantizedDecodeEligible(self, page_size: int) -> bool:
    """The reference's name for the int8 kernels' gate, which in the port
    is BlockDecodeEligible itself (the reference adds its TPU tiling
    check); the steps call BlockDecodeEligible for every pool dtype."""
    return self.BlockDecodeEligible(page_size)

  @staticmethod
  def _WritePool(cached_states, phys, off, k_new, v_new):
    """Scatters k_new / v_new [..., N, H] to pool slots (phys, off) in
    place: quantized first for an int8 pool, with each scale row [..., N]
    scattered to the sidecar at [phys, :, off] (the reference's advanced
    index), and rounded to the pool's dtype otherwise. Returns the
    sidecars (None, None for a float pool)."""
    k_pool, v_pool = cached_states.key, cached_states.value
    if "key_scale" not in cached_states:
      k_pool.index_put_((phys, off), k_new.to(k_pool.dtype))
      v_pool.index_put_((phys, off), v_new.to(v_pool.dtype))
      return None, None
    k_new, k_s = kv_quant.QuantizeKv(k_new)
    v_new, v_s = kv_quant.QuantizeKv(v_new)
    k_scale, v_scale = cached_states.key_scale, cached_states.value_scale
    k_scale[phys, :, off] = k_s
    v_scale[phys, :, off] = v_s
    k_pool.index_put_((phys, off), k_new)
    v_pool.index_put_((phys, off), v_new)
    return k_scale, v_scale

  @torch.no_grad()
  def PagedStep(self, query_vec, cached_states: NestedMap, block_tables,
                q_pos, in_len):
    """One legacy continuous-batching step against the page pool.

    query_vec: [B, C, D], row b's tokens for global slots [q_pos[b],
    q_pos[b] + in_len[b]); queries past in_len[b] are padding, write to
    the trash page and give outputs the engine discards. C == 1 is a
    decode step (the block-decode op), C > 1 a mixed prefill step
    (`BlockPrefill`); a layer `BlockDecodeEligible` refuses reads its
    rows' gathered caches densely instead (`_GatherDense`). block_tables:
    [B, t_pages] int32; q_pos / in_len: [B] int32, all on the layer's
    device. Writes the new K/V into cached_states in place (quantized
    first into an int8 pool, whose scales go to the sidecars); returns
    ([B, C, D], cached_states)."""
    k_pool, v_pool = cached_states.key, cached_states.value
    np_total, page_size = k_pool.shape[0], k_pool.shape[1]
    t_pages = block_tables.shape[1]
    eligible = self.BlockDecodeEligible(page_size, k_pool.dtype, t_pages)
    b, c, _ = query_vec.shape
    dev = query_vec.device
    cols = torch.arange(c, device=dev)
    pos_i = q_pos.to(torch.int64)[:, None] + cols[None]            # [B, C]
    q, k_new, v_new = self._ProjectStep(query_vec, pos_i.float())
    # scatter the chunk's K/V through the block table before the read;
    # padding queries write to the trash page (pool page np_total - 1)
    valid = cols[None] < in_len.to(torch.int64)[:, None]           # [B, C]
    logical = torch.clamp(pos_i // page_size, 0, t_pages - 1)
    tables = torch.clamp(block_tables.to(torch.int64), 0, np_total - 1)
    phys = torch.where(valid, torch.gather(tables, 1, logical), np_total - 1)
    off = torch.where(valid, pos_i % page_size,
                      (cols % page_size)[None].expand(b, c))
    k_scale, v_scale = self._WritePool(cached_states, phys, off, k_new, v_new)
    if not eligible:
      # the gather-dense fallback: every query over its row's logical
      # cache, slots up to its own position (slots past a row's pages are
      # stale or foreign and masked)
      k_dense, v_dense = self._GatherDense(cached_states, block_tables)
      slot = torch.arange(t_pages * page_size, device=dev)
      mask = torch.where(slot[None, None, None, :] <= pos_i[:, None, :, None],
                         0.0, _NEG_INF)
      ctx, _ = self._Atten(q, k_dense, v_dense, mask)
    elif c == 1:
      ctx = block_decode.BlockDecode(
          q, k_pool, v_pool, block_tables, (q_pos + in_len).to(torch.int32),
          page_size=page_size, k_scale=k_scale, v_scale=v_scale)
    else:
      ctx = block_decode.BlockPrefill(
          q, k_pool, v_pool, block_tables, q_pos, in_len,
          page_size=page_size, k_scale=k_scale, v_scale=v_scale)
    return self._PostProj(ctx), cached_states

  @torch.no_grad()
  def RaggedStep(self, query_vec, cached_states: NestedMap, block_tables,
                 rows):
    """One PACKED continuous-batching step (core/ragged.py RaggedRows).

    query_vec: [1, T, D], all rows' tokens on one token axis; token t
    belongs to slot rows.row_of[t] and lands at global kv slot rows.pos[t]
    through that row's block table. Padding tokens (rows.valid False)
    scatter to the trash page and produce zeros the engine discards (on
    the gather-dense fallback, `_RaggedDense`, a read of slot 0).
    block_tables: [B, t_pages] int32 on the layer's device. Writes the new
    K/V into cached_states in place (quantized first into an int8 pool)
    and returns ([1, T, D], cached_states).
    """
    k_pool, v_pool = cached_states.key, cached_states.value
    np_total, page_size = k_pool.shape[0], k_pool.shape[1]
    eligible = self.BlockDecodeEligible(page_size, k_pool.dtype, ragged=True)
    b, t_pages = block_tables.shape
    t = query_vec.shape[1]
    dev = query_vec.device
    pos = rows.pos.to(torch.int64)                                 # [T]
    valid = rows.valid
    row = torch.clamp(rows.row_of.to(torch.int64), 0, b - 1)
    q_start = rows.row_q_pos[row].to(torch.int32)                  # [T]
    # tree rows embed at their logical position pos_ids (== pos on chains)
    q, k_new, v_new = self._ProjectStep(                           # [1,T,N,H]
        query_vec, rows.pos_ids[None].to(torch.float32))
    # scatter each token's K/V through ITS row's block table before the
    # read (later tokens of a prefill chunk attend to earlier ones);
    # padding tokens write to the trash page (pool page np_total - 1)
    logical = torch.clamp(pos // page_size, 0, t_pages - 1)
    tables = torch.clamp(block_tables.to(torch.int64), 0, np_total - 1)
    phys = torch.where(valid, tables[row, logical], np_total - 1)
    off = torch.where(valid, pos % page_size,
                      torch.arange(t, dtype=torch.int64, device=dev)
                      % page_size)
    k_scale, v_scale = self._WritePool(cached_states, phys, off, k_new[0],
                                       v_new[0])
    if not eligible:
      return self._PostProj(self._RaggedDense(
          q[0], cached_states, block_tables, row, pos, valid, q_start,
          rows)), cached_states
    # token t attends over its row's slots [0, pos[t]]; q_end = 0 marks
    # padding (the ragged op emits exact zeros there)
    q_end = torch.where(valid, pos + 1, 0).to(torch.int32)
    ctx = ragged_block_attend.RaggedAttend(
        q[0].contiguous(), k_pool, v_pool, block_tables,
        row.to(torch.int32), q_end, page_size=page_size, k_scale=k_scale,
        v_scale=v_scale, q_start=q_start, anc_lo=rows.anc_lo,
        anc_hi=rows.anc_hi)[None]
    return self._PostProj(ctx), cached_states

  # -- the gather-dense fallback -----------------------------------------------

  def _GatherDense(self, cached_states, block_tables):
    """Each row's logical cache, K and V [B, t_pages * P, N, H], gathered
    from the pool through its block table (dequantized to float32 for an
    int8 pool): the paged steps' read for a layer the paged kernels do
    not serve (`BlockDecodeEligible` false: a logit cap, attention
    dropout, or on the card a shape outside the kernels' limits), the
    reference's fallback. Its read is `_Atten`, whose dropout is the
    identity with no step seed, as in serving."""
    k = block_decode.GatherPages(cached_states.key, block_tables)
    v = block_decode.GatherPages(cached_states.value, block_tables)
    if "key_scale" in cached_states:
      k = kv_quant.DequantKv(
          k, block_decode.GatherScales(cached_states.key_scale, block_tables))
      v = kv_quant.DequantKv(
          v, block_decode.GatherScales(cached_states.value_scale,
                                       block_tables))
    return k, v

  def _RaggedDense(self, q, cached_states, block_tables, row, pos, valid,
                   q_start, rows):
    """The ragged step's gather-dense read: each token q [T, N, H] is one
    query over its row's gathered cache, slots [0, pos] that are its
    ancestors (`ragged_block_attend._AncestorOk`); a padding token sees
    slot 0 alone (an output the engine discards, never an all-masked
    row). Returns [1, T, N, H]."""
    k_dense, v_dense = self._GatherDense(cached_states, block_tables)
    slot = torch.arange(k_dense.shape[1], device=q.device)[None, None, None]
    col = lambda x: x.to(torch.int64)[:, None, None, None]
    horizon = torch.where(valid, pos, 0)
    ok = ragged_block_attend._AncestorOk(slot, slot - col(q_start),
                                         col(rows.anc_lo), col(rows.anc_hi))
    ok = ok | ~valid[:, None, None, None]
    mask = torch.where((slot <= col(horizon)) & ok, 0.0, _NEG_INF)
    ctx, _ = self._Atten(q[:, None], k_dense[row], v_dense[row], mask)
    return ctx[:, 0][None]


def _PadQueryContext(ctx, l, states, live: int):
  """A query that no cache slot may attend (a left-pad slot of a
  right-aligned prompt, every key up to it padded) gets what the
  reference's dense read gives it: its logits all sit at the mask value,
  so its softmax is uniform over the read's [0, live) slots and its
  context is the mean of V there. The online read leaves such a query at
  0. A pad query's output feeds no real token, but an int8 serving theta
  quantizes each projection's input with one scale over the whole call,
  pad rows included, so the pad rows must carry the reference's values."""
  v = _ReadCache(states, slice(0, live))[1].float()
  p = torch.full((), 1.0, device=v.device) / live
  mean_v = torch.sum(v * p, dim=1)[:, None].to(ctx.dtype)    # [B,1,N,H]
  return torch.where(l == 0, mean_v, ctx)


def _ReadCache(states, sl):
  """Slots `sl` of a dense cache's K and V as the reference reads them:
  dequantized to float32 for an int8 cache (quant/kv.DequantKv), in the
  cache's own dtype for a float32 or bfloat16 one."""
  k, v = states.key[:, sl], states.value[:, sl]
  if "key_scale" in states:
    return (kv_quant.DequantKv(k, states.key_scale[:, sl]),
            kv_quant.DequantKv(v, states.value_scale[:, sl]))
  return k, v


def _TileKeep(sl, qpos, paddings):
  """bool [B or 1, C, 1, P]: which slots of the tile `sl` each query of
  the chunk at slots qpos [C] attends (causal, and not a padded slot)."""
  slot = torch.arange(sl.start, sl.stop, device=qpos.device)
  keep = (slot[None, :] <= qpos[:, None])[None, :, None, :]
  if paddings is not None:
    keep = keep & (paddings[:, None, None, sl] < 0.5)
  return keep


# queries of one GEMM in the prefill's tile read: every chunk is read in
# blocks of this many (the last padded with zeros), one GEMM call of one
# shape per block, whatever the chunk's length
_READ_ROWS = 128


def _RowBlockMatmul(a, b):
  """a [B, C, N, X] times b [B, N, X, Y] -> [B, C, N, Y], one GEMM call of
  exactly _READ_ROWS rows of a per block (C padded with zero rows to whole
  blocks). A GEMM over all C rows picks its kernel and blocking by C, so
  a row's bits changed with C on the CPU (and a batched matrix-vector
  product's did on the card); calls of one shape run one kernel, whose
  every row sums its dot products in the same order, so a row's bits
  depend neither on C nor on its place in the block."""
  c = a.shape[1]
  blocks = -(-c // _READ_ROWS)
  a = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, blocks * _READ_ROWS - c))
  a = a.transpose(1, 2)                                       # [B, N, C, X]
  out = torch.cat([
      torch.matmul(a[:, :, i * _READ_ROWS:(i + 1) * _READ_ROWS], b)
      for i in range(blocks)], dim=2)                         # [B, N, C, Y]
  return out.transpose(1, 2)[:, :c]


def _RoundedTileRead(q, states, qpos, paddings, live: int, logit_cap=0.0):
  """The prefill's read for bfloat16 queries q [B, C, N, H]: the
  reference's dense `_Atten` over slots [0, live) at its rounding points,
  in `_PREFILL_TILE`-slot tiles (each tile's products in `_RowBlockMatmul`
  GEMMs), so that a trimmed read equals the full read bit for bit.

  The reference rounds the logits to the promoted dtype of q and the
  cache (bfloat16 for a bfloat16 cache; float32 for a float32 cache or a
  dequantized int8 one, whose products are exact), masks them in float32
  (a masked slot holds exactly the mask value, _NEG_INF), normalises the
  softmax over the whole row, rounds the probabilities to q's dtype and
  returns the context in the promoted dtype. Pass 1 keeps each tile's
  masked float32 logits and takes the row's max over the tiles, then its
  sum; pass 2 rounds p = exp(s - M) / L to bfloat16 and sums P.V in
  float32, rounded once at the end. A slot past `live` is not in the
  reference's row: -inf here, so it adds 0 to the sum even in a row with
  every slot masked, whose softmax is then uniform over [0, live) as the
  reference's is. Only float32 sums are taken in another order."""
  s_len = states.key.shape[1]
  dev = q.device
  tiles = []
  m = None
  for start in range(0, live, _PREFILL_TILE):
    sl = slice(start, min(start + _PREFILL_TILE, s_len))
    k_tile, v_tile = _ReadCache(states, sl)
    s = _RowBlockMatmul(q.float(), k_tile.float().permute(0, 2, 3, 1))
    s = s.to(torch.promote_types(q.dtype, k_tile.dtype))   # [B,C,N,P]
    if logit_cap > 0:
      cap = py_utils.WeakScalar(logit_cap, s)
      s = cap * py_utils.Tanh(s / cap)
    s = torch.where(_TileKeep(sl, qpos, paddings), s.float(), _NEG_INF)
    slot = torch.arange(sl.start, sl.stop, device=dev)
    s = torch.where(slot < live, s, float("-inf"))
    tiles.append((s, v_tile))
    tile_max = torch.amax(s, dim=-1, keepdim=True)
    m = tile_max if m is None else torch.maximum(m, tile_max)
  l = sum(torch.sum(torch.exp(s - m), dim=-1, keepdim=True) for s, _ in tiles)
  acc = 0.0
  for s, v_tile in tiles:
    p = (torch.exp(s - m) / l).to(q.dtype)
    acc = acc + _RowBlockMatmul(p.float(), v_tile.float().permute(0, 2, 1, 3))
  return acc.to(torch.promote_types(q.dtype, tiles[0][1].dtype))


def _TileAttend(q, k_tile, v_tile, keep, m, l, acc, logit_cap=0.0):
  """One cache tile of online-softmax attention for a chunk of queries
  (the reference `_PageAttend` op order). q: [B, C, N, H], k_tile/v_tile
  [B, P, N, H], keep bool broadcastable to [B, C, N, P], m/l [B, C, N, 1],
  acc [B, C, N, H]; logit_cap > 0 tanh-caps the logits as `_Atten` does.
  q.k and P.V go through `_RowBlockMatmul`, so each query's result has the
  same bits at any chunk length C (a trimmed read equals the full read)."""
  neg_inf = ragged_block_attend.NEG_INF
  s = _RowBlockMatmul(q, k_tile.permute(0, 2, 3, 1))          # [B,C,N,P]
  if logit_cap > 0:
    s = logit_cap * torch.tanh(s / logit_cap)
  s = torch.where(keep, s, neg_inf)
  m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
  m_safe = torch.where(m_new <= neg_inf * 0.5, 0.0, m_new)
  p = torch.exp(s - m_safe)
  alpha = torch.exp(m - m_new)
  l_new = alpha * l + torch.sum(p, dim=-1, keepdim=True)
  pv = _RowBlockMatmul(p, v_tile.permute(0, 2, 1, 3))          # [B,C,N,H]
  return m_new, l_new, acc * alpha + pv
