"""Gated state-space-duality sequence mixer with an O(1) serving state (port of lingvo_tpu/core/ssm.py).

`GatedSSMLayer` plugs in where `attention.MultiHeadedAttention` sits
inside `transformer.TransformerAttentionLayer`: the same FProp signature
the same incremental-decode contract (`InitStates`, `ExtendStep`,
`Prefill`) and the same continuous-batching contract (`InitPagedStates`,
`PagedStep`, `RaggedStep`). The difference is the cache: instead of KV
caches and pages that grow with the sequence, each sequence holds a fixed
[N, H, S] state matrix.

Per head n, the mixer is a gated linear recurrence in SSD form:

    b_t = x_t W_b      [S]   write key        c_t = x_t W_c   [S] read key
    v_t = x_t W_v      [H]   value            g_t = x_t W_g   [H] gate
    a_t = exp(-softplus(x_t w_dt + b_dt) * exp(A_log))        scalar decay
    S_t = a_t S_{t-1} + v_t outer b_t                         [H, S] state
    y_t = S_t c_t + d_skip * v_t
    out_t = W_post . RMSNorm_head(y_t * silu(g_t))

Multi-token calls lower through `ops/ssd_scan.SsdScan` (the CUDA kernel
for CUDA tensors, the plain chunked version on the CPU); a one-token step
is `ssd_scan.SequentialStep`. Weights keep the reference's names and
layouts (w_v, w_b, w_c, w_gate [D, N, .], w_dt [D, N], w_post [D, N, H]),
so `convert.LoadJaxTheta` carries them over leaf for leaf.

The serving state is updated IN PLACE: `PagedStep` (and so `RaggedStep`)
writes the new [num_slots, N, H, S] state into the slot leaf it was given,
where the reference returns a new array. Under a repeat that leaf is a
view into the stacked leaf, which is how the port's stacks keep their
states.

The GShardDecode contract (`InitStates`, `ExtendStep`, `Prefill`) keeps
one [B, N, H, S] state per sequence and a host-int time_step; both steps
also write the state in place, for the same reason.

Activations at fprop_dtype=bfloat16 follow the reference's casts: the
projections and the output projection run in bfloat16, the scan, its
inputs, the gate, the norm and every state in float32 (so a state's
bytes do not depend on the fprop dtype).

Not ported yet (raise, naming the slice): the speculative-decoding
column states (`collect_col_states`, `col_parent`). Not supported, as in
the reference: cross-attention inputs, additive attention masks and
non-causal FProp.
"""

from __future__ import annotations

import torch

from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import py_utils
from lingvo_tpu_torch.core.nested_map import NestedMap
from lingvo_tpu_torch.core.py_utils import WeightInit, WeightParams
from lingvo_tpu_torch.ops import ssd_scan


class GatedSSMLayer(base_layer.BaseLayer):
  """Gated SSD mixer; plug-compatible with MultiHeadedAttention."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("input_dim", 0, "Model dim (set by the wrapping layer).")
    p.Define("hidden_dim", 0, "Total mixer hidden dim (N*H); 0 = input_dim.")
    p.Define("num_heads", 1, "Number of heads.")
    p.Define("dim_per_head", 0, "Per-head value dim H (0 = hidden/heads).")
    p.Define("state_dim", 64, "Per-head state width S (the O(1) cache is "
             "[N, H, S] floats per sequence).")
    p.Define("use_bias", True, "Bias on the value/gate/output projections.")
    p.Define("chunk_size", 64, "Scan chunk width Q for multi-token calls.")
    p.Define(
        "scan_lowering", "auto",
        "ops/ssd_scan lowering for multi-token calls: 'auto' or 'pallas' "
        "(the CUDA kernel on the card, the plain chunked version on the "
        "CPU), 'chunked' or 'sequential' (the plain versions).")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    p = self.p
    assert p.input_dim > 0 and p.num_heads > 0
    hidden = p.hidden_dim or p.input_dim
    self._dim_per_head = p.dim_per_head or hidden // p.num_heads
    n, h, s, d = p.num_heads, self._dim_per_head, p.state_dim, p.input_dim
    assert s > 0
    for name, width in (("v", h), ("b", s), ("c", s), ("gate", h)):
      self.CreateVariable(f"w_{name}",
                          WeightParams((d, n, width), p.params_init, p.dtype))
    if p.use_bias:
      for name in ("v", "gate"):
        self.CreateVariable(
            f"b_{name}",
            WeightParams((n, h), WeightInit.Constant(0.0), p.dtype))
    # input-dependent decay a = exp(-softplus(x w_dt + b_dt) * exp(a_log));
    # b_dt = -2 puts a near 0.88 per step at init
    self.CreateVariable("w_dt", WeightParams((d, n), p.params_init, p.dtype))
    self.CreateVariable(
        "b_dt", WeightParams((n,), WeightInit.Constant(-2.0), p.dtype))
    self.CreateVariable(
        "a_log", WeightParams((n,), WeightInit.Constant(0.0), p.dtype))
    self.CreateVariable(
        "d_skip", WeightParams((n,), WeightInit.Constant(1.0), p.dtype))
    # per-head RMS norm on the gated scan output, (1 + scale) convention
    self.CreateVariable(
        "norm_scale", WeightParams((n, h), WeightInit.Constant(0.0), p.dtype))
    self.CreateVariable("w_post",
                        WeightParams((d, n, h), p.params_init, p.dtype))
    if p.use_bias:
      self.CreateVariable(
          "b_post", WeightParams((d,), WeightInit.Constant(0.0), p.dtype))

  # -- projections -----------------------------------------------------------

  def _Project(self, x):
    """x: [B, T, D] -> (decay_log [B, T, N], b, c [B, T, N, S], v, gate
    [B, T, N, H]), all float32. The projections run in the fprop dtype
    (v and gate with their biases), then widen, as in the reference."""
    th = self.CastTheta()
    v = py_utils.Einsum("btd,dnh->btnh", x, th.w_v)
    gate = py_utils.Einsum("btd,dnh->btnh", x, th.w_gate)
    if self.p.use_bias:
      v = v + th.b_v
      gate = gate + th.b_gate
    b = py_utils.Einsum("btd,dns->btns", x, th.w_b).float()
    c = py_utils.Einsum("btd,dns->btns", x, th.w_c).float()
    dt_raw = (py_utils.Einsum("btd,dn->btn", x, th.w_dt).float()
              + th.b_dt.float())
    rate = torch.exp(th.a_log.float())
    # jax.nn.softplus is logaddexp(x, 0)
    decay_log = -torch.logaddexp(dt_raw, torch.zeros_like(dt_raw)) * rate
    return decay_log, b, c, v.float(), gate.float()

  def _Finish(self, y, v, gate):
    """Skip + gate + per-head RMS norm + output projection.

    y/v/gate: [B, T, N, H] float32 -> [B, T, D] in the fprop dtype: the
    gate and the norm run in float32, the output projection and its bias
    in the fprop dtype."""
    th = self.CastTheta()
    y = y + th.d_skip.float()[:, None] * v
    y = y * torch.nn.functional.silu(gate)
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6)
    y = y * (1.0 + th.norm_scale.float())
    out = py_utils.Einsum("btnh,dnh->btd", y.to(self.fprop_dtype), th.w_post)
    if self.p.use_bias:
      out = out + th.b_post
    return out

  @staticmethod
  def _MaskScanInputs(decay_log, v, paddings=None, segment_ids=None):
    """Applies the ssd_scan masking contract.

    Padded steps become exact identity (decay_log = 0, v = 0); segment
    starts become resets (decay_log = RESET_LOG). Resets go first, so a
    padded step can never resurrect cross-segment state."""
    if segment_ids is not None:
      prev = torch.cat([segment_ids[:, :1], segment_ids[:, :-1]], dim=1)
      is_reset = (segment_ids != prev)[..., None]            # [B, T, 1]
      decay_log = torch.where(is_reset, ssd_scan.RESET_LOG, decay_log)
    if paddings is not None:
      valid = 1.0 - paddings.float()                         # [B, T]
      decay_log = decay_log * valid[..., None]
      v = v * valid[..., None, None]
    return decay_log, v

  # -- training / full sequence ------------------------------------------------

  def FProp(self, query_vec, key_vec=None, value_vec=None, paddings=None,
            atten_mask=None, segment_ids=None, causal=False):
    """Returns ([B, T, D] output, None); the probs slot is kept for API
    parity with attention."""
    if key_vec is not None or value_vec is not None:
      raise NotImplementedError(
          "GatedSSMLayer is a self-mixer; cross-attention layers must keep "
          "MultiHeadedAttention")
    if atten_mask is not None:
      raise NotImplementedError(
          "GatedSSMLayer cannot apply additive attention masks; use "
          "paddings/segment_ids")
    if not causal:
      raise ValueError(
          "GatedSSMLayer is causal by construction; bidirectional stacks "
          "(causal=False) must keep attention")
    decay_log, b, c, v, gate = self._Project(query_vec)
    decay_log, v = self._MaskScanInputs(decay_log, v, paddings, segment_ids)
    y, _ = ssd_scan.SsdScan(decay_log, b, c, v, chunk_size=self.p.chunk_size,
                            lowering=self.p.scan_lowering)
    out = self._Finish(y, v, gate)
    if paddings is not None:
      out = py_utils.ApplyPadding(paddings, out)
    return out, None

  # -- incremental decode (GShardDecode) ---------------------------------------

  def InitStates(self, batch_size: int, max_len: int) -> NestedMap:
    """O(1) decode state: [B, N, H, S] float32 zeros, whatever max_len,
    and time_step, the host int of the next slot (as the attention
    caches keep it)."""
    del max_len
    n, h, s = self.p.num_heads, self._dim_per_head, self.p.state_dim
    return NestedMap(state=torch.zeros((batch_size, n, h, s),
                                       dtype=torch.float32,
                                       device=self.device),
                     time_step=0)

  @torch.no_grad()
  def ExtendStep(self, query_vec, cached_states: NestedMap, paddings=None):
    """query_vec [B, 1, D] at slot time_step; returns ([B, 1, D], states).

    The recurrence goes through ssd_scan.SequentialStep, the float ops of
    the 'sequential' lowering, as in the reference. paddings: optional
    [B, S] cache paddings; a padded slot is an identity step. The new
    state is written into cached_states.state in place (a repeat keeps
    the tensor leaves it was given)."""
    t = cached_states.time_step
    decay_log, b, c, v, gate = self._Project(query_vec)
    if paddings is not None:
      decay_log, v = self._MaskScanInputs(decay_log, v, paddings[:, t:t + 1])
    s_new, y = ssd_scan.SequentialStep(
        cached_states.state, decay_log[:, 0], b[:, 0], c[:, 0], v[:, 0])
    cached_states.state.copy_(s_new)
    out = self._Finish(y[:, None], v, gate)
    return out, NestedMap(state=cached_states.state, time_step=t + 1)

  @torch.no_grad()
  def Prefill(self, query_vec, cached_states: NestedMap, paddings=None,
              live_len: int | None = None):
    """Whole-chunk state priming: query_vec [B, C, D] for slots [t, t + C),
    t = time_step; returns ([B, C, D], states).

    One `ssd_scan.SsdScan` from the carried state (the kernel on the card)
    at the layer's chunk_size; a prefill from t = 0 over the whole
    sequence computes what FProp does. live_len is accepted for the
    attention layers' sake: the state is O(1) whatever the length. The
    new state is written into cached_states.state in place."""
    del live_len
    t = cached_states.time_step
    c_len = query_vec.shape[1]
    decay_log, b, c, v, gate = self._Project(query_vec)
    if paddings is not None:
      decay_log, v = self._MaskScanInputs(decay_log, v,
                                          paddings[:, t:t + c_len])
    y, s_new = ssd_scan.SsdScan(
        decay_log, b, c, v, s0=cached_states.state,
        chunk_size=self.p.chunk_size, lowering=self.p.scan_lowering)
    cached_states.state.copy_(s_new)
    out = self._Finish(y, v, gate)
    return out, NestedMap(state=cached_states.state, time_step=t + c_len)

  # -- continuous-batching serving ---------------------------------------------

  def StateBytesPerSlot(self) -> int:
    """Serving-state bytes per sequence (the float32 state matrix)."""
    return self.p.num_heads * self._dim_per_head * self.p.state_dim * 4

  def InitPagedStates(self, num_pages: int, page_size: int,
                      num_slots: int = 0,
                      kv_cache_dtype: str | None = None) -> NestedMap:
    """One fixed [N, H, S] state per engine slot, no share of the page
    pool. The engine passes num_slots = its slot count; the page geometry
    and kv_cache_dtype are for attention layers and ignored here."""
    del num_pages, page_size, kv_cache_dtype
    assert num_slots > 0, (
        "GatedSSMLayer.InitPagedStates needs the engine slot count "
        "(InitPagedDecodeState(..., num_slots=max_slots))")
    n, h, s = self.p.num_heads, self._dim_per_head, self.p.state_dim
    return NestedMap(state=torch.zeros((num_slots, n, h, s),
                                       dtype=torch.float32,
                                       device=self.device))

  @torch.no_grad()
  def PagedStep(self, query_vec, cached_states: NestedMap, block_tables,
                q_pos, in_len, collect_col_states: bool = False,
                col_parent=None):
    """One continuous-batching step; query_vec [B, C, D], B = engine slots.

    block_tables is ignored: the O(1) state needs no pages. A row starting
    a fresh request arrives with q_pos == 0 and its state restarts from
    zero, so an earlier occupant's state never leaks. Columns past a row's
    in_len are identity steps. Writes the new state into
    cached_states.state in place; returns ([B, C, D], cached_states)."""
    del block_tables
    if collect_col_states or col_parent is not None:
      raise NotImplementedError(
          "per-column SSM states (collect_col_states, col_parent) come with "
          "the speculative-decoding slice of the port")
    c_len = query_vec.shape[1]
    slots = cached_states.state
    state = torch.where((q_pos == 0)[:, None, None, None], 0.0, slots)
    decay_log, b_proj, c_proj, v, gate = self._Project(query_vec)
    # paddings convention: 1.0 = invalid step
    invalid = (torch.arange(c_len, device=query_vec.device)[None]
               >= in_len[:, None]).float()
    decay_log, v = self._MaskScanInputs(decay_log, v, invalid)
    if c_len == 1:
      s_new, y = ssd_scan.SequentialStep(
          state, decay_log[:, 0], b_proj[:, 0], c_proj[:, 0], v[:, 0])
      y = y[:, None]
    else:
      # the reference's chunk rule and its static width: every column of
      # the row view is scanned, the dead ones as identity steps
      y, s_new = ssd_scan.SsdScan(
          decay_log, b_proj, c_proj, v, s0=state,
          chunk_size=min(self.p.chunk_size, c_len),
          lowering=self.p.scan_lowering)
    slots.copy_(s_new)
    return self._Finish(y, v, gate), cached_states

  @torch.no_grad()
  def RaggedStep(self, query_vec, cached_states: NestedMap, block_tables,
                 rows):
    """Packed-token step (core/ragged.py RaggedRows): query_vec [1, T, D].

    The recurrence is per row, so the ragged step is `PagedStep` on a row
    view of the pack: gather each slot's tokens off the token axis through
    rows.row_cols ([B, wmax, D]), scan every row over the static wmax
    columns with rows.row_len masking the tail as identity steps (whole
    rows with 0 tokens this step included), and gather the outputs back to
    token order. rows.row_q_pos carries the slot-reuse reset (q_pos == 0).
    A padding token's output comes from the clipped (row_of, col_of)
    gather, as in the reference, and is discarded by the engine."""
    del block_tables
    x_rows = query_vec[0][rows.row_cols.long()]               # [B, wmax, D]
    wmax = x_rows.shape[1]
    out_rows, _ = self.PagedStep(x_rows, cached_states, None, rows.row_q_pos,
                                 rows.row_len)
    row = torch.clamp(rows.row_of.long(), 0, x_rows.shape[0] - 1)
    col = torch.clamp(rows.col_of.long(), 0, wmax - 1)
    return out_rows[row, col][None], cached_states
