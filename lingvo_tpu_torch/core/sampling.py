"""Token sampling for the decode paths (port of lingvo_tpu/core/sampling.py).

One function, used by both serving surfaces (`runners/gshard_decode.py`
and `serving/engine.py`), with the reference's meaning:

- `temperature <= 0` is the argmax of the logits, the first maximal index
  on ties: the greedy path, which draws nothing at random.
- `temperature > 0` scales the logits by the temperature, keeps only the
  top-k per row when 0 < top_k < V (ties at the k-th value stay live),
  and draws from the categorical with threefry Gumbel noise: the
  reference's `jax.random.categorical`, bit for bit in its random bits
  (`core/threefry`). On the card the threshold, the mask and the draw are
  one kernel launch: no `torch.topk`.
- `rows` draws only some rows of the logits (the serving steps draw the
  rows they commit): a row's tokens depend only on its logits and its
  stream, so they equal the full draw's at those rows bit for bit.
- `row_seeds` gives each row its own stream: row i draws from
  fold_in(key, row_seeds[i]), then fold_in(., positions[i]) when
  positions are given, over the counters 0..V-1 of its row. Every
  sampling caller of the port passes them (the engine its requests'
  seeds, `GShardDecode` the row index), so temperature > 0 without
  row_seeds raises.

The scale is `logits * jit_arith.Reciprocal(t)`, the float32
reciprocal: the reference divides by the temperature inside its jitted
step programs, where XLA makes the division by a constant a product with
its float32 reciprocal, and that product is what its users' tokens come
from.

The draw runs in `ops/sample_tokens.SampleTokens`: its plain version on
the CPU, a hand kernel on the card. The speculative verifiers
(`SpecVerifyTokens`, `SpecVerifyTree`) come with speculative decoding.
"""

from __future__ import annotations

import torch

from lingvo_tpu_torch.core import jit_arith
from lingvo_tpu_torch.ops import sample_tokens


def _TransformLogits(logits, temperature: float, top_k: int):
  """Temperature + top-k mask, exactly as SampleFromLogits applies them."""
  return sample_tokens.MaskTopK(
      logits.float() * jit_arith.Reciprocal(temperature), top_k)


def SampleFromLogits(logits, key=None, temperature: float = 0.0,
                     top_k: int = 0, row_seeds=None, positions=None,
                     rows=None):
  """Draws one token id per row of logits [..., V].

  key: a CPU int64 tensor [2] (`core/threefry.PRNGKey`), the step's key;
  unused when temperature <= 0. temperature: <= 0 means greedy argmax.
  top_k: > 0 restricts sampling to the k largest logits per row.
  row_seeds: [...] integer per-row seeds on the logits' device (needed
  at temperature > 0); positions: optional [...] per-row output index,
  folded in after row_seeds. rows: optional int32 [R'] on the logits'
  device (temperature > 0 only): draw only rows rows[i] of the logits
  flattened to [N, V], each with row_seeds[i] (and positions[i]), both
  then [R']; the tokens are [R']. Returns [...] int32 token ids."""
  if temperature <= 0.0:
    if rows is not None:
      raise ValueError("rows selects the draws of temperature > 0 only")
    return torch.argmax(logits, dim=-1).to(torch.int32)
  if key is None or row_seeds is None:
    raise ValueError("temperature > 0 sampling needs a key and row_seeds")
  v = logits.shape[-1]
  lead = tuple(logits.shape[:-1]) if rows is None else tuple(rows.shape)
  flat = logits.float().reshape(-1, v)
  folds = [row_seeds] if positions is None else [row_seeds, positions]
  fold = torch.stack([f.reshape(-1).to(torch.int32) for f in folds], dim=1)
  tokens = sample_tokens.SampleTokens(
      flat, key, fold, jit_arith.Reciprocal(temperature), int(top_k),
      rows=rows)
  return tokens.reshape(lead)
