"""LM inputs: synthetic packed sequences (port of part of lingvo_tpu/models/lm/input_generator.py).

`SyntheticLmInput` produces the packed format the DenseLm configs train
on (ids, labels, paddings, segment_ids, segment_pos) with the reference's
generating process and numpy seeding, so the same seed gives the same
bytes as the reference. The file-backed `TextLmInput` and the masked-LM
input come with a later slice.
"""

from __future__ import annotations

import numpy as np

from lingvo_tpu_torch.core import base_input_generator
from lingvo_tpu_torch.core.nested_map import NestedMap


class SyntheticLmInput(base_input_generator.BaseInputGenerator):
  """Deterministic synthetic LM batches.

  Each segment is a random pattern of `pattern_len` tokens tiled to the
  segment length: after one period the continuation is fully determined by
  context, so log-pplx falls well below the uniform bound as a model
  learns."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("seq_len", 512, "Tokens per row.")
    p.Define("vocab_size", 32000, "Vocab.")
    p.Define("pattern_len", 8, "Period of the repeated pattern.")
    p.Define("packing", True, "Emit segment_ids/segment_pos (2 segments).")
    p.Define("seed", 0, "Base seed.")
    return p

  def __init__(self, params):
    super().__init__(params)
    self._step = 0

  def Seek(self, batch_index: int) -> None:
    """Batch i is drawn from a RandomState seeded by (seed, i) alone."""
    self._step = int(batch_index)

  def _Sequence(self, rng, length):
    pat = rng.randint(1, self.p.vocab_size, self.p.pattern_len)
    reps = -(-length // self.p.pattern_len)
    return np.tile(pat, reps)[:length].astype(np.int32)

  def _InputBatch(self) -> NestedMap:
    p = self.p
    rng = np.random.RandomState((p.seed + 7919 * self._step) % (2**31))
    self._step += 1
    b, t = p.batch_size, p.seq_len
    ids = np.zeros((b, t), np.int32)
    labels = np.zeros((b, t), np.int32)
    segment_ids = np.zeros((b, t), np.int32)
    segment_pos = np.zeros((b, t), np.int32)
    paddings = np.zeros((b, t), np.float32)
    segs = [(0, t // 2), (t // 2, t)] if p.packing else [(0, t)]
    for i in range(b):
      for si, (s, e) in enumerate(segs):
        seq = self._Sequence(rng, e - s + 1)
        ids[i, s:e] = seq[:-1]
        labels[i, s:e] = seq[1:]
        segment_ids[i, s:e] = si + 1
        segment_pos[i, s:e] = np.arange(e - s)
    out = NestedMap(ids=ids, labels=labels, paddings=paddings)
    if p.packing:
      out.segment_ids = segment_ids
      out.segment_pos = segment_pos
    return out
