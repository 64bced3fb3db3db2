"""Dense LM configs, serving fields (port of lingvo_tpu/models/lm/params/synthetic_packed_input.py).

The DenseLm family's model shapes exactly as the reference defines them.
Only `Task()` is ported, with the model fields the serving step reads;
the input generator and the learner come with the training slice.
"""

from __future__ import annotations

from lingvo_tpu_torch.models.lm import layers as lm_layers


class DenseLmTemplate:
  """Shared recipe for the DenseLm family (model widths)."""

  SEQUENCE_LENGTH = 1024
  BATCH_SIZE = 8  # per host
  VOCAB_SIZE = 32000
  MODEL_DIM = 1024
  NUM_LAYERS = 8
  NUM_HEADS = 16
  HIDDEN_DIM = 4096
  USE_REPEAT = True

  def Task(self):
    p = lm_layers.TransformerLm.Params()
    p.name = "lm"
    p.vocab_size = self.VOCAB_SIZE
    p.model_dim = self.MODEL_DIM
    p.num_layers = self.NUM_LAYERS
    p.num_heads = self.NUM_HEADS
    p.hidden_dim = self.HIDDEN_DIM
    p.use_repeat_layer = self.USE_REPEAT
    return p


class DenseLmTiny(DenseLmTemplate):
  """Smoke-test scale."""

  SEQUENCE_LENGTH = 64
  BATCH_SIZE = 4
  VOCAB_SIZE = 128
  MODEL_DIM = 64
  NUM_LAYERS = 2
  NUM_HEADS = 4
  HIDDEN_DIM = 128


class DenseLm1B(DenseLmTemplate):
  """~1.3B params; single-host bench scale."""

  SEQUENCE_LENGTH = 1024
  MODEL_DIM = 2048
  NUM_LAYERS = 24
  NUM_HEADS = 16
  HIDDEN_DIM = 8192
