"""Dense LM configs (port of lingvo_tpu/models/lm/params/synthetic_packed_input.py).

The DenseLm family's model shapes (with the SSM-hybrid DenseLmSsmHybrid
and its tiny twin), synthetic packed input and learner exactly as the
reference defines them: `Train()` (the input), `Task()`
(the model and its `train.learner`: Adafactor with beta1 0.9 and no
parameter scaling, LinearRampupCosineDecay with 1000 warmup steps,
global-norm clip 1.0). The reference's mesh, eval input and registry stay
behind; configs are classes the caller instantiates.
"""

from __future__ import annotations

from lingvo_tpu_torch.core import learner as learner_lib
from lingvo_tpu_torch.core import optimizer as opt_lib
from lingvo_tpu_torch.core import schedule as sched_lib
from lingvo_tpu_torch.core import ssm
from lingvo_tpu_torch.models.lm import input_generator
from lingvo_tpu_torch.models.lm import layers as lm_layers


class DenseLmTemplate:
  """Shared recipe for the DenseLm family."""

  SEQUENCE_LENGTH = 1024
  BATCH_SIZE = 8  # per host
  VOCAB_SIZE = 32000
  MODEL_DIM = 1024
  NUM_LAYERS = 8
  NUM_HEADS = 16
  HIDDEN_DIM = 4096
  USE_REPEAT = True
  # If >0, the fused blockwise LM-head xent: the [B, T, V] logits are never
  # materialized. Prefer a value dividing VOCAB_SIZE; 0 = the dense head.
  XENT_BLOCK_SIZE = 0
  LEARNING_RATE = 2.5e-4
  MAX_STEPS = 1_000_000

  def Train(self):
    return input_generator.SyntheticLmInput.Params().Set(
        batch_size=self.BATCH_SIZE, seq_len=self.SEQUENCE_LENGTH,
        vocab_size=self.VOCAB_SIZE, packing=True)

  def Task(self):
    p = lm_layers.TransformerLm.Params()
    p.name = "lm"
    p.vocab_size = self.VOCAB_SIZE
    p.model_dim = self.MODEL_DIM
    p.num_layers = self.NUM_LAYERS
    p.num_heads = self.NUM_HEADS
    p.hidden_dim = self.HIDDEN_DIM
    p.use_repeat_layer = self.USE_REPEAT
    p.xent_block_size = self.XENT_BLOCK_SIZE
    p.train.learner = learner_lib.Learner.Params().Set(
        learning_rate=self.LEARNING_RATE,
        optimizer=opt_lib.Adafactor.Params().Set(
            beta1=0.9, multiply_by_parameter_scale=False),
        lr_schedule=sched_lib.LinearRampupCosineDecay.Params().Set(
            warmup_steps=1000, total_steps=self.MAX_STEPS),
        clip_gradient_norm_to_value=1.0)
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
  LEARNING_RATE = 3e-3
  MAX_STEPS = 2000


class DenseLm1B(DenseLmTemplate):
  """~1.3B params; single-host bench scale."""

  SEQUENCE_LENGTH = 1024
  MODEL_DIM = 2048
  NUM_LAYERS = 24
  NUM_HEADS = 16
  HIDDEN_DIM = 8192


class DenseLmSsmHybrid(DenseLmTemplate):
  """Hybrid O(1)-cache stack: attention every 6th layer, gated-SSD SSM
  mixers elsewhere. The serving state per sequence is 10 SSM matrices and
  2 layers of KV pages instead of 12 layers of KV pages."""

  SEQUENCE_LENGTH = 1024
  MODEL_DIM = 1024
  NUM_LAYERS = 12
  NUM_HEADS = 16
  HIDDEN_DIM = 4096
  MIXER_ATTEN_EVERY_N = 6
  SSM_STATE_DIM = 64
  SSM_CHUNK_SIZE = 64

  def Task(self):
    p = super().Task()
    p.mixer_tpl = ssm.GatedSSMLayer.Params().Set(
        state_dim=self.SSM_STATE_DIM, chunk_size=self.SSM_CHUNK_SIZE)
    p.mixer_atten_every_n = self.MIXER_ATTEN_EVERY_N
    return p


class DenseLmSsmHybridTiny(DenseLmSsmHybrid):
  """Smoke-test scale of the hybrid stack: attention every 2nd layer."""

  SEQUENCE_LENGTH = 64
  BATCH_SIZE = 4
  VOCAB_SIZE = 128
  MODEL_DIM = 64
  NUM_LAYERS = 2
  NUM_HEADS = 4
  HIDDEN_DIM = 128
  MIXER_ATTEN_EVERY_N = 2
  SSM_STATE_DIM = 16
  SSM_CHUNK_SIZE = 8
  LEARNING_RATE = 3e-3
  MAX_STEPS = 2000
