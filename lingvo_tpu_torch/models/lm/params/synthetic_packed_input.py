"""Dense LM configs (port of lingvo_tpu/models/lm/params/synthetic_packed_input.py).

The DenseLm family's model shapes (with the SSM-hybrid DenseLmSsmHybrid
and its tiny twin), synthetic packed input and learner exactly as the
reference defines them: `Train()` and `Test()` (the inputs, Test at seed
99), `Task()` (the model and its `train.learner`: Adafactor with beta1 0.9
and no parameter scaling, LinearRampupCosineDecay with 1000 warmup steps,
global-norm clip 1.0; 20 steps a loop). Each config is registered under
the reference's key (`lm.synthetic_packed_input.DenseLmTiny`), so
`python -m lingvo_tpu_torch.trainer --model=...` finds it. The MoE configs
(`MoELmTiny`, `MoELm64E`) wait for the MoE slice (ROADMAP item 11) and
are not registered. The reference's mesh comes with the parallelism slice.
"""

from __future__ import annotations

from lingvo_tpu_torch import model_registry
from lingvo_tpu_torch.core import base_model_params
from lingvo_tpu_torch.core import learner as learner_lib
from lingvo_tpu_torch.core import optimizer as opt_lib
from lingvo_tpu_torch.core import schedule as sched_lib
from lingvo_tpu_torch.core import ssm
from lingvo_tpu_torch.models.lm import input_generator
from lingvo_tpu_torch.models.lm import layers as lm_layers


class DenseLmTemplate(base_model_params.SingleTaskModelParams):
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

  def Test(self):
    return input_generator.SyntheticLmInput.Params().Set(
        batch_size=self.BATCH_SIZE, seq_len=self.SEQUENCE_LENGTH,
        vocab_size=self.VOCAB_SIZE, packing=True, seed=99)

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
    p.train.max_steps = self.MAX_STEPS
    p.train.tpu_steps_per_loop = 20
    return p


@model_registry.RegisterSingleTaskModel
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


@model_registry.RegisterSingleTaskModel
class DenseLm1B(DenseLmTemplate):
  """~1.3B params; single-host bench scale."""

  SEQUENCE_LENGTH = 1024
  MODEL_DIM = 2048
  NUM_LAYERS = 24
  NUM_HEADS = 16
  HIDDEN_DIM = 8192


@model_registry.RegisterSingleTaskModel
class DenseLmWord793k(DenseLmTemplate):
  """Word-level one-billion-words head (the reference's 793k-vocab
  recipe): dense [B, T, 793k] logits would be ~6.5 GB float32 a step
  before the backward, so the fused blockwise head is on, tied."""

  SEQUENCE_LENGTH = 256
  MODEL_DIM = 1024
  NUM_LAYERS = 8
  VOCAB_SIZE = 793_600    # 793471 words rounded up to a 1024 multiple
  XENT_BLOCK_SIZE = 1024  # divides VOCAB_SIZE: no masking, no weight pad


@model_registry.RegisterSingleTaskModel
class DenseLm8B(DenseLmTemplate):
  """Ref DenseLm8B2x2: 4 transformer blocks, model_dim 8192, ff 65536,
  128 heads, seq 1024 (~8B params)."""

  SEQUENCE_LENGTH = 1024
  MODEL_DIM = 8192
  NUM_LAYERS = 4
  NUM_HEADS = 128
  HIDDEN_DIM = 65536


@model_registry.RegisterSingleTaskModel
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


@model_registry.RegisterSingleTaskModel
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


@model_registry.RegisterSingleTaskModel
class DenseLm128B(DenseLmTemplate):
  """Ref DenseLm128B8x8: 64 blocks at the 8B dims (~137.7B params). Does
  not fit one card; its mesh comes with the parallelism slice."""

  SEQUENCE_LENGTH = 1024
  MODEL_DIM = 8192
  NUM_LAYERS = 64
  NUM_HEADS = 128
  HIDDEN_DIM = 65536


@model_registry.RegisterSingleTaskModel
class DenseLm175B(DenseLmTemplate):
  """Ref DenseLm175B32x32: GPT-3-scale shapes, 96 blocks, model_dim
  12288, ff 49152, 96 heads, seq 2048."""

  SEQUENCE_LENGTH = 2048
  MODEL_DIM = 12288
  NUM_LAYERS = 96
  NUM_HEADS = 96
  HIDDEN_DIM = 49152
  BATCH_SIZE = 1  # per host; global batch from the data axis


@model_registry.RegisterSingleTaskModel
class DenseLm1T(DenseLmTemplate):
  """Ref DenseLm1T16x16: ~1T params, 128 blocks, model_dim 16384, ff
  262144."""

  SEQUENCE_LENGTH = 512
  MODEL_DIM = 16384
  NUM_LAYERS = 128
  NUM_HEADS = 256
  HIDDEN_DIM = 262144
  BATCH_SIZE = 1
