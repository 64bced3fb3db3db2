"""One-Billion-Words LM configs (port of lingvo_tpu/models/lm/params/one_billion_wds.py).

The reference's three experiments, registered under its keys
(`lm.one_billion_wds.OneBWdsTransformerLm`, ...), with its shapes, its
synthetic packed input and its learner: Adam with beta2 0.98,
LinearRampupCosineDecay (4000 warmup steps of 500,000), a global-norm
clip at 1.0, residual dropout 0.1 and 100 steps a loop.

- `OneBWdsTransformerLm`: 20 layers at width 1024 (16 heads, FFN 4096)
  over a 32,000-word tied head, batch 32 of 512 tokens.
- `WordLevelOneBwdsSampledSoftmax`: the same stack over the 793,470-word
  vocabulary with an untied sampled-softmax head of 4096 log-uniform
  negatives; its eval's full-softmax metrics come from the fused xent
  statistics (`models/lm/layers.TransformerLm`).
- `OneBWdsRealData`: the first's model on the real 1B-words shards
  through a WPM tokenizer. The port has neither the text input nor the
  tokenizer yet (ROADMAP item 11), so its datasets raise.
"""

from __future__ import annotations

from lingvo_tpu_torch import model_registry
from lingvo_tpu_torch.core import base_model_params
from lingvo_tpu_torch.core import learner as learner_lib
from lingvo_tpu_torch.core import optimizer as opt_lib
from lingvo_tpu_torch.core import schedule as sched_lib
from lingvo_tpu_torch.models.lm import input_generator
from lingvo_tpu_torch.models.lm import layers as lm_layers


@model_registry.RegisterSingleTaskModel
class OneBWdsTransformerLm(base_model_params.SingleTaskModelParams):
  """Word-level transformer LM on 1B-words-scale shapes."""

  VOCAB = 32000
  SEQ = 512
  BATCH = 32
  MODEL_DIM = 1024
  NUM_LAYERS = 20
  NUM_HEADS = 16
  HIDDEN_DIM = 4096

  def Train(self):
    return input_generator.SyntheticLmInput.Params().Set(
        batch_size=self.BATCH, seq_len=self.SEQ, vocab_size=self.VOCAB,
        packing=True)

  def Test(self):
    return input_generator.SyntheticLmInput.Params().Set(
        batch_size=self.BATCH, seq_len=self.SEQ, vocab_size=self.VOCAB,
        packing=True, seed=7)

  def Task(self):
    p = lm_layers.TransformerLm.Params()
    p.name = "one_billion_wds"
    p.vocab_size = self.VOCAB
    p.model_dim = self.MODEL_DIM
    p.num_layers = self.NUM_LAYERS
    p.num_heads = self.NUM_HEADS
    p.hidden_dim = self.HIDDEN_DIM
    p.residual_dropout_prob = 0.1
    p.train.learner = learner_lib.Learner.Params().Set(
        learning_rate=1e-3,
        optimizer=opt_lib.Adam.Params().Set(beta2=0.98),
        lr_schedule=sched_lib.LinearRampupCosineDecay.Params().Set(
            warmup_steps=4000, total_steps=500_000),
        clip_gradient_norm_to_value=1.0)
    p.train.tpu_steps_per_loop = 100
    return p


@model_registry.RegisterSingleTaskModel
class OneBWdsRealData(OneBWdsTransformerLm):
  """1B-words on the real shards through a WPM tokenizer (the reference's
  text input over `1bwds/training-monolingual.tokenized.shuffled` and
  `1bwds/vocab.wpm.txt`). Not ported: the repository holds neither the
  shards nor the vocabulary, and the text input and the tokenizer come
  with ROADMAP item 11."""

  def Train(self):
    raise NotImplementedError(
        "OneBWdsRealData's text input and WPM tokenizer come with ROADMAP "
        "item 11 (the 1B-words shards and vocabulary are not in the "
        "repository)")

  def Test(self):
    return self.Train()


@model_registry.RegisterSingleTaskModel
class WordLevelOneBwdsSampledSoftmax(OneBWdsTransformerLm):
  """Word-level 1B-words with a sampled softmax: the 793,470-word
  vocabulary trains against 4096 log-uniform negatives, and full
  [B, T, 793k] logits are never materialized."""

  VOCAB = 793_470
  NUM_SAMPLED = 4096

  def Task(self):
    p = super().Task()
    p.softmax_num_sampled = self.NUM_SAMPLED
    return p
