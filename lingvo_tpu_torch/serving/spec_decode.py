"""The serving stack census (port of part of lingvo_tpu/serving/spec_decode.py).

Only `MixerLayers` and `MixerCensus`, which the serving engine uses to
classify a stack's mixers and price their states. The draft sources and
the verify step of speculative decoding come with the spec-decode slice of
the port.
"""

from __future__ import annotations


def MixerLayers(task):
  """[(mixer_layer, multiplicity)] over the whole stack.

  Handles the stack shapes the LM builds: a Stacked stack (x_layers), a
  Repeated stack of TransformerLayers, and the hybrid Repeated stack whose
  body is a StackedTransformerLayers block (body.x_layers, each repeated).
  The port's repeat keeps one body per repeat; the first stands for all."""
  stack = task.stack
  body = getattr(stack, "body", None)
  if body is not None:
    reps = stack.p.num_layers
    inner = body[0].x_layers if hasattr(body[0], "x_layers") else [body[0]]
    return [(layer.self_atten.atten, reps) for layer in inner]
  return [(layer.self_atten.atten, 1) for layer in stack.x_layers]


def MixerCensus(task) -> dict:
  """Counts attention vs O(1)-state mixers; prices the per-slot state.

  A mixer is O(1)-state iff it exposes StateBytesPerSlot (the core/ssm.py
  contract); every other mixer is a paged-KV attention layer. The price
  of a KV page is quant/kv.StackKvCensus's, as in the reference."""
  num_attention = num_ssm = state_bytes = 0
  for mixer, reps in MixerLayers(task):
    if hasattr(mixer, "StateBytesPerSlot"):
      num_ssm += reps
      state_bytes += reps * mixer.StateBytesPerSlot()
    else:
      num_attention += reps
  return {
      "num_attention": num_attention,
      "num_ssm": num_ssm,
      "decode_state_bytes_per_slot": state_bytes,
  }
