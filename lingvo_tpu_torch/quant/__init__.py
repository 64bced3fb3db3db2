"""Quantized serving: low-bit KV caches and integer-matmul weight serving (port of lingvo_tpu/quant).

The subsystem spans the stack: `quant/kv.py` owns the KV-cache numerics
(quantize-on-write / dequantize-on-read, byte accounting, stack census),
`quant/weights.py` owns the serving-theta rewrite that turns exported
`theta_int8` artifacts (or a live float theta) into `Int8Weight` leaves
the layers consume through integer matmuls (`core/quant_utils.py`, whose
product runs on the card as the kernels of `ops/int8_matmul.py`). Entry
points are the `kv_cache_dtype` and `serve_int8_weights` knobs of
`ServingLoop` / `GShardDecode` / `TransformerLm.Params`.
"""
