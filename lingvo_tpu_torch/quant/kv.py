"""KV-cache quantization: per-token-per-head int8 with float32 scale sidecars (port of lingvo_tpu/quant/kv.py).

The numerics contract, as in the reference:

- Quantization happens once, when a token's K/V is written into its page
  (`PagedStep`, `RaggedStep`) or cache row (`ExtendStep`, `Prefill`).
  Each written row [N, H] gets one symmetric max-abs scale per head,
  `scale = max(amax * float32(1 / 127), 1e-8)`, and `round(x / scale)`
  clipped to [-128, 127]. No write ever revisits a token already written.
- Dequantization happens when the pages are read: inside the attention
  kernels (`ops/block_decode._DequantPages`, and its CUDA twins) or just
  before the dense read.
- The paged pool's scale sidecars are stored transposed, [num_pages, N,
  page_size] float32, so the scales of one (page, head) are contiguous.
  The dense decode cache keeps [B, L, N].

The int8 values and scales are bitwise those of the reference's jitted
serving programs, where every write happens: the same float32 ops in the
same order. The reference writes `amax / 127.0`, which XLA compiles to a
product with the float32 reciprocal of 127; the port multiplies by it on
every device (`core/jit_arith.ScaleFromAmax`; eager JAX divides, and
differs in the last bit of some scales). Then a true division by the
scale, round half to even, clip, cast.
"""

from __future__ import annotations

import torch

from lingvo_tpu_torch.core import jit_arith

# Storage dtypes the KV pools understand. None / '' keeps the fprop dtype
# (float32, or bfloat16 under fprop_dtype=bfloat16). Only int8 carries
# scale sidecars.
KV_CACHE_DTYPES = ("float32", "bfloat16", "int8")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}
_NAMES = {v: k for k, v in _DTYPES.items()}


def ResolveKvCacheDtype(kv_cache_dtype, fprop_dtype=torch.float32):
  """-> (pool storage dtype, quantized?). None / '' keeps fprop_dtype;
  'float32' / 'bfloat16' change only the storage dtype; 'int8' also
  switches on the scale sidecars and quantize-on-write. Any other name
  raises ValueError."""
  if not kv_cache_dtype:
    return fprop_dtype, False
  if kv_cache_dtype not in KV_CACHE_DTYPES:
    raise ValueError(
        f"kv_cache_dtype={kv_cache_dtype!r} not in {KV_CACHE_DTYPES}")
  return _DTYPES[kv_cache_dtype], kv_cache_dtype == "int8"


def DtypeName(dtype: torch.dtype) -> str:
  """'float32' / 'bfloat16' / 'int8': the reference's dtype names."""
  return _NAMES[dtype]


def QuantizeKv(x):
  """[..., N, H] float K/V rows -> ([..., N, H] int8, [..., N] float32
  scale). Symmetric per-head max-abs over H; the 1e-8 floor makes an
  all-zero row quantize and dequantize to zeros."""
  x32 = x.float()
  amax = torch.amax(torch.abs(x32), dim=-1)
  scale = jit_arith.ScaleFromAmax(amax)
  q = torch.clamp(torch.round(x32 / scale[..., None]), -128, 127)
  return q.to(torch.int8), scale


def DequantKv(q, scale):
  """([..., N, H] int8, [..., N] float32) -> [..., N, H] float32."""
  return q.float() * scale[..., None].float()


def KvBytesPerToken(num_heads: int, dim_per_head: int, kv_cache_dtype,
                    fprop_dtype=torch.float32) -> int:
  """K + V bytes one cached token costs in one attention layer, sidecars
  included (int8 adds 2 * N float32 scales per token)."""
  dtype, quantized = ResolveKvCacheDtype(kv_cache_dtype, fprop_dtype)
  per = 2 * num_heads * dim_per_head * dtype.itemsize
  if quantized:
    per += 2 * num_heads * 4
  return per


def StackKvCensus(task, kv_cache_dtype=None):
  """A TransformerLm-shaped task's stack -> its KV telemetry dict.

  Walks the stack shapes the LM builds (Stacked x_layers, a Repeated
  body, a Repeated body of Stacked blocks; the port's Repeated keeps one
  body per repeat and the first stands for all) and sums repetitions x
  each attention layer's `KvBytesPerToken`. SSM mixers keep O(1) state
  slots, not KV, and add nothing. Returns None when the task has no
  stack."""
  stack = getattr(task, "stack", None)
  if stack is None:
    return None
  if hasattr(stack, "x_layers"):
    layers = [(layer, 1) for layer in stack.x_layers]
  else:
    reps, body = stack.p.num_layers, stack.body[0]
    inner = body.x_layers if hasattr(body, "x_layers") else [body]
    layers = [(layer, reps) for layer in inner]
  attens = [(layer.self_atten.atten, reps) for layer, reps in layers
            if hasattr(layer.self_atten.atten, "KvBytesPerToken")]
  if not attens:
    return {"kv_cache_dtype": None, "kv_bytes_per_token": 0,
            "attention_layers": 0}
  total = sum(reps * a.KvBytesPerToken(kv_cache_dtype) for a, reps in attens)
  return {
      "kv_cache_dtype": attens[0][0].KvCacheDtype(kv_cache_dtype),
      "kv_bytes_per_token": int(total),
      "attention_layers": int(sum(reps for _, reps in attens)),
  }
