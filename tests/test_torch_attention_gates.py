"""The attention gates of lingvo_tpu_torch against the CUDA kernels' limits.

The reference gates each Pallas kernel on the shapes its TPU can tile and
takes its dense path for the rest (`lingvo_tpu/core/attention.py`
`_FlashEligible`, `PagedDecodeEligible`, `BlockDecodeEligible`, through
each op's `SupportedOnTpu`, only when JAX runs on a TPU). The port's
gates read each op's `KernelLimitError`, only when the layer lives on a
CUDA device; the plain CPU versions take any head dim.

- On the CPU every gate answers true at head dims the kernels refuse; for
  a layer on the card (its device set to CUDA, the gate touching no
  tensor) each answers false there and true inside the limits.
- Each limits function agrees with its wrapper's checks on a grid of
  head dims and dtypes: the wrapper raises the function's reason before
  any launch, and passes its checks inside the limits (the library load
  that would follow is stubbed).
- `cuda` cases (skipped here): on the card a layer outside the limits
  takes the dense path and matches the CPU's dense path (`FProp` at head
  dim 24, `ExtendStep` at head dim 24 and a bf16 cache at 4), and the paged
  steps at head dim 260 take the gather-dense fallback, launch no paged
  kernel and match the CPU's fallback:

    python -m pytest tests/test_torch_attention_gates.py -m cuda
"""

import numpy as np
import pytest
import torch

from lingvo_tpu_torch.core import attention
from lingvo_tpu_torch.ops import block_decode
from lingvo_tpu_torch.ops import flash_attention
from lingvo_tpu_torch.ops import flash_decode
from lingvo_tpu_torch.ops import ragged_block_attend as rba

HEAD_DIMS = (4, 8, 12, 16, 24, 32, 48, 64, 72, 96, 128, 160, 256, 260)


def _Layer(h, n=2, device="cpu", **kw):
  return attention.MultiHeadedAttention.Params().Set(
      name="a", input_dim=h * n, num_heads=n, **kw).Instantiate(
          device=device)


def _OnCard(layer, monkeypatch):
  """The layer as the gates see it on a CUDA device (they read only its
  device's type, and touch no tensor)."""
  monkeypatch.setattr(layer, "device", torch.device("cuda"))
  return layer


@pytest.mark.parametrize("h", HEAD_DIMS)
def test_flash_gate_reads_the_kernel_limits(h, monkeypatch):
  layer = _Layer(h, use_flash_attention=True)
  assert layer._FlashEligible(None, None, 32)
  _OnCard(layer, monkeypatch)
  ok = h % 16 == 0 and h <= flash_attention.MAX_HEAD_DIM
  assert (flash_attention.KernelLimitError(h) is None) == ok
  assert layer._FlashEligible(None, None, 32) == ok


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("h", HEAD_DIMS)
def test_paged_decode_gate_reads_the_kernel_limits(h, kv, monkeypatch):
  layer = _Layer(h, decode_page_size=4, kv_cache_dtype=kv)
  assert layer.PagedDecodeEligible(16)
  _OnCard(layer, monkeypatch)
  dtype = getattr(torch, kv)
  ok = h in flash_decode.DTYPE_HEAD_DIMS.get(dtype, ())
  assert (flash_decode.KernelLimitError(h, 4, dtype) is None) == ok
  assert layer.PagedDecodeEligible(16) == ok
  assert not layer.PagedDecodeEligible(15)   # not whole pages: never


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("h", HEAD_DIMS)
def test_block_decode_gate_reads_the_kernel_limits(h, kv, monkeypatch):
  layer = _Layer(h, kv_cache_dtype=kv)
  assert layer.BlockDecodeEligible(16)
  assert layer.BlockDecodeEligible(16, ragged=True)
  _OnCard(layer, monkeypatch)
  dtype = getattr(torch, kv)
  ok = (h in block_decode.HEAD_DIMS
        and h * dtype.itemsize >= block_decode.MIN_ROW_BYTES)
  assert (block_decode.KernelLimitError(h, 16, dtype) is None) == ok
  assert layer.BlockDecodeEligible(16) == ok
  assert layer.BlockDecodeEligible(16, dtype, t_pages=64) == ok
  assert layer.BlockDecodeEligible(16, ragged=True) == (
      h % 4 == 0 and h <= rba.MAX_HEAD_DIM)
  # a page the kernels refuse, a table whose blocks hold too many scores
  assert not layer.BlockDecodeEligible(256)
  assert not layer.BlockDecodeEligible(4, ragged=True)
  assert not layer.BlockDecodeEligible(128, dtype, t_pages=1024)


class _Stubbed(Exception):
  """Raised by the stubbed library load: the wrapper's checks all passed."""


def _NoLibrary():
  raise _Stubbed()


@pytest.mark.parametrize("h", HEAD_DIMS)
def test_flash_wrapper_checks_agree_with_the_limits(h):
  """The kernels' layout check raises the function's reason first; a head
  dim inside the limits gets as far as the device check."""
  q = torch.zeros(1, 16, 2, h)
  reason = flash_attention.KernelLimitError(h)
  with pytest.raises(ValueError) as err:
    flash_attention._CheckCudaLayout([q], "FlashForward")
  assert str(err.value) == (f"FlashForward: {reason}" if reason else
                            "FlashForward runs on cpu or cuda, not cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", HEAD_DIMS)
def test_flash_decode_wrapper_checks_agree_with_the_limits(h, dtype,
                                                           monkeypatch):
  monkeypatch.setattr(flash_decode, "_Lib", _NoLibrary)
  monkeypatch.setattr(flash_decode, "Geometry", lambda *a: _NoLibrary())
  q = torch.zeros(1, 2, h)
  cache = torch.zeros(1, 8, 2, h, dtype=dtype)
  reason = flash_decode.KernelLimitError(h, 4, dtype)
  with pytest.raises(ValueError if reason else _Stubbed) as err:
    flash_decode._CudaDecode(q, cache, cache, 3, 4, None)
  if reason:
    assert str(err.value) == reason


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("h", HEAD_DIMS)
def test_block_decode_wrapper_checks_agree_with_the_limits(h, dtype,
                                                           monkeypatch):
  monkeypatch.setattr(block_decode, "_Lib", _NoLibrary)
  q = torch.zeros(1, 2, h)
  pool = torch.zeros(3, 4, 2, h, dtype=dtype)
  sc = torch.ones(3, 2, 4) if dtype == torch.int8 else None
  tables = torch.zeros(1, 2, dtype=torch.int32)
  lens = torch.ones(1, dtype=torch.int32)
  reason = block_decode.KernelLimitError(h, 4, dtype, 2)
  with pytest.raises(ValueError if reason else _Stubbed) as err:
    block_decode._CudaBlockDecode(q, pool, pool, tables, lens, 4, sc, sc,
                                  "x")
  if reason:
    assert str(err.value) == reason


@pytest.mark.parametrize("h", HEAD_DIMS)
def test_ragged_wrapper_checks_agree_with_the_limits(h, monkeypatch):
  monkeypatch.setattr(rba, "_Lib", _NoLibrary)
  q = torch.zeros(2, 2, h)
  pool = torch.zeros(3, 16, 2, h)
  ints = torch.zeros(2, dtype=torch.int32)
  reason = rba.KernelLimitError(h, 16)
  with pytest.raises(ValueError if reason else _Stubbed) as err:
    rba._CudaRaggedAttend(q, pool, pool, torch.zeros(1, 2, dtype=torch.int32),
                          ints, ints, 16, ints, ints, ints, None, None, "x")
  if reason:
    assert str(err.value) == reason


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: the gates read the CUDA kernels' "
                "limits only for a layer on the card")


def _Twins(h, cpu_kw=None, **kw):
  """The same attention layer on the CPU (with cpu_kw over kw) and on the
  card, same weights."""
  cpu = _Layer(h, **dict(kw, **(cpu_kw or {})))
  cpu.InstantiateVariables(torch.Generator("cpu").manual_seed(1))
  card = _Layer(h, device="cuda", **kw)
  card.load_state_dict(cpu.state_dict())
  return cpu, card


def _Rand(rng, *shape):
  return torch.as_tensor(rng.randn(*shape).astype(np.float32))


@pytest.mark.cuda
def test_flash_fprop_outside_the_limits_takes_the_einsum_path(cuda):
  """Head dim 24 (not a multiple of 16): the gate answers false on the
  card, FProp runs the einsum path (probs returned) and matches the
  CPU's einsum path within 1e-5; no flash launch."""
  cpu, card = _Twins(24, cpu_kw=dict(use_flash_attention=False),
                     use_flash_attention=True)
  assert not card._FlashEligible(None, None, 32)
  x = _Rand(np.random.RandomState(1), 2, 32, 48)
  launches = flash_attention.FlashForward.launches
  want, _ = cpu.FProp(x, causal=True)
  got, probs = card.FProp(x.cuda(), causal=True)
  torch.cuda.synchronize()
  assert probs is not None
  assert flash_attention.FlashForward.launches == launches
  assert float((got.cpu() - want).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("h, kv", [(24, "float32"), (4, "bfloat16")])
def test_extend_step_outside_the_limits_takes_the_dense_read(cuda, h, kv):
  """decode_page_size 4 at a head dim the flash-decode kernel refuses (24;
  4 on a bfloat16 cache): ExtendStep reads densely on the card, launches
  no kernel and matches the CPU's dense read (decode_page_size 0) within
  1e-5 over 3 steps. (The CPU's paged read of a bfloat16 cache rounds p
  to bfloat16, which the dense read does not, as in the reference.)"""
  cpu, card = _Twins(h, cpu_kw=dict(decode_page_size=0), decode_page_size=4,
                     kv_cache_dtype=kv)
  assert not card.PagedDecodeEligible(8)
  rng = np.random.RandomState(2)
  s_cpu, s_card = cpu.InitStates(2, 8), card.InitStates(2, 8)
  launches = flash_decode.FlashDecode.launches
  for _ in range(3):
    x = _Rand(rng, 2, 1, 2 * h)
    want, s_cpu = cpu.ExtendStep(x, s_cpu)
    got, s_card = card.ExtendStep(x.cuda(), s_card)
    torch.cuda.synchronize()
    assert float((got.cpu() - want).abs().max()) <= 1e-5
  assert flash_decode.FlashDecode.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [False, True])
def test_paged_steps_outside_the_limits_name_the_fallback(cuda, ragged):
  """Head dim 260 (past both paged kernels): on the card PagedStep and
  RaggedStep take the gather-dense fallback, decided by the gate before
  any launch (no paged kernel runs, no wrapper raises), and match the
  CPU's paged read (its plain versions take any head dim) on the same
  weights, pools and inputs within 1e-5: a prefill of 5 tokens, then one
  decode token. The ragged step's padding tokens are not compared: the
  plain ragged read gives them zeros, the fallback a read of slot 0."""
  from lingvo_tpu_torch.core import ragged as ragged_lib
  cpu, card = _Twins(260)
  assert not card.BlockDecodeEligible(16, torch.float32, 2)
  assert not card.BlockDecodeEligible(16, ragged=True)
  rng = np.random.RandomState(3)
  s_cpu, s_card = cpu.InitPagedStates(5, 16), card.InitPagedStates(5, 16)
  tables = torch.tensor([[3, 1]], dtype=torch.int32)
  launches = (block_decode.BlockDecode.launches, rba.RaggedAttend.launches)
  for q_pos, n in ((0, 5), (5, 1)):
    if ragged:
      rows = ragged_lib.BuildRaggedRows([n], [q_pos], 8, 8)
      x = _Rand(rng, 1, 8, 520)
      args = lambda dev: (tables.to(dev), ragged_lib.ToTorch(rows, dev))
      step = "RaggedStep"
    else:
      x = _Rand(rng, 1, n, 520)
      pos = torch.tensor([q_pos], dtype=torch.int32)
      args = lambda dev: (tables.to(dev), pos.to(dev),
                          torch.tensor([n], dtype=torch.int32, device=dev))
      step = "PagedStep"
    want, s_cpu = getattr(cpu, step)(x, s_cpu, *args("cpu"))
    got, s_card = getattr(card, step)(x.cuda(), s_card, *args("cuda"))
    torch.cuda.synchronize()
    live = torch.as_tensor(rows.valid)[None] if ragged else slice(None)
    assert float((got.cpu() - want)[live].abs().max()) <= 1e-5
  assert (block_decode.BlockDecode.launches,
          rba.RaggedAttend.launches) == launches
  for name in ("key", "value"):
    assert float((s_card[name].cpu() - s_cpu[name])[:-1].abs().max()) <= 1e-5
