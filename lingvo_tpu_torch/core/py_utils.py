"""Weight specs, initializers and tensor helpers (port of part of lingvo_tpu/core/py_utils.py).

What layers need to declare and initialize their weights: the
`WeightInit` catalogue, the `WeightParams` spec and `InitWeight`, which
fills a tensor in place from an explicit `torch.Generator`. The init
laws (fans, scales, truncation at two sigma) are the reference's; the
random numbers are torch's and differ from JAX's, so tests carry weights
across with `convert.LoadJaxTheta` rather than re-drawing them.

And what the train step needs: `ApplyPadding`, `SequenceMask` and
`GlobalNorm`, in the reference's float32 op order; the bf16 activations
policy, `MaybeBfloat16` and `WeakScalar`; the shape bucketing of
batch decode, `RoundUpToBucket`; and the per-step seeds of the stochastic
layers: `StepSeedContext` / `HasStepSeed` / `StepSeed`, `StepSeedSalt`,
`EvalContext` / `DoEval` and `GlobalStepContext`, thread-local stacks as
in the reference, plus `SeedState` / `InSeedState`, which carry a
snapshot of them into a function that runs again later (the backward's
recompute of a rematerialized layer, perhaps on another thread).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
import threading
from typing import Any, NamedTuple, Sequence

import torch

from lingvo_tpu_torch.core import threefry
from lingvo_tpu_torch.core.hyperparams import RegisterSerializableType


def GenerateSeedFromName(name: str) -> int:
  """Stable uint32 seed derived from a variable/layer path name."""
  digest = hashlib.md5(name.encode("utf-8")).hexdigest()
  return int(digest[:8], 16)


@RegisterSerializableType
@dataclasses.dataclass(frozen=True)
class WeightInit:
  """An initializer spec: method name + scale (the reference's catalogue)."""

  method: str = "xavier"
  scale: float = 1.0

  @classmethod
  def Gaussian(cls, scale: float = 1.0) -> "WeightInit":
    return cls("gaussian", scale)

  @classmethod
  def Uniform(cls, scale: float = 1.0) -> "WeightInit":
    return cls("uniform", scale)

  @classmethod
  def UniformUnitScaling(cls, scale: float = 1.0) -> "WeightInit":
    return cls("uniform_unit_scaling", scale)

  @classmethod
  def Xavier(cls, scale: float = 1.0) -> "WeightInit":
    return cls("xavier", scale)

  @classmethod
  def GaussianSqrtDim(cls, scale: float = 1.0) -> "WeightInit":
    return cls("gaussian_sqrt_dim", scale)

  @classmethod
  def GaussianSqrtFanIn(cls, scale: float = 1.0) -> "WeightInit":
    return cls("gaussian_sqrt_fanin", scale)

  @classmethod
  def GaussianSqrtFanOut(cls, scale: float = 1.0) -> "WeightInit":
    return cls("gaussian_sqrt_fanout", scale)

  @classmethod
  def UniformSqrtDim(cls, scale: float = 1.0) -> "WeightInit":
    return cls("uniform_sqrt_dim", scale)

  @classmethod
  def Constant(cls, scale: float = 0.0) -> "WeightInit":
    return cls("constant", scale)

  @classmethod
  def TruncatedGaussian(cls, scale: float = 1.0) -> "WeightInit":
    return cls("truncated_gaussian", scale)

  @classmethod
  def TruncatedGaussianSqrtDim(cls, scale: float = 1.0) -> "WeightInit":
    return cls("truncated_gaussian_sqrt_dim", scale)

  @classmethod
  def TruncatedGaussianSqrtFanIn(cls, scale: float = 1.0) -> "WeightInit":
    return cls("truncated_gaussian_sqrt_fanin", scale)


@dataclasses.dataclass
class WeightParams:
  """Spec for one learnable weight: shape, initializer and dtype."""

  shape: Sequence[int]
  init: WeightInit = dataclasses.field(default_factory=WeightInit)
  dtype: Any = torch.float32

  def __post_init__(self):
    self.shape = tuple(int(d) for d in self.shape)


@torch.no_grad()
def InitWeight(out: torch.Tensor, wp: WeightParams,
               generator: torch.Generator) -> torch.Tensor:
  """Fills `out` (shape wp.shape) in place by wp.init; returns it.

  `generator` must live on out's device."""
  shape = tuple(wp.shape)
  method, scale = wp.init.method, wp.init.scale

  def _dim0():
    return max(1, shape[0]) if shape else 1

  def _fans():
    if len(shape) < 1:
      return 1, 1
    if len(shape) == 1:
      return shape[0], shape[0]
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive

  def _Normal(std):
    return out.normal_(0.0, std, generator=generator)

  def _Uniform(limit):
    return out.uniform_(-limit, limit, generator=generator)

  def _Truncated(std):
    return torch.nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)

  if method == "constant":
    return out.fill_(scale)
  if method == "gaussian":
    return _Normal(scale)
  if method == "uniform":
    return _Uniform(scale)
  if method == "uniform_unit_scaling":
    return _Uniform(scale * math.sqrt(3.0 / _dim0()))
  if method == "gaussian_sqrt_dim":
    return _Normal(scale / math.sqrt(_dim0()))
  if method == "uniform_sqrt_dim":
    return _Uniform(scale / math.sqrt(_dim0()))
  if method == "gaussian_sqrt_fanin":
    return _Normal(scale / math.sqrt(_fans()[0]))
  if method == "gaussian_sqrt_fanout":
    return _Normal(scale / math.sqrt(_fans()[1]))
  if method == "xavier":
    fan_in, fan_out = _fans()
    return _Uniform(scale * math.sqrt(6.0 / (fan_in + fan_out)))
  if method == "truncated_gaussian":
    return _Truncated(scale)
  if method == "truncated_gaussian_sqrt_dim":
    return _Truncated(scale / math.sqrt(_dim0()))
  if method == "truncated_gaussian_sqrt_fanin":
    return _Truncated(scale / math.sqrt(_fans()[0]))
  raise ValueError(f"Unknown init method {method!r}")


def MaybeBfloat16(x: torch.Tensor, fprop_dtype) -> torch.Tensor:
  """Casts a floating tensor to the fprop dtype (the bf16 activations
  policy); others pass through. Differentiable: a float32 leaf cast to
  bf16 gets its gradient back in float32."""
  if fprop_dtype is not None and torch.is_floating_point(x):
    return x.to(fprop_dtype)
  return x


def Einsum(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """torch.einsum with the reference's promotion of mixed float dtypes
  (JAX's, and PyTorch's for elementwise ops): both operands in their
  promoted dtype, bfloat16 with float32 giving float32."""
  dtype = torch.promote_types(a.dtype, b.dtype)
  return torch.einsum(equation, a.to(dtype), b.to(dtype))


def WeakScalar(value: float, like: torch.Tensor):
  """A Python scalar as the reference's weakly typed one meets `like`:
  JAX rounds it to a bfloat16 tensor's dtype first, torch would multiply
  by the float32 value. float32 tensors take the float as it is."""
  if like.dtype == torch.float32:
    return value
  return torch.tensor(value, dtype=like.dtype)


class _TanhFn(torch.autograd.Function):
  """tanh whose backward is the transpose of the reference's JVP
  (g + g y)(1 - y): u = g (1 - y), then u + u y, op by op in the tensor's
  dtype (torch's own rounds g (1 - y^2) once)."""

  @staticmethod
  def forward(ctx, x):
    y = torch.tanh(x)
    ctx.save_for_backward(y)
    return y

  @staticmethod
  def backward(ctx, g):
    y, = ctx.saved_tensors
    u = g * (1 - y)
    return u + u * y


def Tanh(x: torch.Tensor) -> torch.Tensor:
  """tanh with the reference's gradient rounding in bfloat16 (float32
  takes torch.tanh: there the two agree to ulps)."""
  return torch.tanh(x) if x.dtype == torch.float32 else _TanhFn.apply(x)


class _SoftplusFn(torch.autograd.Function):
  """softplus as the reference's logaddexp(x, 0), op by op in the tensor's
  dtype: max(x, 0) + log1p(exp(-|x|)); its backward is the transpose of
  the reference's JVP, g exp(x - y), op by op (torch's own chain through
  the forward's ops rounds elsewhere)."""

  @staticmethod
  def forward(ctx, x):
    y = torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
    ctx.save_for_backward(x, y)
    return y

  @staticmethod
  def backward(ctx, g):
    x, y = ctx.saved_tensors
    return g * torch.exp(x - y)


def Softplus(x: torch.Tensor) -> torch.Tensor:
  """softplus with the reference's roundings in bfloat16 (float32 takes
  torch's softplus: there the two agree to ulps)."""
  if x.dtype == torch.float32:
    return torch.nn.functional.softplus(x)
  return _SoftplusFn.apply(x)


def ApplyPadding(padding: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """Zeroes padded positions; padding broadcast against x."""
  while padding.ndim < x.ndim:
    padding = padding[..., None]
  return x * (1.0 - padding).to(x.dtype)


def SequenceMask(paddings: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
  return (1.0 - paddings).to(dtype)


def GlobalNorm(tensors) -> torch.Tensor:
  """sqrt of the sum of squares of every tensor (float32), as one 0-d
  tensor on the tensors' device; 0.0 for an empty list."""
  tensors = list(tensors)
  if not tensors:
    return torch.zeros(())
  return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def ToDevice(x: torch.Tensor, device) -> torch.Tensor:
  """x on `device` without making the host wait: a CPU tensor bound for a
  card goes through pinned memory as a non-blocking copy (a copy from
  pageable memory synchronizes the stream; the pinned block is kept
  until the copy is done). Any other move is x.to(device)."""
  device = torch.device(device)
  if x.device.type == "cpu" and device.type == "cuda":
    return x.pin_memory().to(device, non_blocking=True)
  return x.to(device)


def RoundUpToBucket(n: int, buckets) -> int:
  """Smallest bucket >= n; n itself when it exceeds every bucket.

  Decode-shape bucketing: rounding prompt widths up to a small fixed set
  lets ragged widths share one decode setup (GShardDecode)."""
  if n < 0:
    raise ValueError(f"RoundUpToBucket needs n >= 0, got {n}")
  for b in sorted(buckets):
    if n <= b:
      return int(b)
  return int(n)


# -- per-step seeds and modes of the forward pass -----------------------------

_TLS = threading.local()


def _Stack(name: str) -> list:
  if not hasattr(_TLS, name):
    setattr(_TLS, name, [])
  return getattr(_TLS, name)


@contextlib.contextmanager
def _Pushed(name: str, value):
  stack = _Stack(name)
  stack.append(value)
  try:
    yield
  finally:
    stack.pop()


def GlobalStepContext(step):
  """Makes the global step available to layers during FProp (TrainStep
  enters it)."""
  return _Pushed("global_step", step)


def GetGlobalStep():
  """The current global step inside FProp, or None outside TrainStep."""
  stack = _Stack("global_step")
  return stack[-1] if stack else None


def StepSeedContext(key):
  """Makes a per-step key (a threefry key [2], on the CPU) available to
  the stochastic layers during FProp."""
  return _Pushed("step_seed", threefry._AsKey(key))


def HasStepSeed() -> bool:
  return bool(_Stack("step_seed"))


def StepSeed(name: str, extra=None):
  """A layer-unique key from the current step seed, as the reference
  derives it: fold_in(key, GenerateSeedFromName(name)), then each active
  StepSeedSalt from the outermost in, then `extra`. A CPU key [2]."""
  stack = _Stack("step_seed")
  if not stack:
    raise RuntimeError(
        "No StepSeedContext active; wrap the train FProp in "
        "py_utils.StepSeedContext(step_key)")
  key = threefry.FoldIn(stack[-1], GenerateSeedFromName(name))
  for salt in _Stack("seed_salt"):
    key = threefry.FoldIn(key, salt)
  if extra is not None:
    key = threefry.FoldIn(key, extra)
  return key


def StepSeedSalt(salt):
  """Folds `salt` (a repeat stack's layer index) into every StepSeed drawn
  inside."""
  return _Pushed("seed_salt", salt)


def EvalContext(do_eval: bool = True):
  """Marks FProp as eval-mode (dropout off)."""
  return _Pushed("do_eval", do_eval)


def DoEval() -> bool:
  stack = _Stack("do_eval")
  return stack[-1] if stack else False


class SeedState(NamedTuple):
  """What StepSeed, DoEval and GetGlobalStep read on this thread now."""
  step_seed: Any
  salts: tuple
  do_eval: Any
  global_step: Any


def CurrentSeedState() -> SeedState:
  top = lambda name: _Stack(name)[-1] if _Stack(name) else None
  return SeedState(top("step_seed"), tuple(_Stack("seed_salt")),
                   top("do_eval"), top("global_step"))


def InSeedState(state: SeedState, fn, *args, **kwargs):
  """fn(*args, **kwargs) with exactly `state`'s step seed, salts, eval
  mode and global step active on this thread, whatever is active around
  the call: a rematerialized layer's recompute runs inside backward(),
  where the forward's contexts have been left (and autograd may run it on
  a thread of its own)."""
  saved = {n: list(_Stack(n)) for n in ("step_seed", "seed_salt", "do_eval",
                                        "global_step")}
  _Stack("step_seed")[:] = [] if state.step_seed is None else [
      state.step_seed]
  _Stack("seed_salt")[:] = list(state.salts)
  _Stack("do_eval")[:] = [] if state.do_eval is None else [state.do_eval]
  _Stack("global_step")[:] = [] if state.global_step is None else [
      state.global_step]
  try:
    return fn(*args, **kwargs)
  finally:
    for n, v in saved.items():
      _Stack(n)[:] = v
