"""Optimizers as in-place update rules (port of part of lingvo_tpu/core/optimizer.py).

The reference's optimizers are pure functions `(state, grads, params, lr,
step) -> (new_params, new_state)` over theta pytrees. Here `Update`
writes the new parameters and slots IN PLACE, under `torch.no_grad()`,
one leaf group at a time, so no second copy of theta or of the slots is
ever held. A leaf is a tensor or a `base_layer.StackedLeaf`: the per-layer
parameters of a repeat stack, which the reference keeps stacked on a
leading axis. Every rule is applied to the stacked leaf as the reference
applies it (the factoring decision on the stacked shape, the update RMS
over all layers), while the parameters stay per layer; the slots of a
stacked leaf are stacked, as the reference's are.

`Update(..., skipped=...)` takes the learner's 0-d skip flag and keeps the
old value of every parameter and slot where it is set (the reference's
rollback by `jnp.where`), still without a host sync.

Ported: SGD, Momentum, RMSProp, Adagrad, Adam, AdamW, Adafactor, the
gradient `Accumulator`, `CompositeOptimizer`, `DistributedShampoo`,
`EGDD` and `AdaGraft`. The rules keep their slots under the reference's
names, one {path: tensor} dict per slot (`m`, `v`, ...), a repeat
stack's slot stacked. Their float32 arithmetic follows the reference's
jitted program: Python constants are float32 constants, and a division
by one (the Accumulator's mean) is a product with its float32
reciprocal (`jit_arith.Reciprocal`). A rule that takes a norm or a
matrix shape of a leaf (Adafactor's RMS, Shampoo's preconditioning test,
EGDD's and AdaGraft's per-tensor scales) takes it over a repeat stack's
whole stacked leaf, as the reference does.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import jit_arith
from lingvo_tpu_torch.core import py_utils
from lingvo_tpu_torch.core.nested_map import NestedMap


def Members(leaf) -> tuple:
  """The per-layer tensors of a leaf: itself, or a StackedLeaf's layers."""
  if isinstance(leaf, base_layer.StackedLeaf):
    return leaf.layers
  return (leaf,)


def _Write(dst: torch.Tensor, new: torch.Tensor, skipped) -> None:
  if skipped is None:
    dst.copy_(new)
  else:
    dst.copy_(torch.where(skipped, dst, new))


def _CopyLeaf(leaf):
  """A copy of a leaf (a StackedLeaf's layers copied one by one)."""
  if isinstance(leaf, base_layer.StackedLeaf):
    return base_layer.StackedLeaf(tuple(x.clone() for x in leaf.layers))
  return leaf.clone()


def _Slice(slot: torch.Tensor, stacked: bool, i: int) -> torch.Tensor:
  """Layer i's view of a leaf's slot (the slot itself for a plain leaf)."""
  return slot[i] if stacked else slot


def _SumSquares(tensors) -> torch.Tensor:
  return sum(torch.sum(torch.square(t)) for t in tensors)


class BaseOptimizer(base_layer.BaseLayer):
  """InitState(params) -> state; Update(...) writes params and state."""

  def InitState(self, params: dict) -> NestedMap:
    del params
    return NestedMap()

  def Update(self, state: NestedMap, grads: dict, params: dict, lr, step,
             skipped=None) -> None:
    """params/grads: {path: tensor or StackedLeaf}, the same keys and
    shapes; lr a 0-d float32 tensor; skipped None or a 0-d bool tensor on
    the parameters' device. Updates params and state in place."""
    raise NotImplementedError


class _Elementwise(BaseOptimizer):
  """An optimizer whose rule acts element by element: `_SLOTS` names its
  slots ({name: initial value}), `_Rule(w, g, slots, lr, consts)` returns
  the new parameter and {slot: new value} for one per-layer tensor, and
  `_Consts(step)` the step's scalars. A stacked leaf's layers are updated
  one by one against their slices of the stacked slots."""

  _SLOTS: dict = {}

  def _SlotInit(self, name):
    return self._SLOTS[name]

  def InitState(self, params):
    state = NestedMap()
    for name in self._SLOTS:
      state[name] = {
          k: torch.full(tuple(leaf.shape), float(self._SlotInit(name)),
                        dtype=torch.float32, device=Members(leaf)[0].device)
          for k, leaf in params.items()}
    return state

  def _Consts(self, step) -> dict:
    del step
    return {}

  def _Rule(self, w, g, slots, lr, consts):
    raise NotImplementedError

  @torch.no_grad()
  def Update(self, state, grads, params, lr, step, skipped=None):
    consts = dict(self._Consts(step), lr=lr)
    on_device = {}   # the step's scalars, copied once to each device
    for key, leaf in params.items():
      stacked = isinstance(leaf, base_layer.StackedLeaf)
      dev = Members(leaf)[0].device
      if dev not in on_device:
        on_device[dev] = {k: py_utils.ToDevice(v, dev)
                          for k, v in consts.items()}
      c = on_device[dev]
      lr_d = c["lr"]
      for i, (w, g) in enumerate(zip(Members(leaf), Members(grads[key]))):
        slots = {n: (state[n][key][i] if stacked else state[n][key])
                 for n in self._SLOTS}
        new_w, new_slots = self._Rule(w, g, slots, lr_d, c)
        for n, value in new_slots.items():
          _Write(slots[n], value, skipped)
        _Write(w, new_w, skipped)


def _F32(x) -> torch.Tensor:
  return torch.tensor(np.float32(x), dtype=torch.float32)


class SGD(_Elementwise):

  def _Rule(self, w, g, slots, lr, consts):
    return w - lr * g.to(w.dtype), {}


class Momentum(_Elementwise):

  _SLOTS = {"m": 0.0}

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("momentum", 0.9, "Momentum coefficient.")
    p.Define("use_nesterov", False, "Nesterov variant.")
    return p

  def _Rule(self, w, g, slots, lr, consts):
    p = self.p
    m = p.momentum * slots["m"] + g
    upd = p.momentum * m + g if p.use_nesterov else m
    return w - lr * upd.to(w.dtype), {"m": m}


class RMSProp(_Elementwise):

  _SLOTS = {"ms": 1.0, "mom": 0.0}

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("decay", 0.9, "Decay of the moving second moment.")
    p.Define("momentum", 0.0, "Optional momentum.")
    p.Define("epsilon", 1.0, "Stability term (ref default 1.0).")
    return p

  def _Rule(self, w, g, slots, lr, consts):
    p = self.p
    ms = p.decay * slots["ms"] + (1 - p.decay) * torch.square(g)
    mom = p.momentum * slots["mom"] + lr * g * torch.rsqrt(ms + p.epsilon)
    return w - mom.to(w.dtype), {"ms": ms, "mom": mom}


class Adagrad(_Elementwise):

  _SLOTS = {"acc": None}

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("initial_accumulator_value", 0.1, "Initial accumulator.")
    return p

  def _SlotInit(self, name):
    return self.p.initial_accumulator_value

  def _Rule(self, w, g, slots, lr, consts):
    acc = slots["acc"] + torch.square(g)
    return w - (lr * g * torch.rsqrt(acc + 1e-30)).to(w.dtype), {"acc": acc}


class Adam(_Elementwise):
  """Adam (the reference's: epsilon added to sqrt(v), the bias correction
  folded into the rate). The correction sqrt(1 - beta2^t) / (1 - beta1^t)
  is computed once a step on the CPU in float32, t = float32(step) + 1,
  each power a float32 `pow` as XLA's."""

  _SLOTS = {"m": 0.0, "v": 0.0}

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("beta1", 0.9, "First-moment decay.")
    p.Define("beta2", 0.999, "Second-moment decay.")
    p.Define("epsilon", 1e-6, "Stability term (ref default 1e-6).")
    return p

  def _Consts(self, step):
    p = self.p
    t = _F32(step) + 1.0
    corr = (torch.sqrt(1.0 - torch.pow(_F32(p.beta2), t)) /
            (1.0 - torch.pow(_F32(p.beta1), t)))
    return {"correction": corr}

  def _Rule(self, w, g, slots, lr, consts):
    p = self.p
    m = p.beta1 * slots["m"] + (1 - p.beta1) * g
    v = p.beta2 * slots["v"] + (1 - p.beta2) * torch.square(g)
    upd = lr * consts["correction"] * m / (torch.sqrt(v) + p.epsilon)
    return w - upd.to(w.dtype), {"m": m, "v": v}


class AdamW(Adam):
  """Adam with decoupled weight decay: the Adam step minus lr * wd * w,
  w the parameter before the step."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("weight_decay", 0.0, "Decoupled weight decay rate.")
    return p

  def _Rule(self, w, g, slots, lr, consts):
    new_w, new_slots = super()._Rule(w, g, slots, lr, consts)
    wd = self.p.weight_decay
    if wd:
      new_w = new_w - lr * wd * w
    return new_w, new_slots


class Adafactor(BaseOptimizer):
  """Adafactor with factored second moments (reference `Adafactor`).

  Factored second moments for rank>=2 weights (row accumulator over the
  last dim, col accumulator over the second-to-last) when both factored
  dims are at least min_dim_size_to_factor, update RMS clipping, the
  pow-decay schedule and an optional first moment."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("beta1", 0.0, "If >0 keep a first moment (uses more memory).")
    p.Define("decay_adam", 0.99, "Second-moment decay asymptote.")
    p.Define("decay_pow", 0.8, "decay = 1 - (step+1)^-decay_pow if >0.")
    p.Define("epsilon1", 1e-30, "Grad^2 regularizer.")
    p.Define("epsilon2", 1e-3, "RMS-of-param floor for update scale.")
    p.Define("multiply_by_parameter_scale", True,
             "Scale updates by RMS(param) (Adafactor's LR-free mode).")
    p.Define("clipping_threshold", 1.0, "Update RMS clip.")
    p.Define("factored", True, "Use factored second moments for rank>=2.")
    p.Define("min_dim_size_to_factor", 128,
             "Only factor when both factored dims are at least this size.")
    return p

  def _ShouldFactor(self, shape) -> bool:
    p = self.p
    return (p.factored and len(shape) >= 2 and
            shape[-1] >= p.min_dim_size_to_factor and
            shape[-2] >= p.min_dim_size_to_factor)

  def InitState(self, params):
    p = self.p

    def _Slot(leaf):
      shape = tuple(leaf.shape)   # a StackedLeaf's with its layer axis
      dev = Members(leaf)[0].device
      z = lambda s: torch.zeros(s, dtype=torch.float32, device=dev)
      slot = NestedMap()
      if self._ShouldFactor(shape):
        slot.vr = z(shape[:-1])
        slot.vc = z(shape[:-2] + shape[-1:])
      else:
        slot.v = z(shape)
      if p.beta1 > 0:
        slot.m = z(shape)
      return slot

    return NestedMap(slots={k: _Slot(v) for k, v in params.items()})

  def _Decay(self, step) -> torch.Tensor:
    p = self.p
    t = torch.tensor(step, dtype=torch.float32) + 1.0
    if p.decay_pow > 0:
      decay = 1.0 - t ** (-p.decay_pow)
    else:
      decay = torch.tensor(p.decay_adam, dtype=torch.float32)
    return torch.minimum(decay, torch.tensor(p.decay_adam,
                                             dtype=torch.float32))

  @torch.no_grad()
  def Update(self, state, grads, params, lr, step, skipped=None):
    decay = self._Decay(step)
    for key, leaf in params.items():
      self._UpdateLeaf(leaf, grads[key], state.slots[key], lr, decay,
                       skipped)

  def _UpdateLeaf(self, leaf, grad, slot, lr, decay, skipped):
    """One reference leaf: the update RMS and the parameter RMS are taken
    over all its layers, as over the reference's stacked tensor."""
    p = self.p
    ws, gs = Members(leaf), Members(grad)
    stacked = isinstance(leaf, base_layer.StackedLeaf)
    factored = self._ShouldFactor(tuple(leaf.shape))
    dev = ws[0].device
    decay = py_utils.ToDevice(decay, dev)
    lr = py_utils.ToDevice(lr, dev)

    def _Slot(name, i):
      return slot[name][i] if stacked else slot[name]

    us, new_slots = [], []
    for i, (w, g) in enumerate(zip(ws, gs)):
      g32 = g.float()
      gsq = torch.square(g32) + p.epsilon1
      new = {}
      if factored:
        vr = decay * _Slot("vr", i) + (1 - decay) * torch.mean(gsq, dim=-1)
        vc = decay * _Slot("vc", i) + (1 - decay) * torch.mean(gsq, dim=-2)
        new["vr"], new["vc"] = vr, vc
        # u = g / sqrt(vhat); vhat = vr * vc / mean_row(vr)
        row_mean = torch.mean(vr, dim=-1, keepdim=True)
        r = torch.rsqrt(vr / row_mean)[..., None]
        c = torch.rsqrt(vc)[..., None, :]
        u = g32 * r * c
      else:
        v = decay * _Slot("v", i) + (1 - decay) * gsq
        new["v"] = v
        u = g32 * torch.rsqrt(v)
      us.append(u)
      new_slots.append(new)
    numel = sum(u.numel() for u in us)
    if p.clipping_threshold > 0:
      u_rms = torch.sqrt(sum(torch.sum(torch.square(u)) for u in us) / numel
                         + 1e-30)
      clip = torch.clamp(u_rms / p.clipping_threshold, min=1.0)
      us = [u / clip for u in us]
    scale = lr
    if p.multiply_by_parameter_scale:
      param_rms = torch.sqrt(
          sum(torch.sum(torch.square(w.float())) for w in ws) / numel)
      scale = lr * torch.clamp(param_rms, min=p.epsilon2)
    for i, (w, u, new) in enumerate(zip(ws, us, new_slots)):
      if p.beta1 > 0:
        m = p.beta1 * _Slot("m", i) + (1 - p.beta1) * u
        new["m"] = m
        u = m
      for name, value in new.items():
        _Write(_Slot(name, i), value, skipped)
      _Write(w, w - (scale * u).to(w.dtype), skipped)


class Accumulator(BaseOptimizer):
  """Gradient accumulation (reference Accumulator): the gradients are
  summed over accum_steps micro-steps, and on the last one the inner
  optimizer applies their mean (a product with the float32 reciprocal of
  accum_steps, as in the reference's jitted step) and the sum restarts.
  On the other micro-steps the parameters and the inner state keep their
  values."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("optimizer_tpl", Adam.Params(), "Inner optimizer.")
    p.Define("accum_steps", 1, "Number of micro-steps per real update.")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    self.CreateChild("opt", self.p.optimizer_tpl)

  def InitState(self, params):
    dev = next(iter(params.values()))
    dev = Members(dev)[0].device
    return NestedMap(
        inner=self.opt.InitState(params),
        accum={k: torch.zeros(tuple(leaf.shape), dtype=torch.float32,
                              device=Members(leaf)[0].device)
               for k, leaf in params.items()},
        count=torch.zeros((), dtype=torch.int32, device=dev))

  @torch.no_grad()
  def Update(self, state, grads, params, lr, step, skipped=None):
    p = self.p
    count = state.count + 1
    do_apply = count >= p.accum_steps
    inv = jit_arith.Reciprocal(p.accum_steps)
    accums, means = {}, {}
    for key, leaf in params.items():
      stacked = isinstance(leaf, base_layer.StackedLeaf)
      acc_l, mean_l = [], []
      for i, g in enumerate(Members(grads[key])):
        a = (state.accum[key][i] if stacked else state.accum[key]) + g
        acc_l.append(a)
        mean_l.append(a * inv)
      accums[key] = acc_l
      means[key] = (base_layer.StackedLeaf(tuple(mean_l)) if stacked
                    else mean_l[0])
    hold = ~do_apply if skipped is None else (skipped | ~do_apply)
    self.opt.Update(state.inner, means, params, lr, step, skipped=hold)
    for key, leaf in params.items():
      stacked = isinstance(leaf, base_layer.StackedLeaf)
      for i, a in enumerate(accums[key]):
        dst = state.accum[key][i] if stacked else state.accum[key]
        _Write(dst, torch.where(do_apply, torch.zeros_like(a), a), skipped)
    _Write(state.count, torch.where(do_apply, torch.zeros_like(count), count),
           skipped)


class CompositeOptimizer(BaseOptimizer):
  """Routes each parameter to a sub-optimizer by regex (reference
  CompositeOptimizer): optimizer_map is [(regex, optimizer Params, lr
  multiplier)], the first `re.match` of a theta path wins. As in the
  reference, every sub-optimizer keeps state for the whole tree and is
  run over all of it, the gradients of the parameters routed elsewhere
  zeroed, and only its own parameters take its result (the others run
  it on copies that are dropped): so the slots of unrouted parameters
  evolve as the reference's do."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("optimizer_map", [],
             "List of (regex, optimizer Params, lr multiplier). First match "
             "wins; a '.*' default entry is required.")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    self.CreateChildren("subs", [tpl for _, tpl, _ in self.p.optimizer_map])

  def _RouteIndex(self, path: str) -> int:
    for i, (regex, _, _) in enumerate(self.p.optimizer_map):
      if re.match(regex, path):
        return i
    raise ValueError(f"No optimizer_map entry matches {path!r}")

  def InitState(self, params):
    for k in params:
      self._RouteIndex(k)
    return NestedMap(subs=[opt.InitState(params) for opt in self.subs])

  @torch.no_grad()
  def Update(self, state, grads, params, lr, step, skipped=None):
    routes = {k: self._RouteIndex(k) for k in params}

    def _Zeros(leaf):
      if isinstance(leaf, base_layer.StackedLeaf):
        return base_layer.StackedLeaf(
            tuple(torch.zeros_like(x) for x in leaf.layers))
      return torch.zeros_like(leaf)

    for i, opt in enumerate(self.subs):
      mult = self.p.optimizer_map[i][2]
      mine = {k: routes[k] == i for k in params}
      masked = {k: grads[k] if mine[k] else _Zeros(grads[k]) for k in params}
      view = {k: params[k] if mine[k] else _CopyLeaf(params[k])
            for k in params}
      opt.Update(state.subs[i], masked, view, lr * mult, step,
                 skipped=skipped)


class DistributedShampoo(BaseOptimizer):
  """Shampoo with Kronecker-factored preconditioners (reference
  `DistributedShampoo`).

  A leaf of the reference's shape [m, n], both dims at most block_size,
  keeps its statistics L += G G^T, R += G^T G (`stat_l`, `stat_r`,
  decayed by beta2) and their inverse quarter roots (`root_l`,
  `root_r`), and steps along root_l G root_r scaled to the norm of the
  diagonal AdaGrad step. A repeat stack's stacked vectors ([L, n]) are
  such a matrix, as in the reference. Any other leaf, a repeat stack's
  3-D stacked weights and a [D, N, H] attention weight included, takes
  that diagonal AdaGrad step (`accum`) itself; its four matrix slots are
  0-d placeholders, as the reference's.

  The roots are recomputed from the updated statistics on steps where
  step % statistics_compute_steps == 0 (the reference's `lax.cond`; the
  port's step is a host int, so this is a host branch, and `eigh` runs
  on refresh steps only). The inverse root is `torch.linalg.eigh` in
  float32, as the reference's `jnp.linalg.eigh` runs outside any kernel.
  A skipped step keeps the old statistics, roots and accumulators."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("block_size", 1024, "Max dim preconditioned (bigger: diag).")
    p.Define("statistics_compute_steps", 10,
             "Refresh the inverse roots every N steps.")
    p.Define("epsilon", 1e-6, "Damping added to the factor diagonals.")
    p.Define("beta2", 1.0, "Statistics decay (1.0 = accumulate, ref).")
    p.Define("graft_epsilon", 1e-8, "AdaGrad graft stability.")
    return p

  def _Preconditioned(self, leaf) -> bool:
    shape = tuple(leaf.shape)
    return (len(shape) == 2 and shape[0] <= self.p.block_size
            and shape[1] <= self.p.block_size)

  def InitState(self, params):
    state = NestedMap(stat_l={}, stat_r={}, root_l={}, root_r={}, accum={})
    for k, leaf in params.items():
      dev = Members(leaf)[0].device
      shape = tuple(leaf.shape)
      for side, n in (("l", shape[0]), ("r", shape[-1])):
        if self._Preconditioned(leaf):
          state[f"stat_{side}"][k] = torch.zeros(
              (n, n), dtype=torch.float32, device=dev)
          state[f"root_{side}"][k] = torch.eye(n, dtype=torch.float32,
                                               device=dev)
        else:
          state[f"stat_{side}"][k] = torch.zeros((), dtype=torch.float32,
                                                 device=dev)
          state[f"root_{side}"][k] = torch.zeros((), dtype=torch.float32,
                                                 device=dev)
      state.accum[k] = torch.zeros(shape, dtype=torch.float32, device=dev)
    return state

  def InverseQuarterRoot(self, stat: torch.Tensor) -> torch.Tensor:
    """(stat + epsilon I)^(-1/4) by eigh, eigenvalues floored at epsilon."""
    eps = self.p.epsilon
    n = stat.shape[0]
    damped = stat + eps * torch.eye(n, dtype=stat.dtype, device=stat.device)
    evals, evecs = torch.linalg.eigh(damped)
    inv_root = torch.pow(torch.clamp(evals, min=eps), -0.25)
    return (evecs * inv_root[None, :]) @ evecs.T

  @torch.no_grad()
  def Update(self, state, grads, params, lr, step, skipped=None):
    p = self.p
    refresh = int(step) % p.statistics_compute_steps == 0
    for key, leaf in params.items():
      stacked = isinstance(leaf, base_layer.StackedLeaf)
      lr_d = py_utils.ToDevice(lr, Members(leaf)[0].device)
      if not self._Preconditioned(leaf):
        for i, (w, g) in enumerate(zip(Members(leaf), Members(grads[key]))):
          acc = _Slice(state.accum[key], stacked, i)
          new_acc = acc + torch.square(g.to(acc.dtype))
          adagrad_dir = g.float() / (torch.sqrt(new_acc) + p.graft_epsilon)
          _Write(acc, new_acc, skipped)
          _Write(w, w - (lr_d * adagrad_dir).to(w.dtype), skipped)
        continue
      # one matrix: a 2-D weight, or a repeat stack's stacked vectors
      if stacked:
        w = torch.stack(leaf.layers)
        g32 = torch.stack(grads[key].layers).float()
      else:
        w, g32 = leaf, grads[key].float()
      acc = state.accum[key]
      new_acc = acc + torch.square(g32.to(acc.dtype))
      adagrad_dir = g32 / (torch.sqrt(new_acc) + p.graft_epsilon)
      sl, sr = state.stat_l[key], state.stat_r[key]
      rl, rr = state.root_l[key], state.root_r[key]
      new_sl = p.beta2 * sl + g32 @ g32.T
      new_sr = p.beta2 * sr + g32.T @ g32
      if refresh:
        new_rl = self.InverseQuarterRoot(new_sl)
        new_rr = self.InverseQuarterRoot(new_sr)
      else:
        new_rl, new_rr = rl, rr
      precond = new_rl @ g32 @ new_rr
      # graft: the Shampoo direction with the AdaGrad step's norm
      pn = torch.clamp(torch.linalg.norm(precond), min=1e-16)
      an = torch.linalg.norm(adagrad_dir)
      new_w = w - (lr_d * (precond * (an / pn))).to(w.dtype)
      for dst, new in ((acc, new_acc), (sl, new_sl), (sr, new_sr)):
        _Write(dst, new, skipped)
      if refresh:
        _Write(rl, new_rl, skipped)
        _Write(rr, new_rr, skipped)
      for i, member in enumerate(Members(leaf)):
        _Write(member, new_w[i] if stacked else new_w, skipped)


class EGDD(BaseOptimizer):
  """Exponentiated Gradient Delta-Delta (reference `EGDD`): momentum with
  a per-weight gain and a per-tensor lr scale, both updated by
  unnormalized exponentiated gradient.

    scale    <- clip(scale * exp(scale_lr * <g/|g|, m/|m|>))
    gain     <- clip(gain * exp(gain_lr * sign(g) sign(gbar)))
    m        <- mu m + lr gain g;  gbar <- beta gbar + (1 - beta) g
    w        <- w - scale m

  The scale (`lr_scale`, a 0-d slot per leaf) and the norms and inner
  product it reads are taken over a repeat stack's whole stacked leaf.
  Every slot is float32."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("momentum", 0.9, "Momentum coefficient (mu).")
    p.Define("beta", 0.9, "Decay of the gradient EMA (gbar).")
    p.Define("gain_learning_rate", 0.01, "EG step on per-weight gains.")
    p.Define("scale_learning_rate", 0.001, "EG step on per-tensor lr scale.")
    p.Define("initial_gain", 1.0, "Initial per-weight gain.")
    p.Define("min_gain", 1e-2, "Gain lower clip.")
    p.Define("max_gain", 1e2, "Gain upper clip.")
    p.Define("initial_scale", 1.0, "Initial lr scale.")
    p.Define("min_scale", 1e-1, "lr scale lower clip.")
    p.Define("max_scale", 1e1, "lr scale upper clip.")
    p.Define("use_directions", True,
             "lr-scale update from normalized grad/momentum directions.")
    p.Define("use_signs", True,
             "Gain update from sign(grad)*sign(gbar) instead of magnitudes.")
    return p

  def InitState(self, params):
    p = self.p
    state = NestedMap(m={}, gbar={}, gain={}, lr_scale={})
    for k, leaf in params.items():
      dev = Members(leaf)[0].device
      shape = tuple(leaf.shape)
      state.m[k] = torch.zeros(shape, dtype=torch.float32, device=dev)
      state.gbar[k] = torch.zeros(shape, dtype=torch.float32, device=dev)
      state.gain[k] = torch.full(shape, float(p.initial_gain),
                                 dtype=torch.float32, device=dev)
      state.lr_scale[k] = torch.full((), float(p.initial_scale),
                                     dtype=torch.float32, device=dev)
    return state

  @torch.no_grad()
  def Update(self, state, grads, params, lr, step, skipped=None):
    p = self.p
    t = torch.clamp(_F32(step), min=1.0)
    # the bias correction of gbar, a float32 power as the jitted reference
    corr = 1.0 - torch.pow(_F32(p.beta), torch.clamp(t - 1.0, min=1.0))
    for key, leaf in params.items():
      stacked = isinstance(leaf, base_layer.StackedLeaf)
      dev = Members(leaf)[0].device
      lr_d = py_utils.ToDevice(lr, dev)
      gs = [g.float() for g in Members(grads[key])]
      ms = [_Slice(state.m[key], stacked, i) for i in range(len(gs))]
      if p.use_directions:
        gnorm = torch.sqrt(_SumSquares(gs)) + 1e-10
        mnorm = torch.sqrt(_SumSquares(ms)) + 1e-10
        inner = sum(torch.sum((g / gnorm) * (m / mnorm))
                    for g, m in zip(gs, ms))
      else:
        inner = sum(torch.sum(g * m) for g, m in zip(gs, ms))
      scale = state.lr_scale[key]
      new_scale = torch.clamp(
          scale * torch.exp(p.scale_learning_rate * inner), p.min_scale,
          p.max_scale)
      for i, (w, g, m) in enumerate(zip(Members(leaf), gs, ms)):
        gbar = _Slice(state.gbar[key], stacked, i)
        gain = _Slice(state.gain[key], stacked, i)
        if p.use_signs:
          gain_grad = torch.sign(g) * torch.sign(gbar)
        else:
          gain_grad = g * (gbar / py_utils.ToDevice(corr, dev))
        new_gain = torch.clamp(
            gain * torch.exp(p.gain_learning_rate * gain_grad), p.min_gain,
            p.max_gain)
        new_m = p.momentum * m + lr_d * new_gain * g
        new_gbar = p.beta * gbar + (1.0 - p.beta) * g
        _Write(w, w - (new_scale * new_m).to(w.dtype), skipped)
        _Write(m, new_m, skipped)
        _Write(gbar, new_gbar, skipped)
        _Write(gain, new_gain, skipped)
      _Write(scale, new_scale, skipped)


class AdaGraft(BaseOptimizer):
  """Grafts one optimizer's step magnitude onto another's direction
  (reference `AdaGraft`): both children step from copies of the
  parameters, and each leaf moves by |dM| * dD / |dD|, the norms over a
  repeat stack's whole stacked leaf. The children never write the
  caller's tensors; their slots (`mag`, `dir`) follow their own rules,
  the skip flag included."""

  @classmethod
  def Params(cls):
    p = super().Params()
    p.Define("magnitude_optimizer", None, "Optimizer supplying step size.")
    p.Define("direction_optimizer", None, "Optimizer supplying direction.")
    return p

  def __init__(self, params, device=None):
    super().__init__(params, device)
    p = self.p
    assert p.magnitude_optimizer is not None
    assert p.direction_optimizer is not None
    self.CreateChild("mag", p.magnitude_optimizer)
    self.CreateChild("dir", p.direction_optimizer)

  def InitState(self, params):
    return NestedMap(mag=self.mag.InitState(params),
                     dir=self.dir.InitState(params))

  @torch.no_grad()
  def Update(self, state, grads, params, lr, step, skipped=None):
    mag = {k: _CopyLeaf(v) for k, v in params.items()}
    self.mag.Update(state.mag, grads, mag, lr, step, skipped=skipped)
    drc = {k: _CopyLeaf(v) for k, v in params.items()}
    self.dir.Update(state.dir, grads, drc, lr, step, skipped=skipped)
    for key, leaf in params.items():
      ws = Members(leaf)
      dms = [(m - w).float() for m, w in zip(Members(mag[key]), ws)]
      dds = [(d - w).float() for d, w in zip(Members(drc[key]), ws)]
      dd_norm = torch.clamp(torch.sqrt(_SumSquares(dds)), min=1e-16)
      step_len = torch.sqrt(_SumSquares(dms))
      for w, dd in zip(ws, dds):
        _Write(w, w + (step_len * dd / dd_norm).to(w.dtype), skipped)
