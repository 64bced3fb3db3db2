"""The tiny hybrid LM at fprop_dtype=bfloat16 in lingvo_tpu_torch against the JAX reference run op by op, on the CPU.

The conftest `TinyLmParams(every_n=2)` stack ([ssm, attention], weights
float32, noised theta) on a packed batch of 2 x 16 tokens with a padded
tail, the reference under `jax.disable_jit()`, so that every bfloat16
value rounds where its program rounds it:
- the loss within 1e-5 (the float32 port, the control, at least 1e-4
  off);
- the gradients of the weight matrices within a relative error norm of
  1e-4 (bitwise here), where the control is at least 1e-2 off;
- the leaves the mixer widens to float32 (a_log, b_dt, d_skip,
  norm_scale), whose gradients are float32 sums rounded once to
  bfloat16: every element within one bfloat16 ulp (bitwise here);
- the biases and norm scales, whose cotangents the reference sums over
  tokens in bfloat16 in XLA's order and the port in float32, within 3e-2,
  as tests/test_torch_bf16_train.py holds DenseLm's.
"""

import re

import numpy as np
import torch

import jax

from lingvo_tpu_torch.core.nested_map import NestedMap

from tests.test_torch_hybrid_train import (BF16, VECTOR_LEAF, HybridLms,
                                           JaxLmGrads, PortLmGrads, Rel)

WIDENED = r"\.(a_log|b_dt|d_skip|norm_scale)$"


def _Batch(seed=0, t=16):
  """Row 0: segments of 6 and 7 tokens, then 3 padding tokens; row 1:
  segments of 9 and 7."""
  rng = np.random.RandomState(seed)
  seg = np.zeros((2, t), np.int32)
  seg[0, :6], seg[0, 6:13] = 1, 2
  seg[1, :9], seg[1, 9:] = 1, 2
  return NestedMap(
      ids=rng.randint(1, 64, (2, t)).astype(np.int32),
      labels=rng.randint(1, 64, (2, t)).astype(np.int32),
      paddings=(seg == 0).astype(np.float32), segment_ids=seg)


def test_hybrid_lm_bf16_loss_and_grads_match_reference_op_by_op():
  task, theta, port = HybridLms(BF16)
  _, _, ctl = HybridLms()
  batch = _Batch()
  with jax.disable_jit():
    jm, want = JaxLmGrads(task, theta, batch, jit=False)
  tm, got = PortLmGrads(port, batch)
  cm, ctl_got = PortLmGrads(ctl, batch)
  loss = float(jm.loss[0])
  assert abs(float(tm.loss[0].detach()) - loss) <= 1e-5
  assert abs(float(cm.loss[0].detach()) - loss) >= 1e-4
  assert sorted(got) == sorted(want)
  assert sum(bool(re.search(WIDENED, k)) for k in want) == 4
  for k, w in want.items():
    assert got[k].dtype == np.float32
    if re.search(WIDENED, k):
      assert np.all(np.abs(got[k] - w) <= 2.0 ** -8 * np.abs(w)), k
    elif re.search(VECTOR_LEAF, k):
      assert Rel(got[k], w) <= 3e-2, k
    else:
      assert Rel(got[k], w) <= 1e-4, k
      assert Rel(ctl_got[k], w) >= 1e-2, k
