"""Helpers shared by the CPU parity tests of the port's training surface:
a tiny TransformerLm built on both sides from one recipe, with the
reference's weights copied into the port, packed batches, and the
reference's train state read as numpy."""

import types

import numpy as np

import jax
import jax.numpy as jnp
import torch

from lingvo_tpu.core import attention as jax_attention
from lingvo_tpu.core import learner as jax_learner
from lingvo_tpu.core import optimizer as jax_optimizer
from lingvo_tpu.core import schedule as jax_schedule
from lingvo_tpu.core.nested_map import NestedMap as JaxNestedMap
from lingvo_tpu.models.lm import layers as jax_lm_layers
from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import attention
from lingvo_tpu_torch.core import learner
from lingvo_tpu_torch.core import optimizer
from lingvo_tpu_torch.core import schedule
from lingvo_tpu_torch.core.nested_map import NestedMap
from lingvo_tpu_torch.models.lm import layers as lm_layers

# the modules a recipe builds from, one namespace per package
JAX = types.SimpleNamespace(learner=jax_learner, optimizer=jax_optimizer,
              schedule=jax_schedule, lm=jax_lm_layers,
              attention=jax_attention)
PORT = types.SimpleNamespace(learner=learner, optimizer=optimizer,
                             schedule=schedule, lm=lm_layers,
                             attention=attention)
B, T, V = 2, 32, 64


def TinyLm(pkg, name="lm", num_layers=2, **kw):
  """A 2-layer rotary TransformerLm of width 32 (vocab 64) in `pkg`."""
  p = pkg.lm.TransformerLm.Params().Set(
    name=name, vocab_size=V, model_dim=32, num_layers=num_layers,
    num_heads=2, hidden_dim=64, use_rotary=True)
  return p.Set(**kw)


def Instantiate(jax_p, port_p, seed=0, perturb=True):
  """(reference task, its theta as numpy, port task with that theta).
  The zero-initialized leaves (norm scales, biases) are perturbed so
  that they matter."""
  task = jax_p.Instantiate()
  task.FinalizePaths()
  theta = task.InstantiateVariables(jax.random.PRNGKey(seed))
  theta = jax.tree_util.tree_map(np.asarray, theta)
  if perturb:
    rng = np.random.RandomState(seed + 100)
    theta = jax.tree_util.tree_map(
      lambda x: x + 0.1 * rng.randn(*x.shape).astype(np.float32),
      theta)
  port = port_p.Instantiate(device="cpu")
  convert.LoadJaxTheta(port, theta)
  port.FinalizePaths()
  return task, theta, port


def Batch(seed=0, b=B, t=T):
  """Packed rows with a mid-row segment split and trailing padding."""
  rng = np.random.RandomState(seed)
  seg = np.zeros((b, t), np.int32)
  seg[:, : t // 3] = 1
  seg[:, t // 3: t - 5] = 2
  seg[-1, t - 5:] = 3
  return NestedMap(
    ids=rng.randint(1, V, (b, t)).astype(np.int32),
    labels=rng.randint(1, V, (b, t)).astype(np.int32),
    paddings=(seg == 0).astype(np.float32), segment_ids=seg)


def ToJax(batch):
  return JaxNestedMap({k: jnp.asarray(v) for k, v in batch.items()})


def ToTorch(batch):
  return batch.Transform(torch.as_tensor)


def Numpy(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def CheckTheta(port, jtheta, atol, rtol, only=None):
  """Every theta leaf of the port against the reference's (a theta
  NestedMap); `only`: a predicate on the path."""
  want = dict(jtheta.FlattenItems())
  for k, v in convert.ThetaToNumpy(port).FlattenItems():
    if only is None or only(k):
      np.testing.assert_allclose(v, np.asarray(want[k]), atol=atol,
                                       rtol=rtol, err_msg=k)


def JaxTree(tree):
  """A (port) nested dict of arrays as the reference's NestedMap of jnp
  arrays; lists stay lists."""
  if isinstance(tree, dict):
    return JaxNestedMap({k: JaxTree(v) for k, v in tree.items()})
  if isinstance(tree, (list, tuple)):
    return [JaxTree(v) for v in tree]
  return jnp.asarray(tree)
