"""Step-seeded dropout against the JAX reference on the CPU.

- `threefry.Uniform01` and `Bernoulli` equal `jax.random.uniform` and
  `jax.random.bernoulli` bit for bit (partitionable threefry), and
  `py_utils.StepSeed` under nested salts and an extra fold gives the
  reference's keys.
- `DeterministicDropoutLayer` against `jax.jit` of the reference's, bit
  for bit in float32 and bfloat16 (the division by keep_prob is a product
  with the float32 reciprocal of keep_prob in the inputs' dtype: the
  eager reference's true division is a control that differs in float32,
  and 1/0.9 in place of 1/bf16(0.9) = 1/0.8984375 one that differs in
  bfloat16); eval mode and a missing seed give the identity.
- Every dropout mask of a TransformerLm forward (residual dropout on both
  sublayers, attention dropout; the repeat stack and the unrolled one;
  float32 and bfloat16), recorded on both sides by its key: the same
  keys, and each mask bit for bit.
- remat 'full' under residual dropout 0.5: the gradients of a two-layer
  repeat stack, the backward run after the step seed's context is left
  (as `TrainStep` runs it), against `jax.grad` of the reference within
  atol 2e-5, rtol 1e-4, and against the port's remat 'none' within 1e-6.
- Three `TrainStep`s with dropout (the 1B-words learner: Adam with beta2
  0.98, clip 1.0) against the reference's jitted `TrainStep` with the
  program's base key, and one with L2 and L1 weights (the regularization
  loss added to the differentiated loss).
- On the card (`cuda`): the masks and the dropout layer's output equal
  the CPU's bit for bit.
"""

import types

import numpy as np
import pytest
import torch

from lingvo_tpu_torch import convert
from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import layers
from lingvo_tpu_torch.core import learner
from lingvo_tpu_torch.core import optimizer
from lingvo_tpu_torch.core import py_utils
from lingvo_tpu_torch.core import threefry
from lingvo_tpu_torch.core.nested_map import NestedMap
from lingvo_tpu_torch.models.lm import layers as lm_layers

B, T = 2, 16


def _Jax():
  """The reference's modules, imported here only (the `cuda` cases run
  where JAX is not installed)."""
  import jax
  import jax.numpy as jnp
  from lingvo_tpu.core import layers as jax_layers
  from lingvo_tpu.core import learner as jax_learner
  from lingvo_tpu.core import optimizer as jax_optimizer
  from lingvo_tpu.core import py_utils as jax_py_utils
  from lingvo_tpu.core.nested_map import NestedMap as JaxNestedMap
  from lingvo_tpu.models.lm import layers as jax_lm
  return types.SimpleNamespace(jax=jax, jnp=jnp, layers=jax_layers,
                               learner=jax_learner, optimizer=jax_optimizer,
                               py_utils=jax_py_utils, NestedMap=JaxNestedMap,
                               lm=jax_lm)


def test_uniform_and_bernoulli_bits_match_jax():
  j = _Jax()
  for seed, shape in ((0, (7,)), (1234, (3, 5, 33)), (2**40 + 7, (4097,))):
    key = j.jax.random.PRNGKey(seed)
    tkey = torch.as_tensor(np.asarray(key).astype(np.int64))
    want = np.asarray(j.jax.random.uniform(key, shape))
    got = threefry.Uniform01(tkey, shape).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert want.min() >= 0.0 and want.max() < 1.0
    for p in (0.9, 0.5, 0.1):
      np.testing.assert_array_equal(
          threefry.Bernoulli(tkey, p, shape).numpy(),
          np.asarray(j.jax.random.bernoulli(key, p, shape)))
    # a single CPU key enters as Python ints, a batch of keys as tensors:
    # the same bits
    np.testing.assert_array_equal(
        threefry.Uniform01(tkey[None], shape, "cpu")[0].numpy(), want)


def test_step_seed_matches_reference():
  j = _Jax()
  key = j.jax.random.fold_in(j.jax.random.PRNGKey(1234), 17)
  tkey = threefry.FoldIn(threefry.PRNGKey(1234), 17)
  np.testing.assert_array_equal(tkey.numpy(), np.asarray(key))
  names = ["lm/stack/body/fflayer/dropout/res", "lm/emb/sampled_softmax", ""]
  for name in names:
    for salts, extra in (((), None), ((3,), None), ((2, 5), 9)):
      with j.py_utils.StepSeedContext(key):
        stack = [j.py_utils.StepSeedSalt(j.jnp.int32(s)) for s in salts]
        for c in stack:
          c.__enter__()
        want = np.asarray(j.py_utils.StepSeed(name, extra))
        for c in reversed(stack):
          c.__exit__(None, None, None)
      with py_utils.StepSeedContext(tkey):
        stack = [py_utils.StepSeedSalt(s) for s in salts]
        for c in stack:
          c.__enter__()
        got = py_utils.StepSeed(name, extra).numpy()
        state = py_utils.CurrentSeedState()
        for c in reversed(stack):
          c.__exit__(None, None, None)
      np.testing.assert_array_equal(got, want)
      # a snapshot replays the same key outside the contexts
      assert not py_utils.HasStepSeed()
      np.testing.assert_array_equal(
          py_utils.InSeedState(state, py_utils.StepSeed, name, extra).numpy(),
          want)
  with pytest.raises(RuntimeError, match="StepSeedContext"):
    py_utils.StepSeed("x")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_layer_matches_jitted_reference(dtype):
  j = _Jax()
  jdt = getattr(j.jnp, dtype)
  tdt = getattr(torch, dtype)
  rng = np.random.RandomState(0)
  x = rng.randn(4, 33, 64).astype(np.float32)
  ref = j.layers.DeterministicDropoutLayer.Params().Set(
      name="drop").Instantiate()
  ref.FinalizePaths("lm/drop")
  port = layers.DeterministicDropoutLayer.Params().Set(
      name="drop").Instantiate(device="cpu")
  port.FinalizePaths("lm/drop")
  key = j.jax.random.PRNGKey(5)
  tkey = torch.as_tensor(np.asarray(key).astype(np.int64))

  def Ref(x):
    with j.py_utils.StepSeedContext(key):
      return ref.FProp(j.NestedMap(), x, keep_prob=0.9, name_suffix="res")

  xj = j.jnp.asarray(x).astype(jdt)
  want = np.asarray(j.jax.jit(Ref)(xj).astype(j.jnp.float32))
  eager = np.asarray(Ref(xj).astype(j.jnp.float32))
  xt = torch.tensor(x).to(tdt)
  with py_utils.StepSeedContext(tkey):
    out = port.FProp(xt, keep_prob=0.9, name_suffix="res")
  assert out.dtype == tdt
  got = out.float().numpy()
  np.testing.assert_array_equal(got, want)
  keep = got != 0
  assert 0.85 < keep.mean() < 0.95
  if dtype == "float32":
    assert (eager != want).any()   # the eager division rounds elsewhere
  else:
    wrong = (xt * (1 / 0.9)).float().numpy()   # 1/0.9, not 1/bf16(0.9)
    assert (wrong[keep] != want[keep]).any()
  # eval mode, no seed, keep_prob 1: the identity
  with py_utils.StepSeedContext(tkey), py_utils.EvalContext():
    assert port.FProp(xt, keep_prob=0.9) is xt
  assert port.FProp(xt, keep_prob=0.9) is xt
  with py_utils.StepSeedContext(tkey):
    assert port.FProp(xt, keep_prob=1.0) is xt


# -- the stacks ------------------------------------------------------------------


def _LmParams(lib, repeat, fprop_dtype=None, remat="full", **drop):
  p = lib.TransformerLm.Params().Set(
      name="lm", vocab_size=64, model_dim=32, num_layers=2, num_heads=2,
      hidden_dim=64, use_rotary=True, use_repeat_layer=repeat,
      remat_policy=remat, **drop)
  if fprop_dtype is not None:
    p.fprop_dtype = fprop_dtype
  return p


def _Pair(repeat, dtype="float32", remat="full", seed=0, learner_kw=None,
          **drop):
  """(reference task, reference theta (numpy), port task), the port with
  the reference's weights and paths; drop: the dropout probabilities."""
  j = _Jax()
  jp = _LmParams(j.lm, repeat, None if dtype == "float32" else
                 getattr(j.jnp, dtype), remat, **drop)
  tp = _LmParams(lm_layers, repeat, None if dtype == "float32" else
                 getattr(torch, dtype), remat, **drop)
  lk = dict(learning_rate=1e-3, clip_gradient_norm_to_value=1.0)
  lk.update(learner_kw or {})
  jp.train.learner = j.learner.Learner.Params().Set(
      optimizer=j.optimizer.Adam.Params().Set(beta2=0.98), **lk)
  tp.train.learner = learner.Learner.Params().Set(
      optimizer=optimizer.Adam.Params().Set(beta2=0.98), **lk)
  task = jp.Instantiate()
  task.FinalizePaths()
  theta = task.InstantiateVariables(j.jax.random.PRNGKey(seed))
  rng = np.random.RandomState(seed + 100)
  theta = j.jax.tree_util.tree_map(
      lambda x: np.asarray(x) + 0.1 * rng.randn(*x.shape).astype(np.float32),
      theta)
  port = tp.Instantiate(device="cpu")
  port.FinalizePaths()
  convert.LoadJaxTheta(port, theta)
  return task, theta, port


def _Batch(seed=0, vocab=64):
  rng = np.random.RandomState(seed)
  seg = np.ones((B, T), np.int32)
  seg[0, 9:] = 2
  seg[1, 13:] = 0
  return NestedMap(
      ids=rng.randint(1, vocab, (B, T)).astype(np.int32),
      labels=rng.randint(1, vocab, (B, T)).astype(np.int32),
      paddings=(seg == 0).astype(np.float32), segment_ids=seg)


def _ToJax(batch):
  j = _Jax()
  return j.NestedMap({k: j.jnp.asarray(v) for k, v in batch.items()})


def _ToTorch(batch):
  return batch.Transform(torch.as_tensor)


def _RecordPortMasks(monkeypatch):
  got = {}
  orig = threefry.Bernoulli

  def Recording(key, p, shape, device=None):
    mask = orig(key, p, shape, device)
    got[tuple(int(v) for v in key.cpu())] = (p, mask.cpu().numpy())
    return mask

  monkeypatch.setattr(threefry, "Bernoulli", Recording)
  return got


def _RecordReferenceMasks(monkeypatch):
  j = _Jax()
  got = {}
  orig = j.jax.random.bernoulli

  def Record(key, mask):
    got[tuple(int(v) for v in np.asarray(key))] = np.asarray(mask)

  def Recording(key, p=0.5, shape=None):
    mask = orig(key, p, shape)
    j.jax.debug.callback(Record, key, mask)
    return mask

  monkeypatch.setattr(j.jax.random, "bernoulli", Recording)
  return got


@pytest.mark.parametrize("repeat", [True, False], ids=["repeat", "unrolled"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_dropout_masks_match_reference(monkeypatch, repeat, dtype):
  j = _Jax()
  task, theta, port = _Pair(repeat, dtype, residual_dropout_prob=0.3,
                            atten_dropout_prob=0.2)
  batch = _Batch()
  key = j.jax.random.fold_in(j.jax.random.PRNGKey(1234), 3)
  want = _RecordReferenceMasks(monkeypatch)

  def Ref(th, b):
    with j.py_utils.StepSeedContext(key):
      return task.FProp(th, b)[0].loss[0]

  j.jax.block_until_ready(j.jax.jit(Ref)(
      j.jax.tree_util.tree_map(j.jnp.asarray, theta), _ToJax(batch)))
  got = _RecordPortMasks(monkeypatch)
  with torch.no_grad(), py_utils.StepSeedContext(
      torch.as_tensor(np.asarray(key).astype(np.int64))):
    port.FProp(_ToTorch(batch))
  # 2 layers x (attention probs, attention residual, FFN residual)
  assert len(want) == 6
  assert sorted(got) == sorted(want)
  for k, (p, mask) in got.items():
    np.testing.assert_array_equal(mask, want[k])
    assert 0 < mask.mean() < 1


def _Grads(port):
  out = {}
  for k, leaf in port.ThetaTree().FlattenItems():
    g = [m.grad.numpy() for m in optimizer.Members(leaf)]
    out[k] = np.stack(g) if isinstance(leaf, base_layer.StackedLeaf) else g[0]
  return out


def _PortGradsOutsideContext(port, batch, tkey):
  """The forward under the step seed, backward() after leaving it, as
  `BaseTask.TrainStep` runs them."""
  for prm in port.parameters():
    prm.grad = None
  with py_utils.StepSeedContext(tkey):
    metrics, _ = port.FProp(_ToTorch(batch))
  metrics.loss[0].backward()
  return _Grads(port), float(metrics.loss[0].detach())


def test_remat_dropout_grads_match_reference_and_remat_none():
  j = _Jax()
  batch = _Batch(1)
  key = j.jax.random.fold_in(j.jax.random.PRNGKey(1234), 0)
  tkey = torch.as_tensor(np.asarray(key).astype(np.int64))
  task, theta, port = _Pair(True, remat="full", residual_dropout_prob=0.5)

  def Loss(th):
    with j.py_utils.StepSeedContext(key):
      return task.FProp(th, _ToJax(batch))[0].loss[0]

  jloss, jgrads = j.jax.jit(j.jax.value_and_grad(Loss))(
      j.jax.tree_util.tree_map(j.jnp.asarray, theta))
  grads, loss = _PortGradsOutsideContext(port, batch, tkey)
  np.testing.assert_allclose(loss, float(jloss), atol=1e-5)
  jflat = dict(jgrads.FlattenItems())
  assert sorted(grads) == sorted(jflat)
  for k, g in grads.items():
    np.testing.assert_allclose(g, np.asarray(jflat[k]), atol=2e-5, rtol=1e-4,
                               err_msg=k)
  _, _, plain = _Pair(True, remat="none", residual_dropout_prob=0.5)
  grads_none, _ = _PortGradsOutsideContext(plain, batch, tkey)
  for k, g in grads.items():
    np.testing.assert_allclose(g, grads_none[k], atol=1e-6, rtol=0,
                               err_msg=k)
  # the dropout is live: without it the gradients differ
  _, _, off = _Pair(True, remat="full")
  grads_off, _ = _PortGradsOutsideContext(off, batch, tkey)
  assert max(float(np.abs(grads_off[k] - g).max())
             for k, g in grads.items()) > 1e-3


@pytest.mark.parametrize("case", ["dropout", "l2_l1"])
def test_train_steps_match_reference(case):
  j = _Jax()
  if case == "dropout":
    kw = dict(residual_dropout_prob=0.1, atten_dropout_prob=0.1)
    learner_kw = None
  else:
    kw = dict(residual_dropout_prob=0.1)
    learner_kw = dict(l2_regularizer_weight=1e-2, l1_regularizer_weight=1e-3)
  task, theta, port = _Pair(True, seed=2, learner_kw=learner_kw, **kw)
  jstate = task.CreateTrainState(j.jax.random.PRNGKey(0))
  jstate.theta = j.jax.tree_util.tree_map(j.jnp.asarray, theta)
  jstate.opt_states = [task.learners[0].InitState(jstate.theta)]
  base = j.jax.random.PRNGKey(1234)
  step_fn = j.jax.jit(lambda s, b: task.TrainStep(s, b, base))
  tstate = port.CreateTrainState()
  for i in range(3):
    batch = _Batch(seed=10 + i)
    jstate, jout = step_fn(jstate, _ToJax(batch))
    tout = port.TrainStep(tstate, _ToTorch(batch), threefry.PRNGKey(1234))
    for k in ("loss", "fraction_of_correct_next_step_preds"):
      np.testing.assert_allclose(float(tout.metrics[k][0]),
                                 float(jout.metrics[k][0]), atol=1e-5)
    for k in ("grad_norm", "learning_rate", "skipped_step"):
      np.testing.assert_allclose(float(tout.stats[k]), float(jout.stats[k]),
                                 atol=1e-5, rtol=1e-5)
  jflat = dict(jstate.theta.FlattenItems())
  for k, v in convert.ThetaToNumpy(port).FlattenItems():
    np.testing.assert_allclose(v, np.asarray(jflat[k]), atol=2e-5, rtol=1e-4,
                               err_msg=k)
  for name, t, a in convert.OptStatePairs(
      tstate.opt_states[0],
      j.jax.tree_util.tree_map(np.asarray, jstate.opt_states[0])):
    np.testing.assert_allclose(t.numpy(), a, atol=2e-6, rtol=1e-3,
                               err_msg=name)


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: compares the card's masks with the "
                "CPU's")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masks_on_card_match_cpu(cuda, dtype):
  rng = np.random.RandomState(1)
  x = torch.as_tensor(rng.randn(32, 512, 64).astype(np.float32)).to(dtype)
  key = threefry.FoldIn(threefry.PRNGKey(1234), 7)
  shape = (32, 512, 64)
  want = threefry.Bernoulli(key, 0.9, shape).numpy()
  np.testing.assert_array_equal(
      threefry.Bernoulli(key.cuda(), 0.9, shape).cpu().numpy(), want)
  np.testing.assert_array_equal(
      threefry.Bernoulli(key, 0.9, shape, "cuda").cpu().numpy(), want)
  outs = []
  for dev in ("cpu", "cuda"):
    layer = layers.DeterministicDropoutLayer.Params().Set(
        name="drop").Instantiate(device=dev)
    layer.FinalizePaths("lm/stack/body/fflayer/dropout")
    with py_utils.StepSeedContext(key), py_utils.StepSeedSalt(3):
      outs.append(layer.FProp(x.to(dev), keep_prob=0.9,
                              name_suffix="res").cpu())
  assert torch.equal(outs[0], outs[1])
