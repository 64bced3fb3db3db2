"""The sampled-softmax head and the 1B-words configs against the JAX reference on the CPU.

- `SampledSoftmax._LogExpectedCount` against `jax.jit` of the
  reference's, within atol 1e-6 and 95% of the values bitwise (the two
  logarithms are each framework's own: XLA's float32 log is off by up to
  1.1e-7 relative near 1, PyTorch's by 6e-8): the division by log(V + 1)
  is a product with its float32 reciprocal, as XLA compiles it; the same
  formula with a true division (the eager reference's) misses the jitted
  values more often.
- The negative ids of 50 step keys at V 793,470 and 4096 draws against
  the jitted reference's `_SampleNegatives`: above id 2^19 one float32
  ulp of exp is 1/16 or more, so an ulp of difference between XLA's and
  PyTorch's exp moves an id across an integer. The mismatches are
  counted; each is one id away, where the two exps are one ulp apart (and
  no exp more than one); at V 1003 the ids are equal.
- A tiny TransformerLm with the sampled head (V 1003, 64 negatives,
  residual dropout 0.1) under a step seed: the sampled loss and every
  gradient against `jax.value_and_grad` of the reference (atol 2e-5, rtol
  1e-4).
- Its eval (`EvalStep`: the fused xent statistics over the untied table
  and bias, the plain version on the CPU) against the reference's dense
  eval: loss, log_pplx, next-step accuracy and num_predictions within
  1e-5; `_FullLogits` and the decode head are the untied head's.
- A tiny `WordLevelOneBwdsSampledSoftmax` twin (the registered recipe at
  V 1003) through the executor, 4 steps and one eval, from the
  reference's init in one npz: every metrics row and the final theta
  against the reference executor's.
- `--list_models` lists the three 1B-words experiments with the
  reference's datasets, `--mode=inspect_model` prints the reference's
  rows for the sampled one, and `OneBWdsRealData` raises naming ROADMAP
  item 11.
- On the card (`cuda`): row 7's kernel with a non-zero bias and a
  vocabulary that is not a multiple of 128 (1003 and 793,470) against
  its plain version, and the negative ids drawn on the card against the
  CPU's (mismatches counted, each one id away where the card's exp, within
  3 ulps of the CPU's, differs).
"""

import argparse
import json
import os
import types

import numpy as np
import pytest
import torch

from lingvo_tpu_torch import convert
from lingvo_tpu_torch import model_registry
from lingvo_tpu_torch import trainer
from lingvo_tpu_torch.core import base_layer
from lingvo_tpu_torch.core import checkpointer
from lingvo_tpu_torch.core import jit_arith
from lingvo_tpu_torch.core import layers
from lingvo_tpu_torch.core import optimizer
from lingvo_tpu_torch.core import py_utils
from lingvo_tpu_torch.core import threefry
from lingvo_tpu_torch.core.nested_map import NestedMap
from lingvo_tpu_torch.models.lm import layers as lm_layers
from lingvo_tpu_torch.models.lm.params import one_billion_wds
from lingvo_tpu_torch.ops import fused_xent
from lingvo_tpu_torch.runners import executor

V_WORDS = 793_470
B, T = 2, 16


def _Jax():
  """The reference's modules, imported here only (the `cuda` cases run
  where JAX is not installed)."""
  import jax
  import jax.numpy as jnp
  from lingvo_tpu import model_registry as jax_registry
  from lingvo_tpu import trainer as jax_trainer
  from lingvo_tpu.core import layers as jax_layers
  from lingvo_tpu.core import py_utils as jax_py_utils
  from lingvo_tpu.core.nested_map import NestedMap as JaxNestedMap
  from lingvo_tpu.models.lm import layers as jax_lm
  from lingvo_tpu.models.lm.params import one_billion_wds as jax_1bw
  from lingvo_tpu.runners import executor as jax_executor
  return types.SimpleNamespace(
      jax=jax, jnp=jnp, registry=jax_registry, trainer=jax_trainer,
      layers=jax_layers, py_utils=jax_py_utils, NestedMap=JaxNestedMap,
      lm=jax_lm, one_billion_wds=jax_1bw, executor=jax_executor)


def _Heads(vocab, num_sampled, dim=8):
  j = _Jax()
  ref = j.layers.SampledSoftmax.Params().Set(
      name="sm", input_dim=dim, num_classes=vocab,
      num_sampled=num_sampled).Instantiate()
  ref.FinalizePaths("lm/sampled_softmax")
  port = layers.SampledSoftmax.Params().Set(
      name="sm", input_dim=dim, num_classes=vocab,
      num_sampled=num_sampled).Instantiate(device="meta")
  port.FinalizePaths("lm/sampled_softmax")
  return ref, port


def test_log_expected_count_matches_jitted_reference():
  j = _Jax()
  ref, port = _Heads(V_WORDS, 4096)
  ids = np.unique(np.concatenate([
      np.arange(0, 5000), np.random.RandomState(0).randint(
          0, V_WORDS, 20000), np.arange(V_WORDS - 2000, V_WORDS)])).astype(
              np.int32)
  want = np.asarray(j.jax.jit(ref._LogExpectedCount)(j.jnp.asarray(ids)))
  got = port._LogExpectedCount(torch.as_tensor(ids)).numpy()
  assert got.dtype == np.float32
  np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
  exact = (got == want).mean()
  assert exact > 0.95
  # the eager reference's true division: further from the jitted program
  t = torch.as_tensor(ids).float()
  divided = (torch.log(torch.log((t + 2.0) / (t + 1.0)) /
                       np.float32(np.log(V_WORDS + 1.0))) +
             np.log(4096.0)).numpy()
  assert (divided == want).mean() < exact
  assert jit_arith.Reciprocal(np.log(V_WORDS + 1.0)) != 1 / np.log(
      V_WORDS + 1.0)


def _RefIds(ref, keys):
  j = _Jax()
  draw = j.jax.jit(j.jax.vmap(ref._SampleNegatives))
  return np.asarray(draw(j.jnp.asarray(keys, j.jnp.uint32)))


def _StepKeys(n, name="lm/sampled_softmax/sampled_softmax"):
  """The keys a run's first n steps draw negatives from (base 1234)."""
  keys = []
  for step in range(n):
    with py_utils.StepSeedContext(threefry.FoldIn(threefry.PRNGKey(1234),
                                                  step)):
      keys.append(py_utils.StepSeed(name).numpy())
  return np.stack(keys)


@pytest.mark.parametrize("vocab", [V_WORDS, 1003])
def test_negative_ids_match_reference(vocab):
  ref, port = _Heads(vocab, 4096)
  keys = _StepKeys(50)
  want = _RefIds(ref, keys)
  got = np.stack([port.SampleNegatives(torch.as_tensor(k), "cpu").numpy()
                  for k in keys])
  assert got.dtype == want.dtype == np.int32
  assert got.min() >= 0 and got.max() < vocab
  off = got != want
  print(f"V {vocab}: {int(off.sum())} of {off.size} negative ids differ")
  assert (np.abs(got[off].astype(np.int64) - want[off]) == 1).all()
  if vocab == 1003:
    assert not off.any()
  else:
    # each mismatch is an exp that XLA and PyTorch round to floats on two
    # sides of an integer: the two exps differ by an ulp there
    j = _Jax()
    scale = np.float32(np.log(vocab + 1.0))
    u = np.stack([threefry.Uniform01(torch.as_tensor(k), (4096,)).numpy()
                  for k in keys])
    ulps = _ExpUlps(np.asarray(j.jax.jit(lambda x: j.jnp.exp(x * scale))(
        j.jnp.asarray(u))), torch.exp(torch.as_tensor(u) * scale).numpy())
    assert ulps.max() <= 1 and (ulps[off] == 1).all()
    # the distribution is the log-uniform one: a third of the draws
    # below id 95 (V^(1/3)), half below 890 (sqrt(V))
    assert 0.2 < (got < 95).mean() < 0.45 and 0.4 < (got < 890).mean() < 0.6


# -- the LM ----------------------------------------------------------------------


def _LmParams(lib, **kw):
  return lib.TransformerLm.Params().Set(
      name="lm", vocab_size=1003, model_dim=32, num_layers=2, num_heads=2,
      hidden_dim=64, use_rotary=True, softmax_num_sampled=64,
      residual_dropout_prob=0.1, **kw)


def _Pair(seed=0, **kw):
  j = _Jax()
  task = _LmParams(j.lm, **kw).Instantiate()
  task.FinalizePaths()
  theta = task.InstantiateVariables(j.jax.random.PRNGKey(seed))
  rng = np.random.RandomState(seed + 100)
  theta = j.jax.tree_util.tree_map(
      lambda x: np.asarray(x) + 0.1 * rng.randn(*x.shape).astype(np.float32),
      theta)
  port = _LmParams(lm_layers, **kw).Instantiate(device="cpu")
  port.FinalizePaths()
  loaded = convert.LoadJaxTheta(port, theta)
  assert "sampled_softmax.w" in loaded and "sampled_softmax.b" in loaded
  return task, theta, port


def _Batch(seed=0, vocab=1003):
  rng = np.random.RandomState(seed)
  seg = np.ones((B, T), np.int32)
  seg[0, 9:] = 2
  seg[1, 13:] = 0
  labels = rng.randint(1, vocab, (B, T)).astype(np.int32)
  labels[0, :3] = [0, 1, 2]   # frequent ids: some hit the negatives
  return NestedMap(
      ids=rng.randint(1, vocab, (B, T)).astype(np.int32), labels=labels,
      paddings=(seg == 0).astype(np.float32), segment_ids=seg)


def _ToJax(batch):
  j = _Jax()
  return j.NestedMap({k: j.jnp.asarray(v) for k, v in batch.items()})


def _Grads(port):
  out = {}
  for k, leaf in port.ThetaTree().FlattenItems():
    g = [m.grad.numpy() for m in optimizer.Members(leaf)]
    out[k] = np.stack(g) if isinstance(leaf, base_layer.StackedLeaf) else g[0]
  return out


def test_sampled_loss_and_grads_match_reference():
  j = _Jax()
  task, theta, port = _Pair()
  batch = _Batch()
  key = j.jax.random.fold_in(j.jax.random.PRNGKey(1234), 5)

  def Loss(th):
    with j.py_utils.StepSeedContext(key):
      m, per = task.FProp(th, _ToJax(batch))
    return m.loss[0], (m, per)

  (_, (jm, jper)), jgrads = j.jax.jit(j.jax.value_and_grad(
      Loss, has_aux=True))(j.jax.tree_util.tree_map(j.jnp.asarray, theta))
  with py_utils.StepSeedContext(
      torch.as_tensor(np.asarray(key).astype(np.int64))):
    tm, tper = port.FProp(batch.Transform(torch.as_tensor))
  tm.loss[0].backward()
  # the sampled loss is training's only: no seed, or eval, raises
  x = torch.zeros(2, port.p.model_dim)
  ids = torch.zeros(2, dtype=torch.int32)
  with pytest.raises(RuntimeError, match="StepSeedContext"):
    port.sampled_softmax.XentLossFromInputs(x, ids)
  with py_utils.StepSeedContext(threefry.PRNGKey(0)), \
      py_utils.EvalContext(), pytest.raises(RuntimeError):
    port.sampled_softmax.XentLossFromInputs(x, ids)
  assert sorted(tm) == sorted(jm) == ["log_pplx", "loss", "num_predictions"]
  for k in tm:
    np.testing.assert_allclose(float(tm[k][0].detach()), float(jm[k][0]),
                               atol=1e-5, err_msg=k)
  np.testing.assert_allclose(tper.xent.detach().numpy(),
                             np.asarray(jper.xent), atol=2e-5, rtol=1e-5)
  grads = _Grads(port)
  jflat = dict(jgrads.FlattenItems())
  assert sorted(grads) == sorted(jflat)
  assert "sampled_softmax.w" in grads
  for k, g in grads.items():
    np.testing.assert_allclose(g, np.asarray(jflat[k]), atol=2e-5, rtol=1e-4,
                               err_msg=k)
  # the negatives' rows of the table get gradient, the others none
  rows = np.abs(grads["sampled_softmax.w"]).sum(-1) > 0
  assert 10 < rows.sum() < 1003 - 500


def test_fused_eval_matches_reference_dense_eval():
  j = _Jax()
  task, theta, port = _Pair(seed=3)
  batch = _Batch(seed=4)
  jm, jper = j.jax.jit(task.EvalStep)(
      j.jax.tree_util.tree_map(j.jnp.asarray, theta), _ToJax(batch))
  before = fused_xent.FusedXentStats.launches
  tm, tper = port.EvalStep(batch.Transform(torch.as_tensor))
  assert fused_xent.FusedXentStats.launches == before   # the plain version
  assert sorted(tm) == sorted(jm)
  assert "fraction_of_correct_next_step_preds" in tm
  for k in tm:
    for i in (0, 1):
      np.testing.assert_allclose(float(tm[k][i]), float(jm[k][i]), atol=1e-5,
                                 err_msg=k)
  np.testing.assert_allclose(tper.xent.numpy(), np.asarray(jper.xent),
                             atol=2e-5, rtol=1e-5)
  # a step seed without eval mode is training; eval mode wins over it
  with py_utils.StepSeedContext(threefry.PRNGKey(1)), py_utils.EvalContext():
    again, _ = port.FProp(batch.Transform(torch.as_tensor))
  assert float(again.loss[0].detach()) == float(tm.loss[0])
  # the dense consumers and the decode head score with the untied head
  with torch.no_grad():
    preds = port.ComputePredictions(batch.Transform(torch.as_tensor))
    logits = port._FullLogits(preds)
    want = port.sampled_softmax.Logits(preds.hidden)
    assert torch.equal(logits, want)
    jpreds = j.jax.jit(lambda th, b: task.ComputePredictions(th, b))(
        j.jax.tree_util.tree_map(j.jnp.asarray, theta), _ToJax(batch))
  j_logits = jpreds.logits if "logits" in jpreds else None
  with j.py_utils.EvalContext():
    j_logits = j.jax.jit(lambda th, b: task.ComputePredictions(th, b))(
        j.jax.tree_util.tree_map(j.jnp.asarray, theta), _ToJax(batch)).logits
  np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=2e-5,
                             rtol=1e-5)


# -- the registered recipe through the executor ---------------------------------


_TWIN = dict(VOCAB=1003, SEQ=16, BATCH=4, MODEL_DIM=32, NUM_LAYERS=2,
             NUM_HEADS=2, HIDDEN_DIM=64, NUM_SAMPLED=64)


def _TwinTask(base):
  def Task(self):
    p = base.Task(self)
    p.train.tpu_steps_per_loop = 4
    p.train.max_steps = 4
    p.eval.samples_per_summary = 8
    # warmup 2 (not 4000), so that theta moves by more than the tolerance
    p.train.learner.lr_schedule.warmup_steps = 2
    return p
  return Task


def _Twin(registry, base):
  return registry.RegisterSingleTaskModel(type(
      "WordLevelOneBwdsTwin", (base,), dict(_TWIN, Task=_TwinTask(base))))


@pytest.fixture(scope="module")
def twin_runs(tmp_path_factory):
  j = _Jax()
  ref_cls = _Twin(j.registry, j.one_billion_wds.WordLevelOneBwdsSampledSoftmax)
  port_cls = _Twin(model_registry,
                   one_billion_wds.WordLevelOneBwdsSampledSoftmax)
  key = ref_cls._registry_key
  assert port_cls._registry_key == key
  tmp = tmp_path_factory.mktemp("twin")
  mp = j.registry.GetParams(key, "Train")
  task = mp.task.Instantiate()
  task.FinalizePaths()
  init = task.CreateTrainState(j.jax.random.PRNGKey(1234)).theta
  npz = str(tmp / "init.npz")
  np.savez(npz, **{k: np.asarray(v) for k, v in init.FlattenItems()})
  ref_dir = str(tmp / "ref")
  mp = j.registry.GetParams(key, "Train")
  mp.task.train.init_from_npz = npz
  sched, task = j.trainer._BuildSchedule(mp, argparse.Namespace(
      model=key, logdir=ref_dir, train_executions_per_eval=1))
  state = j.executor.ExecutorTpu(mp, ref_dir, schedule=sched,
                                 task=task).Start()
  ref_theta = {k: np.asarray(v) for k, v in state.theta.FlattenItems()}
  port_dir = str(tmp / "port")
  pmp = model_registry.GetParams(key, "Train")
  pmp.task.train.init_from_npz = npz
  sched, ptask = trainer._BuildSchedule(pmp, argparse.Namespace(
      model=key, logdir=port_dir, device="cpu", train_executions_per_eval=1))
  executor.ExecutorTpu(pmp, port_dir, schedule=sched, task=ptask).Start()
  return npz, ref_dir, ref_theta, port_dir, pmp


def _Rows(logdir):
  with open(os.path.join(logdir, "metrics.jsonl")) as f:
    return [json.loads(line) for line in f]


def test_twin_executor_matches_reference(twin_runs):
  npz, ref_dir, ref_theta, port_dir, pmp = twin_runs
  rows, ref_rows = _Rows(port_dir), _Rows(ref_dir)
  assert [r["step"] for r in rows] == [r["step"] for r in ref_rows] == [4]
  for got, want in zip(rows, ref_rows):
    assert sorted(got["train"]) == sorted(want["train"])
    for k in ("loss", "log_pplx", "num_predictions", "grad_norm",
              "learning_rate", "grad_scale", "skipped_step"):
      np.testing.assert_allclose(got["train"][k], want["train"][k],
                                 atol=1e-5, rtol=1e-5, err_msg=k)
    assert sorted(got["eval_test"]) == sorted(want["eval_test"])
    for k in ("loss", "log_pplx", "fraction_of_correct_next_step_preds",
              "num_predictions"):
      np.testing.assert_allclose(got["eval_test"][k], want["eval_test"][k],
                                 atol=1e-5, rtol=1e-5, err_msg=k)
  fresh = pmp.task.Instantiate(device="cpu")
  _, step = checkpointer.Checkpointer(
      os.path.join(port_dir, "train")).Restore(fresh)
  assert step == 4
  got = dict(convert.ThetaToNumpy(fresh).FlattenItems())
  assert sorted(got) == sorted(ref_theta)
  init = np.load(npz)
  moved = max(float(np.abs(ref_theta[k] - init[k]).max()) for k in ref_theta)
  assert moved > 1e-3
  for k, v in got.items():
    np.testing.assert_allclose(v, ref_theta[k], atol=1e-5, rtol=1e-4,
                               err_msg=k)


def test_one_billion_wds_models_list_and_inspect_as_reference(capsys):
  j = _Jax()
  import lingvo_tpu.models.all_params  # noqa: F401
  names = ("OneBWdsTransformerLm", "OneBWdsRealData",
           "WordLevelOneBwdsSampledSoftmax")

  def Listed(main):
    assert main(["--list_models"]) == 0
    out = capsys.readouterr().out.splitlines()
    return sorted(line for line in out if line.startswith("lm.one_billion"))

  want = Listed(j.trainer.main)
  assert len(want) == 3 and all(any(n in w for w in want) for n in names)
  assert Listed(trainer.main) == want
  model = "--model=lm.one_billion_wds.WordLevelOneBwdsSampledSoftmax"
  assert j.trainer.main([model, "--mode=inspect_model"]) == 0
  want = capsys.readouterr().out.strip().splitlines()
  assert trainer.main([model, "--mode=inspect_model"]) == 0
  got = capsys.readouterr().out.strip().splitlines()
  assert got == want
  assert any("sampled_softmax" in line for line in got)
  with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
    model_registry.GetParams("lm.one_billion_wds.OneBWdsRealData", "Train")
  p = model_registry.GetParams(
      "lm.one_billion_wds.WordLevelOneBwdsSampledSoftmax", "Train").task
  assert (p.vocab_size, p.softmax_num_sampled, p.residual_dropout_prob) == (
      793_470, 4096, 0.1)
  assert p.train.learner.optimizer.beta2 == 0.98


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: the fused-xent kernel is CUDA C++ with "
                "no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("m, vocab", [(300, 1003), (256, V_WORDS)])
def test_xent_kernel_with_bias_and_a_ragged_tail_on_card(cuda, m, vocab):
  """Row 7 as the sampled task's eval calls it: the untied [V, D] table,
  a non-zero bias, no cap, V not a multiple of 128 (a tail of 107 and of
  126 columns). lse and the label logit within 1e-4 of the plain version,
  the argmax equal."""
  rng = np.random.RandomState(28)
  d = 128
  g = torch.Generator("cuda").manual_seed(28)
  x = torch.randn((m, d), device="cuda", generator=g)
  w = torch.randn((vocab, d), device="cuda", generator=g) / np.sqrt(d)
  b = torch.randn((vocab,), device="cuda", generator=g)
  labels = torch.as_tensor(rng.randint(0, vocab, m).astype(np.int32)).cuda()
  cfg = fused_xent._Cfg(block_size=1024, vocab=vocab, vd=True, soft_cap=0.0,
                        label_smoothing=0.0)
  before = fused_xent.FusedXentStats.launches
  got = fused_xent.FusedXentStats(x, w, b, labels, cfg)
  want = fused_xent._PlainStats(x, w, b, labels, cfg)
  torch.cuda.synchronize()
  assert fused_xent.FusedXentStats.launches == before + 1
  for a, e in zip(got[:2], want[:2]):
    assert float((a - e).abs().max()) <= 1e-4
  assert torch.equal(got[3], want[3])
  assert got[2] is None


def _ExpUlps(a, b):
  a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
  return np.abs(a - np.asarray(b, np.float32).view(np.int32))


# The share of negative ids allowed to differ between the card and the
# CPU. An id moves where the two exps straddle an integer: at V 793,470 the
# mean ulp of exp over the draws is 0.0051 of an id, so a gap of g ulps
# moves about g * 0.51% of the ids. 0.3% allows a mean gap of 0.6 ulps and
# fails any change in how the ids are truncated, which moves far more.
IDS_OFF_SHARE = 0.003


@pytest.mark.cuda
def test_negative_ids_on_card_match_cpu(cuda):
  """The uniforms bitwise equal; exp(u log(V + 1)) on the card within 3
  ulps of the CPU's (CUDA's expf is within 2 ulps of exp, PyTorch's CPU
  exp within 1); every id that differs is one id away, where the two exps
  differ, and at most IDS_OFF_SHARE of them differ."""
  port = layers.SampledSoftmax.Params().Set(
      name="sm", input_dim=8, num_classes=V_WORDS,
      num_sampled=4096).Instantiate(device="meta")
  keys = _StepKeys(50)
  u = [threefry.Uniform01(torch.as_tensor(k), (4096,)) for k in keys]
  assert all(torch.equal(threefry.Uniform01(torch.as_tensor(k).cuda(),
                                            (4096,)).cpu(), x)
             for k, x in zip(keys, u))
  scale = np.log(V_WORDS + 1.0)
  ulps = np.stack([_ExpUlps(torch.exp(x.cuda() * scale).cpu().numpy(),
                            torch.exp(x * scale).numpy()) for x in u])
  got = np.stack([port.SampleNegatives(torch.as_tensor(k), "cuda").cpu()
                  .numpy() for k in keys])
  want = np.stack([port.SampleNegatives(torch.as_tensor(k), "cpu").numpy()
                   for k in keys])
  off = got != want
  print(f"card vs CPU: {int(off.sum())} of {off.size} negative ids differ; "
        f"exp at most {ulps.max()} ulps apart")
  assert ulps.max() <= 3
  assert (np.abs(got[off].astype(np.int64) - want[off]) == 1).all()
  assert (ulps[off] > 0).all()
  assert off.sum() <= IDS_OFF_SHARE * off.size
