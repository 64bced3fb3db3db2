"""The multi-task surface against the JAX reference on the CPU.

- The task schedulers (constant, exponential, adaptive) draw the
  reference's task sequence from the same seed, their probabilities
  equal.
- `SharedVariableRules` on two tasks' modules: the reference's keys,
  `UnifyStates` (the first task in sorted order donates), `Propagate`
  (a task whose two paths share one key is re-tied), and the loud shape
  mismatch, each against the reference's rules on the same values.
- `LinearCombiner` and `PCGradCombiner` against the reference's
  `Combine` on the same gradient trees (atol 1e-7, rtol 1e-6).
- `GradDropSplit`'s backward against `jax.grad` through the reference's
  custom VJP with one key, under five configurations: the gradients
  within atol 1e-6, rtol 1e-5, and the uniform draw bit for bit
  (`threefry.Uniform01` is `jax.random.uniform`).
- `ExecutorTpu(None, logdir, schedule=MultiTaskProgramSchedule(...))`
  with two tiny LM tasks sharing their embedding through
  `variable_renaming_rules`, task a on EGDD and task b on
  AdaGraft(Adam, Momentum), `ConstantScheduler` seed 3, 2 steps a cycle,
  8 steps in all, from the reference's init (written as the port's
  step-0 checkpoint), against the reference's executor: the sampled
  sequence equal, both tasks sampled, the shared leaves bitwise equal
  after every cycle, the per-task steps equal, every train loss within
  1e-5 and the final per-task theta within atol 1e-5, rtol 1e-4; the
  combined checkpoint round-trips (tensors bitwise, per-task steps).
  Task b's key biases are trained by no learner: their exact gradient is
  zero, and AdaGraft scales their rounding noise to Adam's step length.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lingvo_tpu.core import base_model_params as jax_model_params
from lingvo_tpu.core import gradient_combiner as jax_combiner
from lingvo_tpu.core import graddrop as jax_graddrop
from lingvo_tpu.core import hyperparams as jax_hyperparams
from lingvo_tpu.core import multitask_model as jax_multitask
from lingvo_tpu.core import task_scheduler as jax_scheduler
from lingvo_tpu.core.nested_map import NestedMap as JaxNestedMap
from lingvo_tpu.models.lm import input_generator as jax_input
from lingvo_tpu.runners import executor as jax_executor
from lingvo_tpu.runners import program as jax_program
from lingvo_tpu_torch import convert
from lingvo_tpu_torch import model_registry
from lingvo_tpu_torch.core import base_model
from lingvo_tpu_torch.core import base_model_params
from lingvo_tpu_torch.core import checkpointer
from lingvo_tpu_torch.core import gradient_combiner
from lingvo_tpu_torch.core import graddrop
from lingvo_tpu_torch.core import hyperparams
from lingvo_tpu_torch.core import multitask_model
from lingvo_tpu_torch.core import task_scheduler
from lingvo_tpu_torch.core import threefry
from lingvo_tpu_torch.core.nested_map import NestedMap
from lingvo_tpu_torch.models.lm import input_generator
from lingvo_tpu_torch.runners import executor
from lingvo_tpu_torch.runners import program

from tests import torch_train_helpers as h


@pytest.mark.parametrize("kind", ["constant", "exponential", "adaptive"])
def test_schedulers_sample_the_references_sequence(kind):
  kw = {
      "constant": dict(task_probs=[("a", 0.7), ("b", 0.2), ("c", 0.1)],
                       seed=3),
      "exponential": dict(task_probs=[("a", 1.0), ("b", 0.0)],
                          task_probs_final=[("a", 0.0), ("b", 1.0)],
                          alpha=1e-3, seed=0),
      "adaptive": dict(targets=[("a", 1.0), ("b", 2.0)], seed=5),
  }[kind]
  cls = {"constant": "ConstantScheduler", "exponential":
         "ExponentialScheduler", "adaptive": "AdaptiveScheduler"}[kind]
  j = getattr(jax_scheduler, cls).Params().Set(**kw).Instantiate()
  t = getattr(task_scheduler, cls).Params().Set(**kw).Instantiate()
  for step in range(0, 4000, 20):
    if kind == "adaptive" and step == 200:
      for s in (j, t):
        s.ReportMetric("a", 5.0)
        s.ReportMetric("b", 2.5)
    assert t.Sample(step) == j.Sample(step)
    np.testing.assert_array_equal(t.cur_probs, j.cur_probs)


def _Tasks(pkg, names=("a", "b")):
  out = {}
  for i, name in enumerate(names):
    p = h.TinyLm(pkg, name=name)
    task = p.Instantiate() if pkg is h.JAX else p.Instantiate(device="cpu")
    task.FinalizePaths()
    out[name] = task
  return out


def _Values(tasks, seed):
  """Random values for every leaf of each task, as reference theta trees
  (loaded into the port's tasks)."""
  rng = np.random.RandomState(seed)
  out = {}
  for name, task in tasks.items():
    theta = convert.ThetaToNumpy(task)
    out[name] = theta.Transform(
        lambda x: rng.randn(*x.shape).astype(np.float32))
    convert.LoadJaxTheta(task, out[name])
  return out


@pytest.mark.parametrize("rules", [
    [(r"emb\.(.*)", r"shared_emb.\1")],
    [(r"(emb\.emb|final_ln\.scale)", r"tied")],   # fails: shapes differ
    [(r"final_ln\.(scale|bias)", r"shared_ln")]])  # two paths, one key
def test_shared_variable_rules_match_reference(rules):
  tasks = _Tasks(h.PORT)
  values = _Values(tasks, 0)
  states = JaxNestedMap({n: JaxNestedMap(theta=h.JaxTree(v))
                         for n, v in values.items()})
  jrules = jax_multitask.SharedVariableRules(rules)
  trules = multitask_model.SharedVariableRules(rules)
  if rules[0][1] == "tied":
    with pytest.raises(ValueError, match="pairs"):
      jrules.UnifyStates(states)
    with pytest.raises(ValueError, match="pairs"):
      trules.UnifyStates(tasks)
    return
  assert trules.SharedPaths(tasks) == jrules.SharedPaths(states)
  states = jrules.UnifyStates(states)
  trules.UnifyStates(tasks)
  for n, task in tasks.items():
    h.CheckTheta(task, states[n].theta, atol=0, rtol=0)
  # task a trains: every leaf moves; then a's shared values go out
  with torch.no_grad():
    for prm in tasks["a"].parameters():
      prm.add_(1.0 + torch.arange(prm.numel()).reshape(prm.shape) * 1e-3)
  states["a"].theta = h.JaxTree(convert.ThetaToNumpy(tasks["a"]))
  states = jrules.Propagate(states, "a")
  trules.Propagate(tasks, "a")
  for n, task in tasks.items():
    h.CheckTheta(task, states[n].theta, atol=0, rtol=0)


def _Lg(pkg, grads):
  out = {}
  for name, g in grads.items():
    if pkg is h.JAX:
      out[name] = JaxNestedMap(loss_metric=(jnp.asarray(1.0), 1.0),
                               grads=JaxNestedMap(
                                   {k: jnp.asarray(v) for k, v in g.items()}))
    else:
      out[name] = NestedMap(loss_metric=(torch.tensor(1.0), 1.0),
                            grads={k: torch.tensor(v) for k, v in g.items()})
  return out


@pytest.mark.parametrize("kind", ["linear", "linear_weighted", "pcgrad"])
def test_gradient_combiners_match_reference(kind):
  rng = np.random.RandomState(1)
  grads = {n: {"w": rng.randn(8, 4).astype(np.float32),
               "b": rng.randn(5).astype(np.float32)} for n in "abc"}
  grads["b"]["w"] = -grads["a"]["w"] + 0.1 * grads["b"]["w"]   # conflicts
  if kind == "pcgrad":
    j = jax_combiner.PCGradCombiner.Params().Instantiate()
    t = gradient_combiner.PCGradCombiner.Params().Instantiate(device="cpu")
  else:
    w = {"a": 0.5, "c": 2.0} if kind == "linear_weighted" else None
    j = jax_combiner.LinearCombiner.Params().Set(loss_weights=w).Instantiate()
    t = gradient_combiner.LinearCombiner.Params().Set(
        loss_weights=w).Instantiate(device="cpu")
  want = j.Combine(None, _Lg(h.JAX, grads))
  got = t.Combine(None, _Lg(h.PORT, grads))
  assert sorted(got) == sorted(want)
  for k in got:
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                               atol=1e-7, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(keep_prob_function="sigmoid", keep_prob_function_scale=2.0),
    dict(use_input_sign_only=False, marginalize_batch_dim=False),
    dict(leak_ratios=(0.25, 0.0, 0.5), keep_gradnorm_constant=False),
    dict(marginalize_batch_dim=False, epsilon=1e-3)])
def test_graddrop_backward_matches_reference(cfg):
  rng = np.random.RandomState(2)
  x = rng.randn(4, 6).astype(np.float32)
  x[0, 0] = 0.0
  heads = rng.randn(3, 4, 6).astype(np.float32)
  jcfg = jax_graddrop.GradDropConfig(**cfg)
  tcfg = graddrop.GradDropConfig(**cfg)

  def JLoss(x):
    xs = jax_graddrop.GradDropSplit(x, jax.random.PRNGKey(7), 3, jcfg)
    return sum(jnp.sum(jnp.tanh(xi) * hd) for xi, hd in zip(xs, heads))

  want = np.asarray(jax.jit(jax.grad(JLoss))(jnp.asarray(x)))
  tx = torch.tensor(x, requires_grad=True)
  xs = graddrop.GradDropSplit(tx, threefry.PRNGKey(7), 3, tcfg)
  for xi in xs:
    torch.testing.assert_close(xi, tx, rtol=0, atol=0)
  sum(torch.sum(torch.tanh(xi) * torch.tensor(hd))
      for xi, hd in zip(xs, heads)).backward()
  np.testing.assert_allclose(tx.grad.numpy(), want, atol=1e-6, rtol=1e-5)
  shape = (1, 6) if tcfg.marginalize_batch_dim else (4, 6)
  np.testing.assert_array_equal(
      threefry.Uniform01(threefry.PRNGKey(7), shape).numpy(),
      np.asarray(jax.random.uniform(jax.random.PRNGKey(7), shape)))


SHARE = [(r"emb\.(.*)", r"shared_emb.\1")]
STEPS_PER_CYCLE, MAX_STEPS = 2, 8


def _TaskP(pkg, name):
  p = h.TinyLm(pkg, name=name)
  if name == "a":
    opt = pkg.optimizer.EGDD.Params()
    exclusion = None
  else:
    opt = pkg.optimizer.AdaGraft.Params().Set(
        magnitude_optimizer=pkg.optimizer.Adam.Params().Set(beta2=0.98),
        direction_optimizer=pkg.optimizer.Momentum.Params())
    exclusion = r"\.b_key$"
  p.train.learner = pkg.learner.Learner.Params().Set(
      name="lrn", learning_rate=0.01, optimizer=opt,
      bprop_variable_exclusion=exclusion)
  p.train.max_steps = MAX_STEPS
  p.train.save_interval_steps = 4
  return p


def _Experiment(pkg):
  """Tasks a and b as a MultiTaskModelParams experiment."""
  bmp = jax_model_params if pkg is h.JAX else base_model_params
  hp = jax_hyperparams if pkg is h.JAX else hyperparams

  def _Task(self):
    tp = hp.Params()
    for name in ("a", "b"):
      tp.Define(name, _TaskP(pkg, name), "")
    return tp

  return type("TwoTinyLms", (bmp.MultiTaskModelParams,), {"Task": _Task})


JAX_EXPERIMENT, PORT_EXPERIMENT = _Experiment(h.JAX), _Experiment(h.PORT)


def _Input(pkg, seed):
  inp = jax_input if pkg is h.JAX else input_generator
  return inp.SyntheticLmInput.Params().Set(
      batch_size=h.B, seq_len=h.T, vocab_size=h.V, packing=True,
      seed=seed).Instantiate()


def _Schedule(pkg, logdir, registered=False):
  """The schedule over tasks a and b. `registered`: the tasks' params
  come from the registered experiment's model params and the schedule
  builds the tasks itself; an eval program on task b runs every cycle."""
  hp = jax_hyperparams if pkg is h.JAX else hyperparams
  prog = jax_program if pkg is h.JAX else program
  sched_mod = jax_scheduler if pkg is h.JAX else task_scheduler
  train_programs = hp.Params()
  tasks, gens = {}, {}
  experiment = JAX_EXPERIMENT if pkg is h.JAX else PORT_EXPERIMENT
  task_ps = (dict(experiment().Model().task_params.IterParams())
             if registered else {n: _TaskP(pkg, n) for n in ("a", "b")})
  for i, name in enumerate(("a", "b")):
    tp = task_ps[name]
    if not registered:
      tasks[name] = (tp.Instantiate() if pkg is h.JAX
                     else tp.Instantiate(device="cpu"))
      tasks[name].FinalizePaths()
    train_programs.Define(name, prog.TrainProgram.Params().Set(
        task=tp, logdir=logdir, name=f"train_{name}",
        steps_per_loop=STEPS_PER_CYCLE), "")
    gens[(name, "Train")] = _Input(pkg, 11 + i)
  sched_p = prog.MultiTaskProgramSchedule.Params().Set(
      task_schedule=sched_mod.ConstantScheduler.Params().Set(
          task_probs=[("a", 0.5), ("b", 0.5)], seed=3),
      train_programs=train_programs, variable_renaming_rules=SHARE)
  if registered:
    ep = prog.EvalProgram.Params().Set(
        task=task_ps["b"], logdir=logdir, name="eval_b", steps_per_loop=1)
    ep.Define("task_name", "b", "")
    sched_p.eval_programs = [ep]
    gens[("b", "Test")] = _Input(pkg, 99)
  if pkg is h.JAX:
    return prog.MultiTaskProgramSchedule(
        sched_p, tasks=tasks or None, input_generators=gens)
  return prog.MultiTaskProgramSchedule(
      sched_p, tasks=tasks or None, input_generators=gens, device="cpu")


def _Rows(logdir):
  with open(os.path.join(logdir, "metrics.jsonl")) as f:
    return [json.loads(line) for line in f]


@pytest.mark.parametrize("registered", [False, True])
def test_multitask_executor_matches_reference(tmp_path, registered):
  ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
  if registered:
    # the registry: the experiment's model wraps the tasks by name (the
    # class leaves the process-wide registry after the lookup)
    key = model_registry.RegisterMultiTaskModel(
        PORT_EXPERIMENT)._registry_key
    try:
      tmodel = model_registry.GetClass(key)().Model().Instantiate(
          device="cpu")
    finally:
      model_registry._MODEL_REGISTRY.pop(key)
    jmodel = JAX_EXPERIMENT().Model().Instantiate()
    assert tmodel.task_names == jmodel.task_names == ["a", "b"]
    assert tmodel.GetTask() is tmodel.tasks[0] is tmodel.GetTask("a")
    for name in ("a", "b"):
      want = {k: tuple(v.shape) for k, v in
              jmodel.GetTask(name).VariableSpecs().FlattenItems()}
      assert {k: tuple(v.shape) for k, v in tmodel.GetTask(
          name).VariableSpecs().FlattenItems()} == want
  jsched = _Schedule(h.JAX, ref_dir, registered)
  init = h.Numpy(jsched.CreateTrainState(jax.random.PRNGKey(1234)))
  jstate = jax_executor.ExecutorTpu(None, ref_dir, schedule=jsched).Start()
  # the port starts from the reference's init: its step-0 checkpoint
  tsched = _Schedule(h.PORT, port_dir, registered)
  assert isinstance(tsched.model, base_model.MultiTaskModel)
  assert {k.split(".")[0] for k in tsched.model.state_dict()} == {
      "task_a", "task_b"}
  for name, task in tsched.tasks.items():
    convert.LoadJaxTheta(task, init["tasks"][name]["theta"])
  start = tsched.CreateTrainState()
  convert.LoadJaxTrainState(start, init)
  checkpointer.Checkpointer(os.path.join(port_dir, "train")).Save(
      0, tsched.model, start, force=True)
  rules = multitask_model.SharedVariableRules(SHARE)
  shared = list(rules.SharedPaths(tsched.tasks).values())
  cycles = []
  run = tsched.Run

  def _Run(state):
    state, results = run(state)
    cycles.append(results["sampled_task"])
    theta = {n: dict(t.ThetaTree().FlattenItems())
             for n, t in tsched.tasks.items()}
    for entries in shared:
      (n0, p0), rest = entries[0], entries[1:]
      for n, p in rest:
        assert torch.equal(theta[n][p], theta[n0][p0]), (n, p)
    return state, results

  tsched.Run = _Run
  tstate = executor.ExecutorTpu(None, port_dir, schedule=tsched).Start()
  rows, ref_rows = _Rows(port_dir), _Rows(ref_dir)
  # a row per cycle, then the flushed tail's (an eval flushes each cycle)
  assert [r.get("sampled_task") for r in rows] == [
      r.get("sampled_task") for r in ref_rows] == cycles + (
          [] if registered else [None])
  assert set(cycles) == {"a", "b"}
  assert [r["step"] for r in rows] == [r["step"] for r in ref_rows]
  for got, want in zip(rows, ref_rows):
    assert sorted(got) == sorted(want)
    assert ("eval_b" in got) == registered
    for key in got:
      if key.startswith(("train_", "eval_")):
        np.testing.assert_allclose(got[key]["loss"], want[key]["loss"],
                                   atol=1e-5, rtol=1e-5)
  assert tstate.step == int(jstate.step) == MAX_STEPS
  for name, task in tsched.tasks.items():
    assert tstate.tasks[name].step == int(jstate.tasks[name].step)
    h.CheckTheta(task, jstate.tasks[name].theta, atol=1e-5, rtol=1e-4)
  # the combined checkpoint round-trips
  fresh = _Schedule(h.PORT, str(tmp_path / "fresh"), registered)
  restored, step = checkpointer.Checkpointer(
      os.path.join(port_dir, "train")).Restore(
          fresh.model, state=fresh.CreateTrainState())
  assert step == MAX_STEPS == restored.step
  for name in ("a", "b"):
    assert restored.tasks[name].step == tstate.tasks[name].step
  saved = dict(checkpointer._OptItems(tstate))
  for k, v in checkpointer._OptItems(restored):
    assert torch.equal(v, saved[k]), k
  for k, v in fresh.model.state_dict().items():
    assert torch.equal(v, tsched.model.state_dict()[k]), k
