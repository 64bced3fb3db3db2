"""Trainer CLI: the operator entry point (port of lingvo_tpu/trainer.py).

`--model` selects a registered experiment, `--mode` picks
train/eval/decode/inspect, `--logdir` receives the config, the parameter
analysis, the summaries and the checkpoints. `--mode=train` runs the
executor over a `SimpleProgramSchedule`: the train program, then an eval
program for each of the experiment's Test/Dev datasets. `--device` is the
port's counterpart of the reference's `JAX_PLATFORMS`: CUDA by default
(raising without a card), `cpu` on request.

Usage:
  python -m lingvo_tpu_torch.trainer \\
      --model=lm.synthetic_packed_input.DenseLmTiny --logdir=/tmp/tiny \\
      --mode=train --device=cpu
  python -m lingvo_tpu_torch.trainer --model=... --mode=inspect_model
  python -m lingvo_tpu_torch.trainer --list_models

Not ported yet, and raising when asked for: `--mode=export` (ROADMAP item
11, serving/export.py), the multi-host flags (`--coordinator_address`,
`--num_processes`; the parallelism slice, item 11) and the decode program
of a task with a Decode method (item 1.9).
"""

from __future__ import annotations

import argparse
import os
import sys

from lingvo_tpu_torch import model_registry


def _BuildSchedule(model_params, args):
  from lingvo_tpu_torch.core import base_model_params as bmp
  from lingvo_tpu_torch.core import input_policy
  from lingvo_tpu_torch.runners import program as program_lib
  task_p = model_params.task
  if task_p.input is None and model_params.input is not None:
    task_p.input = model_params.input
  inst = model_registry.GetClass(args.model)()
  # an experiment-provided schedule takes precedence
  ps = inst.ProgramSchedule()
  input_generators = {}
  train_p = program_lib.TrainProgram.Params().Set(
      task=task_p, logdir=args.logdir,
      steps_per_loop=task_p.train.tpu_steps_per_loop)
  eval_programs = []
  for ds in ("Test", "Dev"):
    try:
      ds_params = inst.GetDatasetParams(ds)
    except bmp.DatasetError:
      continue  # the dataset is not defined; real errors propagate
    eval_programs.append(program_lib.EvalProgram.Params().Set(
        task=task_p, logdir=args.logdir, dataset_name=ds,
        name=f"eval_{ds.lower()}"))
    input_generators[ds] = input_policy.Instantiate(ds_params)
    if ds == "Test" and getattr(task_p.cls, "Decode", None) is not None:
      raise NotImplementedError(
          "the decode program comes with ROADMAP item 1.9")
  if ps is None:
    ps = program_lib.SimpleProgramSchedule.Params().Set(
        train_program=train_p, eval_programs=eval_programs,
        train_executions_per_eval=args.train_executions_per_eval)
  # one task instance shared by all programs
  task = task_p.Instantiate(device=args.device)
  task.FinalizePaths()
  return ps.cls(ps, task=task, input_generators=input_generators), task


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--model", default="", help="Registered model name.")
  parser.add_argument("--logdir", default="",
                      help="Output directory (required by the train, eval, "
                      "decode and shell modes).")
  parser.add_argument("--mode", default="train",
                      choices=["train", "eval", "decode", "inspect_model",
                               "inspect_params", "export", "shell"],
                      help="What to run. 'export' (the serving bundle) is "
                      "not ported; 'shell' drops into an interactive prompt "
                      "with the model loaded.")
  parser.add_argument("--device", default="cuda",
                      help="Device of the model: cuda (the default; raises "
                      "without a card) or cpu.")
  parser.add_argument("--job", default="executor_tpu",
                      help="executor_tpu (train), or evaler/decoder "
                           "(checkpoint-polling follower jobs).")
  parser.add_argument("--poll_interval_secs", type=float, default=10.0)
  parser.add_argument("--poll_timeout_secs", type=float, default=3600.0,
                      help="Follower jobs exit after this long without a "
                           "new checkpoint (and as soon as the trainer's "
                           "FINISHED marker appears).")
  parser.add_argument("--coordinator_address", default=None,
                      help="Multi-host control plane (not ported).")
  parser.add_argument("--num_processes", type=int, default=None)
  parser.add_argument("--process_id", type=int, default=None)
  parser.add_argument("--mlperf_benchmark", default="",
                      help="If set, write MLPerf :::MLLOG compliance events "
                           "to <logdir>/mlperf_log.txt.")
  parser.add_argument("--max_steps", type=int, default=None,
                      help="Override task max_steps.")
  parser.add_argument("--train_executions_per_eval", type=int, default=1)
  parser.add_argument("--list_models", action="store_true")
  args = parser.parse_args(argv)

  if args.list_models:
    import lingvo_tpu_torch.models.all_params  # noqa: F401  (registry)
    from lingvo_tpu_torch import datasets as datasets_lib
    for name in sorted(model_registry.GetRegisteredModels()):
      try:
        ds = datasets_lib.GetDatasets(model_registry.GetClass(name))
      except Exception:  # noqa: BLE001 - listing must never crash
        ds = []
      print(f"{name}  [{', '.join(ds)}]" if ds else name)
    return 0

  if not args.model:
    parser.error("--model is required")
  if args.coordinator_address or args.num_processes:
    raise NotImplementedError(
        "multi-host training comes with the parallelism slice (ROADMAP "
        "item 11)")
  if args.mode == "export":
    raise NotImplementedError(
        "--mode=export comes with serving/export.py (ROADMAP item 11)")

  model_params = model_registry.GetParams(args.model, "Train")
  if args.max_steps is not None:
    model_params.task.train.max_steps = args.max_steps

  if args.mode in ("train", "eval", "decode", "shell") and not args.logdir:
    parser.error(f"--logdir is required for --mode={args.mode}")

  if args.mode == "inspect_params":
    print(model_params.ToText())
    return 0

  if args.mode == "inspect_model":
    from lingvo_tpu_torch.core import summary_utils
    # the shapes need no storage: the weights live on the meta device
    task = model_params.task.Instantiate(device="meta")
    task.FinalizePaths()
    print("\n".join(summary_utils.ModelAnalysis(task)))
    return 0

  from lingvo_tpu_torch.core import checkpointer as checkpointer_lib

  if args.mode == "shell":
    import numpy as np
    import torch
    from lingvo_tpu_torch.runners import executor as executor_lib
    task = model_params.task.Instantiate(device=args.device)
    task.FinalizePaths()
    state = task.CreateTrainState(
        torch.Generator("cpu").manual_seed(executor_lib.INIT_SEED))
    ckpt = checkpointer_lib.Checkpointer(os.path.join(args.logdir, "train"))
    state, step = ckpt.Restore(task, state=state)
    ckpt.Close()
    ns = dict(task=task, state=state, model_params=model_params,
              torch=torch, np=np)
    banner = (f"lingvo_tpu_torch shell: `task` ({type(task).__name__}), "
              f"`state` (step {step}), `model_params`, torch/np loaded")
    try:
      import IPython
      IPython.start_ipython(argv=[], user_ns=ns, display_banner=False)
    except ImportError:
      import code
      code.interact(banner=banner, local=ns)
    return 0

  schedule, task = _BuildSchedule(model_params, args)
  if args.mode == "train":
    from lingvo_tpu_torch.runners import executor as executor_lib
    execu = executor_lib.ExecutorTpu(model_params, args.logdir,
                                     schedule=schedule, task=task,
                                     mlperf_benchmark=args.mlperf_benchmark)
    execu.Start()
    return 0
  # eval / decode: follower jobs never construct an executor; the trainer
  # owns trainer_params.txt, model_analysis.txt and the saves
  progs = [pr for pr in schedule.programs
           if (args.mode == "eval" and "eval" in pr.p.name) or
           (args.mode == "decode" and "decode" in pr.p.name)]
  from lingvo_tpu_torch.runners import base_runner
  if args.job in ("evaler", "decoder"):
    base_runner.CheckpointPollingRunner(
        task, progs, os.path.join(args.logdir, "train"),
        poll_interval_secs=args.poll_interval_secs,
        timeout_secs=args.poll_timeout_secs).Run()
    return 0
  import torch
  from lingvo_tpu_torch.runners import executor as executor_lib
  # the whole train state, so that an eval program reads the EMA
  state = task.CreateTrainState(
      torch.Generator("cpu").manual_seed(executor_lib.INIT_SEED))
  ckpt = checkpointer_lib.Checkpointer(os.path.join(args.logdir, "train"))
  state, step = ckpt.Restore(task, state=state)
  ckpt.Close()
  for prog in progs:
    _, results = prog.Run(state)
    prog.Shutdown()
    print(f"[{prog.p.name}] step={step} {results}")
  return 0


if __name__ == "__main__":
  sys.exit(main())
