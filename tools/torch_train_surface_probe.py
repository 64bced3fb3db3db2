#!/usr/bin/env python3
"""Runs `chip_smoke.py`'s phase 29 alone on one card, with a breakdown of its time.

    python3 tools/torch_train_surface_probe.py

Builds the flash-attention and fused-xent kernels, then runs
`chip_smoke._TrainSurfacePhase` (the distillation through trainer.main
and its resume, the multi-task schedule, the tiny twins) with timers
around the weights' draws, the checkpointer's snapshot, write and
restore, `torch.load`, the evals, the train steps, the train states'
construction, the executor's pruning and the tasks' construction (each
synchronized with the card, outermost calls only). Prints the phase's
wall and each timer's sum, then the checkpoint I/O options on this
machine for 2 GiB of float32: `.cpu()` against pinned copies,
`torch.save` with and without its CRC32, and `torch.load` with and
without `mmap` followed by the copy to the card. Needs one CUDA card and
imports no JAX. Run from the repository's root.
"""
import collections, concurrent.futures, functools, os, sys, tempfile, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from lingvo_tpu_torch.ops import cuda_build
from lingvo_tpu_torch.ops import (ragged_block_attend as rba, ssd_scan as ssd,
    flash_attention as fa, fused_xent as fx, block_decode as bd,
    flash_decode as fd, int8_matmul as im, sample_tokens as st)
from lingvo_tpu_torch.models.lm.params import synthetic_packed_input as spi
from lingvo_tpu_torch.core import base_layer, base_model, checkpointer
from lingvo_tpu_torch.core import summary_utils
from lingvo_tpu_torch.runners import executor, program
t0 = time.perf_counter()
with concurrent.futures.ThreadPoolExecutor(2) as pool:
  list(pool.map(cuda_build.Load, ("flash_attention", "fused_xent")))
print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
counters = cs._MakeCounts(rba, ssd, fa, fx, bd, fd, im, st)
T = collections.defaultdict(float)
N = collections.Counter()
depth = [0]

def timed(obj, name, label):
  fn = getattr(obj, name)
  @functools.wraps(fn)
  def w(*a, **k):
    if depth[0]:
      return fn(*a, **k)
    depth[0] += 1
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
      return fn(*a, **k)
    finally:
      torch.cuda.synchronize()
      T[label] += time.perf_counter() - t
      N[label] += 1
      depth[0] -= 1
  setattr(obj, name, w)

for obj, name in ((base_layer.BaseLayer, "InstantiateVariables"),
                  (checkpointer.Checkpointer, "_Snapshot"),
                  (checkpointer.Checkpointer, "_Write"),
                  (checkpointer.Checkpointer, "Restore"),
                  (program.EvalProgram, "Run"),
                  (base_model.BaseTask, "TrainStep"),
                  (base_model.BaseTask, "CreateTrainState"),
                  (executor.ExecutorTpu, "_MaybePrune"),
                  (executor.ExecutorTpu, "__init__"),
                  (program.MultiTaskProgramSchedule, "__init__"),
                  (base_model.BaseTask, "__init__")):
  timed(obj, name, f"{obj.__name__}.{name}")
lm = torch.load
def load(*a, **k):
  t = time.perf_counter(); out = lm(*a, **k); T["torch.load"] += time.perf_counter() - t; return out
torch.load = load
tp = time.perf_counter()
out = cs._TrainSurfacePhase(torch, spi, counters)
print(f"phase 29 total {time.perf_counter() - tp:.1f} s")
for k, v in sorted(T.items(), key=lambda kv: -kv[1]):
  print(f"  {k}: {v:.2f} s over {N[k]} calls")
print(out[1]["walls"], out[1]["refresh_ms"], out[1]["plain_ms"])
# the I/O options on this machine: 2 GiB of float32
x = {f"t{i}": torch.randn(64, 1 << 20, device="cuda") for i in range(8)}
with tempfile.TemporaryDirectory() as d:
  torch.cuda.synchronize(); t = time.perf_counter()
  h = {k: v.cpu() for k, v in x.items()}
  print(f"snapshot .cpu() 2 GiB: {time.perf_counter() - t:.2f} s")
  t = time.perf_counter()
  pin = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True) for k, v in x.items()}
  ta = time.perf_counter() - t
  for k in x: pin[k].copy_(x[k], non_blocking=True)
  torch.cuda.synchronize()
  print(f"pinned 2 GiB: alloc {ta:.2f} s, total {time.perf_counter() - t:.2f} s")
  for crc in (True, False, True, False):
    torch.serialization.set_crc32_options(crc)
    t = time.perf_counter(); torch.save(h, os.path.join(d, "a.pt"))
    print(f"torch.save 2 GiB crc={crc}: {time.perf_counter() - t:.2f} s")
  torch.serialization.set_crc32_options(True)
  for mm in (False, True, False, True):
    t = time.perf_counter()
    y = lm(os.path.join(d, "a.pt"), map_location="cpu", weights_only=True, mmap=mm)
    for k in x: x[k].copy_(y[k])
    torch.cuda.synchronize()
    print(f"load+copy to card 2 GiB mmap={mm}: {time.perf_counter() - t:.2f} s")
    del y
