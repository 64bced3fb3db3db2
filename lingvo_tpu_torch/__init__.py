"""lingvo_tpu_torch: the PyTorch + CUDA port of lingvo_tpu for NVIDIA Hopper.

The package mirrors `lingvo_tpu/`'s layout (`core/`, `ops/`, `models/lm/`,
`runners/`, `serving/`) so each module's reference is found at the same
path there. Ported so far: the continuous-batching serving step and the
training step (`runners/program.py` `TrainProgram`) of the DenseLm models.
It imports torch and numpy only: never jax, and nothing of `lingvo_tpu`.
Hand-written Hopper kernels live under `ops/csrc/` and are built with
`nvcc` on first use (`ops/cuda_build.py`).
"""
