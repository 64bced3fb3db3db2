"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each `ops/csrc/<name>.cu` source has a plain C interface and is compiled
on its own into a shared library for `sm_90a` (Hopper):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o <lib>.so <source>.cu

The build happens at first use, into `build/lingvo_tpu_torch/` under the
repository root, keyed by a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source or header rebuilds and
an unchanged one loads the library already there. The ptxas report (registers, shared memory, spills) is kept beside
each library as `<lib>.log`. Loads of different sources may run in
parallel threads (one nvcc each); loads of one source are serialized.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lingvo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_locks_lock = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}


def _Nvcc() -> str:
  nvcc = shutil.which("nvcc")
  if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
    nvcc = "/usr/local/cuda/bin/nvcc"
  if nvcc is None:
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
  return nvcc


def LibraryPath(name: str) -> Path:
  """Where `name`'s library lives: keyed by the hash of the source, the
  headers and the flags."""
  digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
  for header in sorted(CSRC_DIR.glob("*.cuh")):   # the sources' includes
    digest.update(header.read_bytes())
  digest.update(" ".join(NVCC_FLAGS).encode())
  return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def BuildLog(name: str) -> str:
  """nvcc/ptxas output of `name`'s current build ('' if not kept)."""
  log = LibraryPath(name).with_suffix(".log")
  return log.read_text() if log.exists() else ""


def Load(name: str) -> ctypes.CDLL:
  """`name`'s library, compiled first if it is missing; loaded once per
  process. Raises with nvcc's output if the compile fails."""
  with _locks_lock:
    lock = _locks.setdefault(name, threading.Lock())
  with lock:
    lib = _loaded.get(name)
    if lib is None:
      path = LibraryPath(name)
      if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        proc = subprocess.run(
            [_Nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
          raise RuntimeError(
              f"nvcc failed for {name} (rc {proc.returncode}):\n{proc.stdout}")
        path.with_suffix(".log").write_text(proc.stdout)
        os.replace(tmp, path)   # atomic: a concurrent loader never sees half a file
      lib = ctypes.CDLL(str(path))
      _loaded[name] = lib
    return lib
