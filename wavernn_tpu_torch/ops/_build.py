"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``wavernn_tpu_torch/_build/``, named
by the hash of its source, and is loaded with ``ctypes``. A source builds
once, at its first CUDA use; ``build_all`` starts one ``nvcc`` per source
at once. Nothing here runs at import time: the CPU-only install imports
this module without a toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("sample_loop_fused", "sample_loop_resident", "taco_decode",
           "taco_decode_resident", "gru_seq", "gru_resident", "taco_train",
           "taco_train_resident", "taco_tf_resident")
# sources a source includes: its library rebuilds when they change
INCLUDES = {"taco_train_resident": ("taco_train",),
            "taco_tf_resident": ("taco_train_resident", "taco_train"),
            "taco_decode_resident": ("taco_train_resident", "taco_train")}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    text = b"".join((CSRC / f"{n}.cu").read_bytes()
                    for n in (name,) + INCLUDES.get(name, ()))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str):
    """Start nvcc for one source; returns (Popen, tmp, final) or None when
    the library for this source hash is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    return log


def build_all() -> Dict[str, str]:
    """Compile every kernel source in parallel; returns nvcc's output
    (registers, shared memory, spills) per source that was built."""
    jobs = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, job) for name, job in jobs.items()
            if job is not None}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


_prepared: Dict[str, tuple] = {}


def prepared(name: str, sources: dict, key, make):
    """``make()``, the kernel's operands derived from the weight tensors
    ``sources``, computed once and reused while every source is the same
    storage at the same version and ``key`` is unchanged. An in-place update
    (``load_state_dict``, an optimizer step) bumps a tensor's version, so it
    prepares anew. One entry per kernel ``name``; the entry holds its
    sources, so their storage cannot be reused under it."""
    sig = (key,) + tuple((k, v.device, v.data_ptr(), v._version,
                          tuple(v.shape), v.dtype)
                         for k, v in sources.items())
    hit = _prepared.get(name)
    if hit is None or hit[0] != sig:
        hit = (sig, tuple(sources.values()), make())
        _prepared[name] = hit
    return hit[2]


def check_operand(t, name: str, dtype, shape, device) -> None:
    """Raise unless a kernel operand has the device, dtype, shape and
    contiguity the kernel reads it with."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
