"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, in ``_build/`` beside this file (a
directory git ignores). The library's name carries a hash of its source and
flags, so an edited source is rebuilt and an unchanged one is reused. Nothing
is built when a module is imported: only the first launch on a CUDA tensor
asks for a library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

# -fmad=false: no mul+add contraction, so each kernel rounds exactly where its
# plain PyTorch version does (no --use_fast_math either)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

_LOADED: dict = {}
BUILD_LOG: dict = {}   # source name -> {"seconds", "ptxas"} of builds done here


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def library_path(source: str) -> str:
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless its library exists; return its path.
    The library is written under a temporary name and renamed, so a
    concurrent or interrupted build never leaves a partial file behind."""
    out = library_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {source} "
                           f"(exit {res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[source] = {"seconds": time.perf_counter() - t0,
                         "ptxas": res.stderr.strip()}
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built if needed."""
    if source not in _LOADED:
        _LOADED[source] = ctypes.CDLL(build(source))
    return _LOADED[source]
