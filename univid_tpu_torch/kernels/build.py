"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each source is compiled on first use into its own shared library with a
plain C interface (`nvcc -gencode arch=compute_90a,code=sm_90a -shared`);
the libraries land in `kernels/build/` (git-ignored), named by a hash of
the source, the shared headers (`csrc/*.cuh`) and the flags, so an edited
source or header is rebuilt and an unchanged one is reused. `build_all()`
starts one nvcc per source, all at once.
Nothing here runs at import time: CPU-only machines import the package
without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
SOURCES = {
    "flash_attention": "flash_attention.cu",
    "flash_attention_f32": "flash_attention_f32.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "flash_attention_f32_d128": "flash_attention_f32_d128.cu",
    "flash_attention_bwd_f32": "flash_attention_bwd_f32.cu",
    "flash_attention_int8": "flash_attention_int8.cu",
    "flash_attention_sm90": "flash_attention_sm90.cu",
    "flash_attention_causal_sm90": "flash_attention_causal_sm90.cu",
    "flash_attention_f32_tc": "flash_attention_f32_tc.cu",
    "flash_attention_bwd_sm90": "flash_attention_bwd_sm90.cu",
    "flash_attention_f32_sm90": "flash_attention_f32_sm90.cu",
    "flash_attention_int8_sm90": "flash_attention_int8_sm90.cu",
    "qk_prepass": "qk_prepass.cu",
    "mask_tiles_sm90": "mask_tiles_sm90.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOG: Dict[str, str] = {}  # name -> nvcc/ptxas output of this process's build
# each build at INFO (UNIVID_LOG_COMPILES=1 turns it on: core/debug.py)
_log = logging.getLogger(__name__)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in (SOURCES[name], *headers):
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build_all() -> Dict[str, float]:
    """Compile every source that has no current library, one nvcc process
    per source in parallel. Returns {name: seconds} of the builds run."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, src in SOURCES.items():
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    times = {}
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        _log.info("nvcc %s: %.1f s, exit %d", SOURCES[name], times[name],
                  proc.returncode)
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/SOURCES[name], building on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not os.path.exists(_lib_path(name)):
                build_all()
            lib = ctypes.CDLL(_lib_path(name))
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
