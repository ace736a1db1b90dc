"""Build and load the hand-written CUDA kernels (``gigaam_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first use
by ``nvcc`` for ``sm_90a`` into ``gigaam_tpu_torch/_build/lib<name>.so``,
then loaded with ``ctypes``.  Nothing here runs at import: this module is
imported on hosts without a card or a CUDA toolkit, where only the kernels'
plain versions run.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points of each source and their argument types; every entry
# returns the cudaGetLastError() code after its launch
SIGNATURES: Dict[str, Dict[str, List]] = {
    "attention": {
        "gigaam_sdpa": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    },
    "projection": {
        "gigaam_qkv_proj": [_P] * 14 + [_I] * 4 + [_P],
        "gigaam_out_proj": [_P] * 5 + [_I] * 4 + [_P],
    },
    "relpos_attention": {
        "gigaam_relpos_sdpa": [_P] * 7 + [_I] * 3 + [_F, _P],
    },
    "attention_bwd": {
        "gigaam_sdpa_bwd": [_P] * 9 + [_I] * 3 + [_F, _P],
    },
    "relpos_attention_bwd": {
        "gigaam_relpos_sdpa_bwd": [_P] * 13 + [_I] * 3 + [_F, _P],
    },
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _paths(name: str):
    return (os.path.join(CSRC_DIR, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, so = _paths(name)
    return not os.path.exists(so) or os.path.getmtime(src) > os.path.getmtime(so)


def build(names: Iterable[str] = tuple(SIGNATURES), verbose: bool = False
          ) -> float:
    """Compile every stale source in ``names``, one ``nvcc`` process each,
    all started together.  Returns the wall seconds spent; raises with the
    compiler's output if any build fails.  ``verbose`` adds ``-Xptxas -v``
    and prints what the compiler reports (registers, shared memory, spills).
    """
    todo = [n for n in names if _stale(n)]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        src, so = _paths(name)
        tmp = f"{so}.{os.getpid()}.tmp"
        procs.append((name, so, tmp, subprocess.Popen(
            [nvcc, *flags, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        out, _ = proc.communicate()
        if verbose and out:
            print(f"[nvcc {name}]\n{out}", flush=True)
        if proc.returncode == 0:
            os.replace(tmp, so)
        else:
            failed.append(f"{name}.cu:\n{out}")
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if missing or stale."""
    build([name])
    lib = ctypes.CDLL(_paths(name)[1])
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {rc}")
