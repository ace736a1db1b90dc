"""Build and load the hand-written CUDA kernels (``gigaam_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface (``csrc/*.cuh`` are headers
they share) and is compiled at first use
by ``nvcc`` for ``sm_90a`` into ``gigaam_tpu_torch/_build/lib<name>.so``,
then loaded with ``ctypes``.  Nothing here runs at import: this module is
imported on hosts without a card or a CUDA toolkit, where only the kernels'
plain versions run.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
import shutil
import subprocess
import time
from typing import Dict, Iterable, List, Optional

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
        "gigaam_sdpa": [_P] * 6 + [_I] * 3 + [_F, _P],
    },
    "projection": {
        "gigaam_qkv_proj": [_P] * 14 + [_I] * 4 + [_P],
        "gigaam_out_proj": [_P] * 5 + [_I] * 4 + [_P],
    },
    "relpos_attention": {
        "gigaam_relpos_sdpa": [_P] * 8 + [_I] * 3 + [_F, _P],
        "gigaam_relpos_sdpa_occupancy": [_P],
    },
    "attention_bwd": {
        "gigaam_sdpa_bwd": [_P] * 11 + [_I] * 3 + [_F, _P],
    },
    "relpos_attention_bwd": {
        "gigaam_relpos_sdpa_bwd": [_P] * 15 + [_I] * 3 + [_F, _P],
        "gigaam_relpos_sdpa_bwd_occupancy": [_P],
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
    """Whether ``lib<name>.so`` is missing or older than its source or any
    shared header (``csrc/*.cuh``)."""
    src, so = _paths(name)
    if not os.path.exists(so):
        return True
    headers = [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
               if f.endswith(".cuh")]
    return max(map(os.path.getmtime, [src, *headers])) > os.path.getmtime(so)


def build(names: Iterable[str] = tuple(SIGNATURES), verbose: bool = False,
          logs: Optional[List[str]] = None) -> float:
    """Compile every stale source in ``names``, one ``nvcc`` process each,
    all started together.  Returns the wall seconds spent; raises with the
    compiler's output if any build fails.  ``verbose`` adds ``-Xptxas -v``
    and prints what the compiler reports (registers, shared memory, spills);
    each compiler's output is also appended to ``logs`` when given, for
    ``kernel_resources``.
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
        if logs is not None:
            logs.append(out)
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


def kernel_resources(log: str) -> Dict[str, Dict[str, int]]:
    """Per ``__global__`` function in the output of a verbose build:
    registers, spill bytes (stores + loads) and static shared memory, as
    ptxas reports them."""
    out: Dict[str, Dict[str, int]] = {}
    entry = re.compile(
        r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, "
        r"(\d+) bytes spill loads.*?Used (\d+) registers(?:[^\n]*?"
        r"(\d+) bytes smem)?", re.S)
    for mangled, st, ld, regs, smem in entry.findall(log):
        # ..._<file>_cu_<hash><len><name>[I<template arguments>E]E...: the
        # kernels' names are lower-case words ending in _kernel
        name = re.search(r"([a-z][a-z_]*_kernel)(?:I(\w+?)E)?E", mangled)
        key = mangled if not name else name.group(1) + {
            None: "", "Lb0": "<false>", "Lb1": "<true>"}.get(
                name.group(2), f"<{name.group(2)}>")
        out[key] = {
            "registers": int(regs), "spill_bytes": int(st) + int(ld),
            "static_smem_bytes": int(smem or 0)}
    return out


def dynamic_resources() -> Dict[str, Dict[str, int]]:
    """Per kernel that sizes its shared memory at launch (the rel-pos
    kernels): the dynamic shared memory in bytes and how many blocks one SM
    holds at a time, as the CUDA runtime reports them for the current card."""
    out: Dict[str, Dict[str, int]] = {}
    for name, fn, kernels in (
            ("relpos_attention", "gigaam_relpos_sdpa_occupancy",
             ("relpos_sdpa_kernel",)),
            ("relpos_attention_bwd", "gigaam_relpos_sdpa_bwd_occupancy",
             ("relpos_bwd_dq_kernel", "relpos_bwd_dkv_kernel"))):
        pairs = (ctypes.c_int * (2 * len(kernels)))()
        check(getattr(library(name), fn)(pairs), fn)
        for i, kernel in enumerate(kernels):
            out[kernel] = {"dynamic_smem_bytes": pairs[2 * i],
                           "blocks_per_sm": pairs[2 * i + 1]}
    return out


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
