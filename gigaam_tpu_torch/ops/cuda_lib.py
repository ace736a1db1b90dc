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
        "gigaam_ln_rope": [_P] * 7 + [_I] * 3 + [_P],
        "gigaam_qkv_proj": [_P] * 11 + [_I] * 4 + [_P],
        "gigaam_out_proj": [_P] * 5 + [_I] * 4 + [_P],
        "gigaam_projection_occupancy": [_P],
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
    "sdpa_ablation": {
        "gigaam_sdpa_ablation": [_P] * 5 + [_I] * 6 + [_F, _P],
    },
    "sdpa_groups_ws": {
        "gigaam_sdpa_groups_ws": [_P] * 6 + [_I] * 4 + [_F, _P],
        "gigaam_sdpa_groups_ws_occupancy": [_P],
    },
    "sdpa_heads_ws": {
        "gigaam_sdpa_heads_ws": [_P] * 6 + [_I] * 6 + [_F, _P],
        "gigaam_sdpa_heads_ws_occupancy": [_P],
    },
    "sdpa_packed_heads_ws": {
        "gigaam_sdpa_packed_heads_ws": [_P] * 6 + [_I] * 5 + [_F, _P],
        "gigaam_sdpa_packed_heads_ws_occupancy": [_P],
    },
    "attn_fold_ws": {
        "gigaam_fold_ws_qkv": [_P] * 12 + [_I] * 5 + [_P],
        "gigaam_fold_ws_out": [_P] * 5 + [_I] * 4 + [_P],
        "gigaam_fold_ws_sdpa": [_P] * 6 + [_I] * 4 + [_F, _P],
        "gigaam_fold_ws_slots": [_I, _P],
        "gigaam_attn_fold_ws_occupancy": [_P],
    },
    "attn_lnres_ws": {
        "gigaam_lnres_ws_out": [_P] * 6 + [_I] * 4 + [_P],
        "gigaam_attn_lnres_ws_occupancy": [_P],
    },
    "conv_fold_ws": {
        "gigaam_conv_ws_product": [_P] * 8 + [_I] * 4 + [_P],
        "gigaam_conv_ws_depthwise": [_P] * 5 + [_I] * 2 + [_P],
        "gigaam_conv_ws_slots": [_P],
        "gigaam_conv_fold_ws_occupancy": [_P],
    },
    "fold_probes": {
        "gigaam_ffn_fold": [_P] * 8 + [_I, _P],
        "gigaam_conv_fold": [_P] * 15 + [_I] * 2 + [_P],
        "gigaam_fold_probes_occupancy": [_P],
    },
    "attn_fold_probe": {
        "gigaam_probe_qkv": [_P] * 11 + [_I] * 5 + [_P],
        "gigaam_probe_qkv_heads": [_P] * 11 + [_I] * 4 + [_P],
        "gigaam_probe_out_proj": [_P] * 5 + [_I] * 5 + [_P],
        "gigaam_attn_fold_probe_occupancy": [_P],
    },
    "subsampling_probe": {
        "gigaam_taps": [_P] * 8 + [_I] * 4 + [_P],
        "gigaam_im2col": [_P] * 6 + [_I] * 3 + [_P],
        "gigaam_probe_gemm": [_P] * 4 + [_I] * 5 + [_P],
        "gigaam_smem_probe": [_P, _P, _I, _P, _P],
        "gigaam_subsampling_probe_occupancy": [_P],
    },
    "smem_probe_ws": {
        "gigaam_smem_probe_ws": [_P, _P, _I, _P, _P],
        "gigaam_smem_probe_ws_empty": [_P],
    },
    "ffn_ws": {
        "gigaam_ffn_ws_rows": [_P] * 4 + [_I, _P],
        "gigaam_ffn_ws_product": [_P] * 7 + [_I] * 7 + [_P],
        "gigaam_ffn_ws_max_clusters": [_P],
        "gigaam_ffn_ws_occupancy": [_P],
    },
    "subsampling_ws": {
        "gigaam_ws_taps": [_P] * 9 + [_I] * 8 + [_P],
        "gigaam_ws_gemm": [_P] * 5 + [_I] * 8 + [_P],
        "gigaam_subsampling_ws_occupancy": [_P],
        "gigaam_ws_max_clusters": [_P],
    },
}


# the attention-fold redesign's kernels (csrc/attn_fold_ws.cu: the
# products of each schedule and the walk's packed instance), in the order of
# gigaam_attn_fold_ws_occupancy, named as kernel_resources names them
ATTN_FOLD_WS_KERNELS = (
    "fold_qkv_pp_kernel<256, 2, false>", "fold_qkv_pp_kernel<192, 1, true>",
    "fold_qkv_coop_kernel<1>", "fold_qkv_coop_kernel<2>",
    "fold_out_pp_kernel<256, 2>", "fold_out_pp_kernel<192, 1>",
    "fold_out_coop_kernel<1>", "fold_out_coop_kernel<2>",
    "sdpa_packed_ws_kernel")
# P8's output product (csrc/attn_lnres_ws.cu: the fp32-residual epilogue on
# P6's nb 1, 2 and 4 schedules) and P5's redesign (csrc/conv_fold_ws.cu: the
# GLU and residual products, the depthwise pass), in the order of their
# occupancy entries
ATTN_LNRES_WS_KERNELS = ("lnres_out_pp_kernel<256, 2>",
                         "lnres_out_coop_kernel<1>",
                         "lnres_out_coop_kernel<2>")
CONV_FOLD_WS_KERNELS = ("conv_fold_ws_kernel<1>", "conv_fold_ws_kernel<2>",
                        "conv_dw_kernel")
# the per-head walk's redesign of the SDPA ablation (P12's bodies but the
# copy, and P10; csrc/sdpa_heads_ws.cu: one instance an SdpaVariant), in the
# order of gigaam_sdpa_heads_ws_occupancy
HEADS_WS_KERNELS = tuple(f"sdpa_heads_ws_kernel<{v}>" for v in (0, 2, 3, 4, 5,
                                                                 6))
# P11's redesign: the per-head walk's packed instance
# (csrc/sdpa_packed_heads_ws.cu)
PACKED_HEADS_WS_KERNEL = "sdpa_packed_heads_ws_kernel"


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
          logs: Optional[List[str]] = None, force: bool = False) -> float:
    """Compile every stale source in ``names`` (every one with ``force``),
    one ``nvcc`` process each, all started together.  Returns the wall seconds spent; raises with the
    compiler's output if any build fails.  ``verbose`` adds ``-Xptxas -v``
    and prints what the compiler reports (registers, shared memory, spills);
    each compiler's output is also appended to ``logs`` when given, under a
    line ``[nvcc <name>]``, for ``kernel_resources``.
    """
    todo = [n for n in names if force or _stale(n)]
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
            logs.append(f"[nvcc {name}]\n{out}")
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
    ptxas reports them.  Where the log holds the reports of several
    libraries, each after its ``[nvcc <name>]`` line as ``build`` writes
    them, a kernel that an earlier library already reported (a template of
    a shared header that two sources instantiate) is named ``<kernel>
    (<name>)``."""
    out: Dict[str, Dict[str, int]] = {}
    entry = re.compile(
        r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, "
        r"(\d+) bytes spill loads.*?Used (\d+) registers(?:[^\n]*?"
        r"(\d+) bytes smem)?", re.S)
    parts = re.split(r"^\[nvcc (\w+)\]$", log, flags=re.M)
    for library, text in zip([None] + parts[1::2], parts[::2]):
        for mangled, st, ld, regs, smem in entry.findall(text):
            key = kernel_name(mangled)
            if key in out:
                key = f"{key} ({library})"
            out[key] = {
                "registers": int(regs), "spill_bytes": int(st) + int(ld),
                "static_smem_bytes": int(smem or 0)}
    return out


def kernel_name(mangled: str) -> str:
    """``ws_conv_kernel<128, 1, false>`` ... of a mangled kernel name
    (``..._<file>_cu_<hash><len><name>[I<template arguments>E]E...``: the
    kernels' names are lower-case words ending in _kernel; template
    arguments are bool (Lb0E, Lb1E) or int (Li<n>E) literals); the mangled
    name where it holds no such word."""
    name = re.search(r"([a-z][a-z_]*_kernel)(?:I(\w+?)E)?E", mangled)
    return mangled if not name else name.group(1) + _template_args(
        name.group(2))


def _template_args(args: Optional[str]) -> str:
    """``<true>``, ``<2, 128>`` ... from the mangled ``Lb1E``, ``Li2ELi128E``
    (given without the last ``E``); "" for no template."""
    if args is None:
        return ""
    lits = re.findall(r"L([bi])(\d+)E", args + "E")
    if "".join(f"L{k}{v}E" for k, v in lits) != args + "E":
        return f"<{args}>"
    return "<" + ", ".join({"b": lambda v: "true" if v == "1" else "false",
                            "i": lambda v: v}[k](v) for k, v in lits) + ">"


def dynamic_resources() -> Dict[str, Dict[str, int]]:
    """Per kernel that sizes its shared memory at launch (the rel-pos
    kernels, the projection GEMMs, one entry per tile configuration and
    epilogue (the third template argument: 0 no residual, 1 the residual
    added in bf16, 2 in fp32), the fold probes' kernels (and P4's
    redesign: its two products, 1 the SiLU epilogue, 2 the residual one),
    the head-group walk's redesign (P9), the per-head walk's (P10, P12)
    and its packed instance (P11),
    the attention-fold redesign's
    kernels (P6, P7, and P8's output product), P5's redesign, the
    subsampling
    probes' products (the TMA ring's and the warp-specialised redesign's
    four steps) and the attention-fold probes' GEMMs, named as
    ``kernel_resources`` names them):
    the dynamic shared memory in bytes and how many blocks one SM holds at
    a time, as the CUDA runtime reports them for the current card."""
    out: Dict[str, Dict[str, int]] = {}
    for name, fn, kernels in (
            ("relpos_attention", "gigaam_relpos_sdpa_occupancy",
             ("relpos_sdpa_kernel",)),
            ("relpos_attention_bwd", "gigaam_relpos_sdpa_bwd_occupancy",
             ("relpos_bwd_dq_kernel", "relpos_bwd_dkv_kernel")),
            ("projection", "gigaam_projection_occupancy",
             ("qkv_kernel<2, 128>", "qkv_kernel<1, 128>",
              "out_proj_kernel<2, 128, 1>", "out_proj_kernel<1, 64, 1>")),
            ("fold_probes", "gigaam_fold_probes_occupancy",
             ("ffn_fold_kernel", "glu_fold_kernel", "dw_proj_kernel")),
            ("ffn_ws", "gigaam_ffn_ws_occupancy",
             ("ffn_ws_kernel<1>", "ffn_ws_kernel<2>")),
            ("sdpa_groups_ws", "gigaam_sdpa_groups_ws_occupancy",
             ("sdpa_groups_ws_kernel",)),
            ("sdpa_heads_ws", "gigaam_sdpa_heads_ws_occupancy",
             HEADS_WS_KERNELS),
            ("sdpa_packed_heads_ws", "gigaam_sdpa_packed_heads_ws_occupancy",
             (PACKED_HEADS_WS_KERNEL,)),
            ("attn_fold_ws", "gigaam_attn_fold_ws_occupancy",
             ATTN_FOLD_WS_KERNELS),
            ("attn_lnres_ws", "gigaam_attn_lnres_ws_occupancy",
             ATTN_LNRES_WS_KERNELS),
            ("conv_fold_ws", "gigaam_conv_fold_ws_occupancy",
             CONV_FOLD_WS_KERNELS),
            ("subsampling_probe", "gigaam_subsampling_probe_occupancy",
             ("taps_kernel", "probe_gemm_kernel")),
            ("subsampling_ws", "gigaam_subsampling_ws_occupancy",
             ("ws_conv_kernel<256, 2, true>", "ws_conv_kernel<256, 1, true>",
              "ws_conv_kernel<128, 1, true>",
              "ws_conv_kernel<128, 1, false>")),
            ("attn_fold_probe", "gigaam_attn_fold_probe_occupancy",
             ("qkv_kernel<1, 128> (attn_fold_probe)",
              "qkv_kernel<2, 128> (attn_fold_probe)", "qkv_kernel<4, 128>",
              "qkv_head_kernel", "out_proj_kernel<1, 128, 0>",
              "out_proj_kernel<2, 128, 0> (attn_fold_probe)",
              "out_proj_kernel<4, 128, 0>", "out_proj_kernel<1, 128, 2>",
              "out_proj_kernel<2, 128, 2>", "out_proj_kernel<4, 128, 2>"))):
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
