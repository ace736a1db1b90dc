"""Whether a change left kernels' machine code as it was.

Each source is compiled for sm_90a to a cubin from the ``csrc`` directory
of this checkout and of another one (``OLD``, for example the parent
commit unpacked by ``git archive <commit> | tar -x -C OLD``), all ``nvcc``
processes started together; ``cuobjdump -sass`` disassembles both, and
each kernel's instructions are compared with the addresses and encodings
dropped.  Kernels are named as ``cuda_lib.kernel_resources`` names them.

On a machine with the CUDA toolkit (``nvcc`` and ``cuobjdump``):

    python3 -m gigaam_tpu_torch.tools.sass_compare OLD [SOURCE ...]

SOURCE: the ``csrc`` stems to compare; by default those of the kernels
whose registers ``chip_smoke.py`` keeps (``attention``, ``subsampling_ws``,
``ffn_ws``, ``sdpa_groups_ws``), the attention-fold redesign's
(``attn_fold_ws``: P6's and P7's kernels and the packed walk), P5's and
P8's (``conv_fold_ws``, ``attn_lnres_ws``), the SDPA ablation's kept
kernels (``sdpa_ablation``), the per-head walk's instances of P12 and P10
(``sdpa_heads_ws``) and the subsampling probes' kept kernels, P3's among
them (``subsampling_probe``).  Prints a line per kernel and, last, one
JSON object ``{source: {kernel: {"identical": bool, "old_instructions": n,
"new_instructions": n}}}``; exits 1 if a kernel of OLD differs here or is
missing here.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from typing import Dict, List

from ..ops import cuda_lib

SOURCES = ("attention", "subsampling_ws", "ffn_ws", "sdpa_groups_ws",
           "attn_fold_ws", "conv_fold_ws", "attn_lnres_ws", "sdpa_ablation",
           "sdpa_heads_ws", "subsampling_probe")
# the build's flags for device code, to a cubin instead of a library
CUBIN_FLAGS = [f for f in cuda_lib.NVCC_FLAGS
               if f not in ("-shared", "-Xcompiler", "-fPIC")] + ["-cubin"]


def sass_functions(dump: str) -> Dict[str, List[str]]:
    """{kernel: its instructions} of ``cuobjdump -sass`` output, each
    instruction without its address (``/*0a30*/``) and encoding (``/*
    0x... */``) comments."""
    out: Dict[str, List[str]] = {}
    body = None
    for line in dump.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            body = out.setdefault(cuda_lib.kernel_name(head.group(1)), [])
            continue
        text = re.sub(r"/\*\s*(?:[0-9a-f]{4,}|0x[0-9a-f]+)\s*\*/", "",
                      line).strip()
        if body is not None and text:
            body.append(text)
    return out


def compare(old: Dict[str, List[str]], new: Dict[str, List[str]]) -> dict:
    """{kernel of ``old``: identical, and the instruction counts}; a kernel
    missing from ``new`` has 0 there and is not identical."""
    return {k: {"identical": new.get(k) == ins,
                "old_instructions": len(ins),
                "new_instructions": len(new.get(k, ()))}
            for k, ins in sorted(old.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", help="the root of the other checkout")
    ap.add_argument("sources", nargs="*", default=list(SOURCES))
    args = ap.parse_args(argv)
    nvcc = cuda_lib._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    dirs = {"old": os.path.join(args.old, "gigaam_tpu_torch", "csrc"),
            "new": cuda_lib.CSRC_DIR}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {(side, src): subprocess.Popen(
            [nvcc, *CUBIN_FLAGS, "-o", os.path.join(tmp, f"{side}_{src}"),
             os.path.join(dirs[side], f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in args.sources for side in dirs}
        sass = {}
        for (side, src), proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {side} {src}.cu:\n{log}")
            sass[side, src] = sass_functions(subprocess.run(
                [cuobjdump, "-sass", os.path.join(tmp, f"{side}_{src}")],
                capture_output=True, text=True, check=True).stdout)
    empty = [key for key, funcs in sass.items() if not funcs]
    if empty:
        raise RuntimeError(f"cuobjdump listed no kernel of {empty}")
    result = {src: compare(sass["old", src], sass["new", src])
              for src in args.sources}
    for src, kernels in result.items():
        for k, r in kernels.items():
            print(f"{src}: {k}: identical {r['identical']} "
                  f"({r['old_instructions']} -> {r['new_instructions']} "
                  "instructions)", flush=True)
    print(json.dumps(result), flush=True)
    return 0 if all(r["identical"] for kernels in result.values()
                    for r in kernels.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
