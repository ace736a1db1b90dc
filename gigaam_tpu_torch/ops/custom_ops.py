"""K1, K2 and the inference forwards of K3 and K5 as ``torch.library``
custom ops in the ``gigaam`` namespace.

A ctypes launch reads ``data_ptr()``, which neither ``torch.export`` mode
can trace.  Registered ops are opaque to both: an exported program keeps
each one as a single node, ``torch.export.save``/``load`` carry it by name,
and the loaded program calls back into the body registered here.  So the
inference wrappers of ``ops/fused_attention.py`` (``fused_mha`` and
``fused_relpos_mha`` when no gradient is recorded,
``folded_rotary_attention`` and ``folded_rotary_attention_lnres`` always)
call these ops, and one path serves eager and exported calls.

* ``gigaam::fused_mha`` (K3): q, k, v [B, H, T, 48], valid [B, T] bool.
* ``gigaam::fused_relpos_mha`` (K5): q_u, k, v, q_v [B, H, T, 48], p_heads
  [H, 2T-1, 48], valid.
* ``gigaam::folded_rotary_attention`` (K2): x [B, T, D] post-LN, cos/sin
  [T, 48] fp32, valid, then ``FoldedWeights``' wq, wk, wv, wo, bq, bk, bv,
  bo one by one, and n_heads.
* ``gigaam::folded_rotary_attention_lnres`` (K1): x pre-LN, as K2 with
  ln_scale and ln_bias after bo.

Each body is the wrapper's forward: for CPU tensors the plain version, for
CUDA tensors the hand-written kernel, whose launch it counts
(``<wrapper>.launches``); a build or launch error raises, it never yields to
the plain version.  Each op has a fake implementation (an empty tensor of
the output's shape), which is all that tracing sees.  Training keeps
``_FusedMHA``/``_FusedRelposMHA`` and the backward kernels K4/K6.

Importing this module registers the ops; ``fused_attention`` imports it,
and ``export.load_exported`` imports it before it loads a program.
"""

from __future__ import annotations

import torch

from . import fused_attention as fa

# defined with the low-level ``torch.library.Library`` API: a
# ``torch.library.custom_op`` adds an autograd wrapper and a check that the
# output aliases no input to every call, host time on each of the 16 calls
# of a batch-1 forward (PERF.md has the A/B); the wrappers never call these
# ops where a gradient is recorded
_LIB = torch.library.Library("gigaam", "DEF")
_FOLD_ARGS = ("Tensor x, Tensor cos, Tensor sin, Tensor valid, Tensor wq, "
              "Tensor wk, Tensor wv, Tensor wo, Tensor bq, Tensor bk, "
              "Tensor bv, Tensor bo")
_SCHEMAS = {
    "fused_mha": "(Tensor q, Tensor k, Tensor v, Tensor valid) -> Tensor",
    "fused_relpos_mha": "(Tensor q_u, Tensor k, Tensor v, Tensor q_v, "
                        "Tensor p_heads, Tensor valid) -> Tensor",
    "folded_rotary_attention": f"({_FOLD_ARGS}, int n_heads) -> Tensor",
    "folded_rotary_attention_lnres": f"({_FOLD_ARGS}, Tensor ln_scale, "
                                     f"Tensor ln_bias, int n_heads) -> Tensor",
}


def k3_fused_mha(q, k, v, valid):
    return fa._mha_forward(q, k, v, valid, False)[0]


def k5_fused_relpos_mha(q_u, k, v, q_v, p_heads, valid):
    return fa._relpos_forward(q_u, k, v, q_v, p_heads, valid, False)[0]


def k2_folded_rotary_attention(x, cos, sin, valid, wq, wk, wv, wo, bq, bk,
                               bv, bo, n_heads):
    w = fa.FoldedWeights(wq, wk, wv, wo, bq, bk, bv, bo, None, None)
    return fa._folded_forward(w, x, cos, sin, valid, n_heads, lnres=False)


def k1_folded_rotary_attention_lnres(x, cos, sin, valid, wq, wk, wv, wo, bq,
                                     bk, bv, bo, ln_scale, ln_bias, n_heads):
    w = fa.FoldedWeights(wq, wk, wv, wo, bq, bk, bv, bo, ln_scale, ln_bias)
    return fa._folded_forward(w, x, cos, sin, valid, n_heads, lnres=True)


def _output_like(first, *rest):
    """Each op's fake: an empty tensor like its first input."""
    return torch.empty_like(first)


for _name, _body in (("fused_mha", k3_fused_mha),
                     ("fused_relpos_mha", k5_fused_relpos_mha),
                     ("folded_rotary_attention", k2_folded_rotary_attention),
                     ("folded_rotary_attention_lnres",
                      k1_folded_rotary_attention_lnres)):
    _LIB.define(_name + _SCHEMAS[_name])
    for _key in ("CPU", "CUDA"):
        _LIB.impl(_name, _body, _key)
    torch.library.register_fake(f"gigaam::{_name}", _output_like, lib=_LIB)
