"""The attention-fold probes on the card (P6, P7, P8).

Counterpart of ``benchmarks/pallas_attn_fold_probe.py`` (P6, P7) and
``benchmarks/pallas_attn_lnres_probe.py`` (P8).  Each folds the rotary
attention module into one Pallas kernel on the TPU; on Hopper each is, like
K1/K2 (``ops/fused_attention.py``), four launches: the row pass, a Q/K/V
GEMM, K3's SDPA core and an output GEMM, with the GEMMs as variants of
K1/K2's (``csrc/attn_fold_probe.cu`` on ``csrc/projection.cuh``):

  P7 foldB  folded_attention(..., per_head_weights=False)
            ``fold_lane_slices``: N-128 column tiles that straddle heads,
            pinned to 64-row tiles
  P7 foldA  folded_attention(..., per_head_weights=True)
            ``fold_heads``: one block a head's q or k, N-48 products with
            the per-head weight blocks (v on the N-128 path)
  P6        folded_attention_nb(..., nb)
            ``fold_nb``: 64 nb-row tiles, nb warpgroups a block
  P8        lnres_folded(ln_params, ..., nb)
            ``fold_lnres``: K1's function (pre-LN x to x + attention(LN(x)))
            with the residual added to the fp32 accumulator and rounded once

P6 and P7 compute K2's function (post-LN x to the module output, ``bo``
included); nb and the weight layout change the tiles, not the math.  Each
runner times the probes against the stock paths:

  baseline  the script's: the port's composed ``rotary_mha(...,
            use_fused=True)`` for P6/P7, ``x + folded_rotary_attention(LN(x))``
            (K2 after the LayerNorm) for P8;
  K2, K1    the port's own kernels at the same shape;
  lean      the fewest stock calls: one ``F.linear`` for Q and K on the
            rotated x and one for V on x (the [2304, 768] product split by
            its inputs), RoPE as elementwise ops, ``F.scaled_dot_product_
            attention`` with a boolean key mask, one ``F.linear`` out (and
            ``F.layer_norm`` and the add for P8).

On a card,

    python3 -m gigaam_tpu_torch.probes.attn_fold_probes

prints a line per shape and, last, one JSON object ``{"fold": {"b8_t512":
{...}, ...}, "lnres": {...}}``: under each shape the scripts' keys
(``baseline_us``, ``foldB_laneslice_us``/``_maxrel``, ``foldC_nb2_us``/
``_maxrel`` and ``foldC_nb4_us``/``_maxrel`` where nb divides B; ``maxrel``,
``foldLN_us``, ``delta_pct``) and ``foldA_us``/``_maxrel``, ``K2_us``,
``lean_us`` and, for P8, ``K1_us`` and ``k1_residual_diff``.  Times are
microseconds per call from ``gigaam_tpu_torch.profiling.device_timeit`` (40
calls replayed as a CUDA graph, as the scripts call theirs 40 times a run).
A failure raises; the scripts record it and go on.

The weights are prepared once (``prepare_fold``: the scripts' casts and
their 1/sqrt(48) fold of Wq and bq, foldA's per-head blocks), and the timed
call is the kernel wrapper's.  Beside the wrappers are the plain versions
of the Pallas bodies (``fold_plain``, ``lnres_plain``), rounding where the
bodies round.  A wrapper takes its plain version for tensors on the CPU;
for CUDA tensors it launches its kernels or raises.  ``<wrapper>.launches``
counts the calls that launched.  Only the tests and ``chip_smoke.py`` call
the plain versions on the card.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cuda_lib
from ..ops import fused_attention as fa
from ..ops.attention import rotary_mha
from ..ops.conformer_ops import layer_norm
from ..ops.fused_attention import _check_tensor, _require, _stream
from ..ops.rotary import rotary_tables
from ..profiling import device_timeit
from ..weights import sub_block_from_jax
from .fold_probes import tree_to

D, H = 768, 16
DH = D // H
EPS = 1e-5
ROPE_BASE = 5000.0
# (B, T) of the fold script's main; (B, T, nb) of the lnres script's
FOLD_SHAPES = ((8, 512), (32, 512), (16, 768), (128, 768))
LNRES_SHAPES = ((8, 512, 1), (32, 512, 1), (128, 768, 4))
NB_TILES = (1, 2, 4)   # the card's GEMMs take row tiles of 64 nb
CALLS = 40             # calls a timed run, as the scripts' device_timeit(k=40)


# ---------------------------------------------------------------------------
# The scripts' tables and draws
# ---------------------------------------------------------------------------

def rope_tables_wide(cos: np.ndarray, sin: np.ndarray):
    """Tile per-head cos/sin [T, 48] to the flat-lane layout [T, 768] and
    build the rotate-half permutation matrix R [D, D] (per 48-lane head
    group: rot(x) = [-x2; x1], same convention as ``ops/rotary.py``)."""
    cos_w = np.tile(np.asarray(cos), (1, H)).astype(np.float32)  # [T, 768]
    sin_w = np.tile(np.asarray(sin), (1, H)).astype(np.float32)
    r = np.zeros((D, D), np.float32)
    half = DH // 2
    for h in range(H):
        o = h * DH
        for i in range(half):
            r[o + half + i, o + i] = -1.0               # rot[i] = -x[i+half]
            r[o + i, o + half + i] = 1.0                # rot[i+half] = x[i]
    return cos_w, sin_w, r


def make_params(rng) -> dict:
    """The fold script's attention weights (JAX layout: [in, out] numpy
    float32), drawn from ``rng`` in its order and scales."""
    def lin():
        return {"w": np.asarray(0.03 * rng.standard_normal((D, D)),
                                np.float32),
                "b": np.asarray(0.01 * rng.standard_normal((D,)), np.float32)}

    return {name: lin() for name in
            ("linear_q", "linear_k", "linear_v", "linear_out")}


def ragged_valid(b: int, t: int) -> np.ndarray:
    """The scripts' lengths: row 0 full, the others t - 77."""
    lens = np.full((b,), t)
    lens[1:] = max(1, t - 77)
    return np.arange(t)[None, :] < lens[:, None]


def fold_inputs(b: int, t: int):
    """P6/P7's inputs as the script draws them (``default_rng(0)``): (params,
    x float64 [B, T, D], valid [B, T])."""
    rng = np.random.default_rng(0)
    params = make_params(rng)
    return params, 0.5 * rng.standard_normal((b, t, D)), ragged_valid(b, t)


def lnres_inputs(b: int, t: int):
    """P8's inputs as its script draws them: (ln_params, params, x, valid),
    each linear from its own ``default_rng(100 + i)``, then the LayerNorm
    and x from ``default_rng(0)``."""
    def lin(i):
        r2 = np.random.default_rng(100 + i)
        return {"w": np.asarray(0.05 * r2.standard_normal((D, D)), np.float32),
                "b": np.asarray(0.01 * r2.standard_normal((D,)), np.float32)}

    rng = np.random.default_rng(0)
    params = {"linear_q": lin(0), "linear_k": lin(1), "linear_v": lin(2),
              "linear_out": lin(3)}
    ln_p = {"scale": np.asarray(1.0 + 0.1 * rng.standard_normal(D),
                                np.float32),
            "bias": np.asarray(0.1 * rng.standard_normal(D), np.float32)}
    x = 0.5 * rng.standard_normal((b, t, D))
    return ln_p, params, x, ragged_valid(b, t)


# ---------------------------------------------------------------------------
# Weights, as the Pallas wrappers hand them to their kernels
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AttnFoldWeights:
    """A probe's prepared weights.  ``fold`` is K1/K2's set: Wq and bq
    scaled by 1/sqrt(48) in fp32 before the cast, the matrices [in, out] in
    the compute dtype, the biases fp32, and P8's LayerNorm scale and bias
    (ones and zeros, read by no kernel, for P6/P7).  ``cos``/``sin`` are the
    [T, 48] fp32 tables whose tiles are the scripts' ``cos_w``/``sin_w``.
    ``wq_heads``/``wk_heads`` are foldA's per-head blocks, laid out K-major
    once: [H, 48, D], the transposed weights (the script's [H, D, 48])."""

    fold: fa.FoldedWeights
    cos: torch.Tensor
    sin: torch.Tensor
    wq_heads: Optional[torch.Tensor] = None
    wk_heads: Optional[torch.Tensor] = None


def _heads_k_major(w: torch.Tensor) -> torch.Tensor:
    """[D, D] [in, out] -> the per-head blocks, K-major: [H, 48, D]."""
    return w.t().contiguous().reshape(H, DH, D)


def _heads_to_full(wh: torch.Tensor) -> torch.Tensor:
    """foldA's [H, 48, D] blocks back to the [D, D] [in, out] weight."""
    return wh.reshape(H * DH, D).t()


def prepare_fold(params: Mapping, cos_w: torch.Tensor, sin_w: torch.Tensor,
                 r: torch.Tensor, dtype: torch.dtype,
                 ln_params: Optional[Mapping] = None,
                 per_head_weights: bool = False,
                 divide: bool = False) -> AttnFoldWeights:
    """The port's attention parameters (``linear_q`` ... ``linear_out``,
    fp32), the scripts' RoPE tables and permutation, and for P8 the
    LayerNorm's, cast as the scripts cast them: 1/sqrt(48) folded into Wq
    and bq by a product (P6, P8) or, with ``divide``, by a division (P7).
    The kernels apply rotate-half by an index swap, so ``r`` must be the
    permutation of ``rope_tables_wide`` and ``cos_w``/``sin_w`` the tiles of
    one head's tables."""
    dev = cos_w.device
    _require(torch.equal(r.float(), torch.from_numpy(
        rope_tables_wide(np.zeros((1, DH)), np.zeros((1, DH)))[2]).to(r.device)),
        "r must be the rotate-half permutation (rope_tables_wide)")
    cos, sin = cos_w[:, :DH].float().contiguous(), sin_w[:, :DH].float().contiguous()
    _require(torch.equal(cos_w.float(), cos.repeat(1, H))
             and torch.equal(sin_w.float(), sin.repeat(1, H)),
             "cos_w and sin_w must tile one head's tables")
    ln = ln_params if ln_params is not None else {
        "scale": torch.ones(D, device=dev), "bias": torch.zeros(D, device=dev)}
    fold = fa.prepare_folded_weights(params, ln, H, dtype)
    if divide:
        root = math.sqrt(DH)
        fold = dataclasses.replace(
            fold, wq=(params["linear_q"]["w"].float() / root).to(dtype)
            .contiguous(),
            bq=(params["linear_q"]["b"].float() / root).contiguous())
    heads = ((_heads_k_major(fold.wq), _heads_k_major(fold.wk))
             if per_head_weights else (None, None))
    return AttnFoldWeights(fold, cos, sin, *heads)


# ---------------------------------------------------------------------------
# Plain versions of the Pallas bodies
# ---------------------------------------------------------------------------

def fold_plain(w: AttnFoldWeights, x: torch.Tensor, valid: torch.Tensor,
               heads: bool = False) -> torch.Tensor:
    """``_fold_kernel`` and ``_fold_kernel_nb``: K2's function, rounded
    where the bodies round (xr, q, k, v, P before P.V, oh / denom), the
    heads' output products summed in fp32; nb changes no value.  With
    ``heads`` q and k come from foldA's per-head blocks."""
    fold = w.fold
    if heads:
        fold = dataclasses.replace(fold, wq=_heads_to_full(w.wq_heads),
                                   wk=_heads_to_full(w.wk_heads))
    return fa.folded_rotary_attention_plain(fold, x, w.cos, w.sin, valid, H)


def lnres_plain(w: AttnFoldWeights, x: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """``_lnres_kernel``: LN(x) in fp32 rounded to x's dtype, then K2's
    function on it, with ``bo`` and x added to the fp32 accumulator and
    rounded once (K1 rounds the module output, then adds x in bf16)."""
    return fa._folded_plain(w.fold, x, w.cos, w.sin, valid, H, lnres=True,
                            fp32_residual=True)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _check_args(w: AttnFoldWeights, x: torch.Tensor, valid: torch.Tensor,
                nb: int, heads: bool, lnres: bool) -> None:
    """What the card path takes: x [B, T, 768] bf16 with B T >= 1, nb in
    NB_TILES dividing B, the [T, 48] fp32 tables, valid [B, T] bool, the
    weights' shapes and dtypes (foldA: its [16, 48, 768] blocks), every
    tensor contiguous and 16-byte aligned on x's device."""
    _require(x.dim() == 3 and x.shape[-1] == D and x.numel() > 0,
             f"x must be [B, T, {D}], got {tuple(x.shape)}")
    b, t, d = x.shape
    _require(nb in NB_TILES, f"the card's row tiles are 64 nb rows for nb "
             f"in {NB_TILES}, got nb {nb}")
    _require(b % nb == 0, f"nb {nb} does not divide B {b}")
    f = w.fold
    fa._check_row_args(x, w.cos, w.sin, H,
                       *((f.ln_scale, f.ln_bias) if lnres else ()))
    fa._check_fold_weights(f, d, x.device)
    _check_tensor("valid", valid, x.device, torch.bool, (b, t))
    if heads:
        for name in ("wq_heads", "wk_heads"):
            _require(getattr(w, name) is not None,
                     f"foldA needs {name}: prepare_fold(per_head_weights=True)")
            _check_tensor(name, getattr(w, name), x.device, x.dtype,
                          (H, DH, D))


def _fold_cuda(w: AttnFoldWeights, x: torch.Tensor, valid: torch.Tensor,
               nb: int, heads: bool = False, lnres: bool = False
               ) -> torch.Tensor:
    """Four launches: the row pass, a Q/K/V GEMM of the probe's library,
    the SDPA core and the probe's output GEMM.  Their scratch (xr, xn for
    P8, q, k, v and the SDPA output o, each [B*T, D] bf16) is one
    allocation, as in K1/K2's ``_folded_cuda``."""
    _check_args(w, x, valid, nb, heads, lnres)
    b, t, d = x.shape
    dev = x.device
    f = w.fold
    n = b * t * d
    scratch = torch.empty((6 if lnres else 5) * n, dtype=x.dtype, device=dev)
    xr, q, k, v, o, *xn = (scratch.data_ptr() + 2 * n * i
                           for i in range(scratch.numel() // n))
    xn = xn[0] if lnres else x.data_ptr()
    out = torch.empty_like(x)
    lib = cuda_lib.library("attn_fold_probe")
    stream = _stream(dev)
    biases = (f.bq.data_ptr(), f.bk.data_ptr(), f.bv.data_ptr())
    with torch.cuda.device(dev):
        fa._launch_ln_rope(x, w.cos, w.sin,
                           *((f.ln_scale, f.ln_bias) if lnres else (None, None)),
                           xn, xr, stream)
        if heads:
            cuda_lib.check(lib.gigaam_probe_qkv_heads(
                xr, xn, w.wq_heads.data_ptr(), w.wk_heads.data_ptr(),
                f.wv.data_ptr(), *biases, q, k, v, b, t, d, H, stream),
                "gigaam_probe_qkv_heads")
        else:
            cuda_lib.check(lib.gigaam_probe_qkv(
                xr, xn, f.wq.data_ptr(), f.wk.data_ptr(), f.wv.data_ptr(),
                *biases, q, k, v, b, t, d, H, nb, stream), "gigaam_probe_qkv")
        # wq carries the scale
        cuda_lib.check(cuda_lib.library("attention").gigaam_sdpa(
            q, k, v, valid.data_ptr(), o, None, b, H, t, 1.0, stream),
            "gigaam_sdpa")
        cuda_lib.check(lib.gigaam_probe_out_proj(
            o, f.wo.data_ptr(), f.bo.data_ptr(),
            x.data_ptr() if lnres else None, out.data_ptr(), b, t, d, H, nb,
            stream), "gigaam_probe_out_proj")
    return out


def _refuse_grad(name: str, w: AttnFoldWeights, x: torch.Tensor) -> None:
    fa._refuse_grad(name, (x, *fa._weight_tensors(w.fold)))


def fold_lane_slices(w: AttnFoldWeights, x: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """P7 foldB: post-LN x [B, T, 768] -> the module output, the Q/K/V GEMM
    on N-128 tiles that straddle heads, 64-row tiles throughout
    (``qkv_kernel<1, 128>``, ``out_proj_kernel<1, 128, 0>``); ``fold_plain``
    on the CPU."""
    _refuse_grad("fold_lane_slices", w, x)
    if x.device.type == "cpu":
        return fold_plain(w, x, valid)
    out = _fold_cuda(w, x, valid, 1)
    fold_lane_slices.launches += 1
    return out


def fold_heads(w: AttnFoldWeights, x: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """P7 foldA: as ``fold_lane_slices``, with q and k from the per-head
    blocks, one N-48 block a head (``qkv_head_kernel``)."""
    _refuse_grad("fold_heads", w, x)
    if x.device.type == "cpu":
        return fold_plain(w, x, valid, heads=True)
    out = _fold_cuda(w, x, valid, 1, heads=True)
    fold_heads.launches += 1
    return out


def fold_nb(w: AttnFoldWeights, x: torch.Tensor, valid: torch.Tensor,
            nb: int) -> torch.Tensor:
    """P6: as ``fold_lane_slices`` at 64 nb-row tiles, nb warpgroups a
    block (``qkv_kernel<nb, 128>``, ``out_proj_kernel<nb, 128, 0>``)."""
    _refuse_grad("fold_nb", w, x)
    if x.device.type == "cpu":
        return fold_plain(w, x, valid)
    out = _fold_cuda(w, x, valid, nb)
    fold_nb.launches += 1
    return out


def fold_lnres(w: AttnFoldWeights, x: torch.Tensor, valid: torch.Tensor,
               nb: int) -> torch.Tensor:
    """P8: pre-LN x [B, T, 768] -> x + attention(LN(x)) at 64 nb-row tiles,
    the residual added in fp32 (``out_proj_kernel<nb, 128, 2>``);
    ``lnres_plain`` on the CPU."""
    _refuse_grad("fold_lnres", w, x)
    if x.device.type == "cpu":
        return lnres_plain(w, x, valid)
    out = _fold_cuda(w, x, valid, nb, lnres=True)
    fold_lnres.launches += 1
    return out


KERNELS = (fold_nb, fold_heads, fold_lane_slices, fold_lnres)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


reset_launch_counts()


def folded_attention(x: torch.Tensor, params: Mapping, cos_w: torch.Tensor,
                     sin_w: torch.Tensor, r: torch.Tensor,
                     valid: torch.Tensor, per_head_weights: bool
                     ) -> torch.Tensor:
    """The script's P7 entry: foldA with ``per_head_weights``, else foldB."""
    w = prepare_fold(params, cos_w, sin_w, r, x.dtype,
                     per_head_weights=per_head_weights, divide=True)
    return (fold_heads if per_head_weights else fold_lane_slices)(w, x, valid)


def folded_attention_nb(x: torch.Tensor, params: Mapping,
                        cos_w: torch.Tensor, sin_w: torch.Tensor,
                        r: torch.Tensor, valid: torch.Tensor, nb: int
                        ) -> torch.Tensor:
    """The script's P6 entry; ``nb`` must divide B."""
    _require(x.shape[0] % nb == 0, f"nb {nb} does not divide B {x.shape[0]}")
    return fold_nb(prepare_fold(params, cos_w, sin_w, r, x.dtype), x, valid,
                   nb)


def lnres_folded(ln_params: Mapping, params: Mapping, x: torch.Tensor,
                 cos_w: torch.Tensor, sin_w: torch.Tensor, r: torch.Tensor,
                 valid: torch.Tensor, nb: int) -> torch.Tensor:
    """The lnres script's P8 entry; ``nb`` must divide B."""
    _require(x.shape[0] % nb == 0, f"nb {nb} does not divide B {x.shape[0]}")
    return fold_lnres(prepare_fold(params, cos_w, sin_w, r, x.dtype,
                                   ln_params=ln_params), x, valid, nb)


# ---------------------------------------------------------------------------
# The stock compositions
# ---------------------------------------------------------------------------

def baseline(params: Mapping, x: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """P6/P7's baseline: the port's composed path, ``F.linear`` projections
    around K3 (``rotary_mha(..., use_fused=True)``)."""
    return rotary_mha(params, x, cos, sin, valid, H, use_fused=True)


def lnres_baseline(w: AttnFoldWeights, ln_params: Mapping, x: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """P8's baseline: ``x + folded_rotary_attention(LN(x))``, the port's K2
    after the LayerNorm."""
    return x + fa.folded_rotary_attention(
        w.fold, layer_norm(ln_params, x), w.cos, w.sin, valid, H)


def lean_weights(params: Mapping, dtype: torch.dtype,
                 ln_params: Optional[Mapping] = None) -> dict:
    """The lean path's parameters in ``dtype``, the matrices [out, in] as
    ``F.linear`` takes them: Q and K as one [2 D, D] weight with Wq and bq
    scaled by 1/sqrt(48), V and the output [D, D]."""
    s = 1.0 / math.sqrt(DH)
    p = {name: {k: v.float() for k, v in params[name].items()}
         for name in ("linear_q", "linear_k", "linear_v", "linear_out")}
    lw = {"w_qk": torch.cat([p["linear_q"]["w"] * s, p["linear_k"]["w"]],
                            dim=1).t(),
          "b_qk": torch.cat([p["linear_q"]["b"] * s, p["linear_k"]["b"]]),
          "w_v": p["linear_v"]["w"].t(), "b_v": p["linear_v"]["b"],
          "w_o": p["linear_out"]["w"].t(), "b_o": p["linear_out"]["b"]}
    if ln_params is not None:
        lw.update(ln_g=ln_params["scale"], ln_b=ln_params["bias"])
    return {k: v.to(dtype).contiguous() for k, v in lw.items()}


def lean_tables(cos: torch.Tensor, sin: torch.Tensor, dtype: torch.dtype):
    """(cos_w, sin_w) [T, D] in ``dtype`` for the lean path's RoPE."""
    return cos.repeat(1, H).to(dtype), sin.repeat(1, H).to(dtype)


def fold_lean(lw: dict, x: torch.Tensor, cos_w: torch.Tensor,
              sin_w: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
    """(b) for P6/P7: RoPE as elementwise ops (``x cos_w + rotate_half(x)
    sin_w``), ``F.linear`` to Q and K on it and to V on x, ``F.scaled_dot_
    product_attention`` with the boolean key mask [B, 1, 1, T], ``F.linear``
    out."""
    b, t, d = x.shape
    xr = x * cos_w + fa._rotate_half_heads(x, H) * sin_w
    q, k = F.linear(xr, lw["w_qk"], lw["b_qk"]).split(d, dim=-1)
    v = F.linear(x, lw["w_v"], lw["b_v"])
    heads = lambda a: a.view(b, t, H, d // H).transpose(1, 2)
    o = F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                       attn_mask=key_mask, scale=1.0)
    return F.linear(o.transpose(1, 2).reshape(b, t, d), lw["w_o"], lw["b_o"])


def lnres_lean(lw: dict, x: torch.Tensor, cos_w: torch.Tensor,
               sin_w: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
    """(b) for P8: ``F.layer_norm``, ``fold_lean``, the residual add."""
    xn = F.layer_norm(x, (x.shape[-1],), lw["ln_g"], lw["ln_b"], EPS)
    return x + fold_lean(lw, xn, cos_w, sin_w, key_mask)


# ---------------------------------------------------------------------------
# The scripts' runners
# ---------------------------------------------------------------------------

def _tables(t: int, dev):
    """(cos, sin) [T, 48] fp32 and the scripts' (cos_w, sin_w, r bf16)."""
    cos_np, sin_np = rotary_tables(t, DH, ROPE_BASE)
    cos_w, sin_w, r = rope_tables_wide(cos_np, sin_np)
    return (torch.from_numpy(cos_np).to(dev), torch.from_numpy(sin_np).to(dev),
            torch.from_numpy(cos_w).to(dev), torch.from_numpy(sin_w).to(dev),
            torch.from_numpy(r).to(dev, torch.bfloat16))


def _us(fn, x) -> float:
    return round(device_timeit(fn, [x], k=CALLS) * 1e6, 1)


def _maxrel(got: torch.Tensor, want: torch.Tensor, tmin: int) -> float:
    """The scripts' check: max |got - want| / (|want| + 1) over the first
    tmin frames of every row (padded query rows are garbage by contract)."""
    got, want = got.float()[:, :tmin], want.float()[:, :tmin]
    return float(((got - want).abs() / (want.abs() + 1.0)).max())


def run(b: int, t: int, check: bool = True, device=None) -> dict:
    """One shape of the fold script's ``run``: the composed baseline, foldB,
    foldA, foldC at nb 2 and 4 where nb divides B, K2 and the lean path."""
    dev = torch.device("cuda" if device is None else device)
    bf = torch.bfloat16
    params_np, x_np, valid_np = fold_inputs(b, t)
    x = torch.from_numpy(x_np).to(dev, bf)
    valid = torch.from_numpy(valid_np).to(dev)
    p32 = tree_to(sub_block_from_jax(params_np), dev)
    p16 = tree_to(p32, dev, bf)
    cos, sin, cos_w, sin_w, r = _tables(t, dev)
    tmin = int(valid_np.sum(axis=1).min())

    res = {}
    base = lambda xx: baseline(p16, xx, cos, sin, valid)
    res["baseline_us"] = _us(base, x)
    print(f"b{b} t{t} baseline: {res['baseline_us']} us", flush=True)
    want = base(x)

    def check_and_time(name, got, fn):
        if check:
            res[f"{name}_maxrel"] = _maxrel(got, want, tmin)
        res[f"{name}_us"] = _us(fn, x)
        print(f"b{b} t{t} {name}: {res[f'{name}_us']} us (maxrel "
              f"{res.get(f'{name}_maxrel')})", flush=True)

    w7 = prepare_fold(p32, cos_w, sin_w, r, bf, per_head_weights=True,
                      divide=True)
    for name, heads, wrapper in (("foldB_laneslice", False, fold_lane_slices),
                                 ("foldA", True, fold_heads)):
        check_and_time(name, folded_attention(x, p32, cos_w, sin_w, r, valid,
                                              per_head_weights=heads),
                       lambda xx, f=wrapper: f(w7, xx, valid))
    w = prepare_fold(p32, cos_w, sin_w, r, bf)
    for nb in (2, 4):
        if b % nb == 0:
            check_and_time(
                f"foldC_nb{nb}",
                folded_attention_nb(x, p32, cos_w, sin_w, r, valid, nb),
                lambda xx, nb=nb: fold_nb(w, xx, valid, nb))
    res["K2_us"] = _us(lambda xx: fa.folded_rotary_attention(
        w.fold, xx, cos, sin, valid, H), x)
    lw = lean_weights(p32, bf)
    lcos, lsin = lean_tables(cos, sin, bf)
    mask = valid[:, None, None, :]
    res["lean_us"] = _us(lambda xx: fold_lean(lw, xx, lcos, lsin, mask), x)
    print(f"b{b} t{t} K2: {res['K2_us']} us, lean: {res['lean_us']} us",
          flush=True)
    return res


def run_lnres(b: int, t: int, nb: int, device=None) -> dict:
    """One shape of the lnres script's ``run``: P8 against its baseline
    (K2 after the LayerNorm), and K1, the lean path and P8's difference
    from K1 (``k1_residual_diff``: max |P8 - K1| on valid rows, and that in
    units of the RMS of P8's module term, out - x)."""
    dev = torch.device("cuda" if device is None else device)
    bf = torch.bfloat16
    ln_np, params_np, x_np, valid_np = lnres_inputs(b, t)
    x = torch.from_numpy(x_np).to(dev, bf)
    valid = torch.from_numpy(valid_np).to(dev)
    ln_p = tree_to(sub_block_from_jax(ln_np), dev)
    p32 = tree_to(sub_block_from_jax(params_np), dev)
    cos, sin, cos_w, sin_w, r = _tables(t, dev)
    tmin = int(valid_np.sum(axis=1).min())
    w = prepare_fold(p32, cos_w, sin_w, r, bf, ln_params=ln_p)

    res = {}
    base = lambda xx: lnres_baseline(w, ln_p, xx, valid)
    dt_b = device_timeit(base, [x], k=CALLS)
    res["baseline_us"] = round(dt_b * 1e6, 1)
    got = lnres_folded(ln_p, p32, x, cos_w, sin_w, r, valid, nb)
    res["maxrel"] = _maxrel(got, base(x), tmin)
    dt_f = device_timeit(lambda xx: fold_lnres(w, xx, valid, nb), [x],
                         k=CALLS)
    res["foldLN_us"] = round(dt_f * 1e6, 1)
    res["delta_pct"] = round(100.0 * (dt_f - dt_b) / dt_b, 1)
    res["K1_us"] = _us(lambda xx: fa.folded_rotary_attention_lnres(
        w.fold, xx, cos, sin, valid, H), x)
    lw = lean_weights(p32, bf, ln_p)
    lcos, lsin = lean_tables(cos, sin, bf)
    mask = valid[:, None, None, :]
    res["lean_us"] = _us(lambda xx: lnres_lean(lw, xx, lcos, lsin, mask), x)
    k1 = fa.folded_rotary_attention_lnres(w.fold, x, cos, sin, valid, H)
    diff = float((got.float() - k1.float())[valid].abs().max())
    term = float((got.float() - x.float())[valid].pow(2).mean().sqrt())
    res["k1_residual_diff"] = {"max_abs": diff, "in_rms": diff / term}
    print(f"b{b} t{t} nb{nb}: baseline {res['baseline_us']} us, foldLN "
          f"{res['foldLN_us']} us ({res['delta_pct']:+}%), K1 "
          f"{res['K1_us']} us, lean {res['lean_us']} us, maxrel "
          f"{res['maxrel']:.4f}, |P8 - K1| <= {diff:.3e}", flush=True)
    return res


def main(device=None) -> dict:
    """Both scripts' ``main`` on ``device`` (the card when None): prints and
    returns the results by script and shape."""
    out = {"fold": {f"b{b}_t{t}": run(b, t, device=device)
                    for b, t in FOLD_SHAPES},
           "lnres": {f"b{b}_t{t}": run_lnres(b, t, nb, device)
                     for b, t, nb in LNRES_SHAPES}}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
