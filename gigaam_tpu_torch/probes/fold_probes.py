"""The FFN and conv-module fold probes on the card (P4, P5).

Counterpart of ``benchmarks/pallas_ffn_fold_probe.py`` (P4) and
``benchmarks/pallas_conv_fold_probe.py`` (P5).  Each folds one Conformer
sub-block, its LayerNorm and residual included, into hand-written Hopper
kernels (``csrc/fold_probes.cu``):

  P4  ffn_lnres_folded(ln_p, p, x, nb)          x + 0.5 FFN(LN(x))
  P5  conv_lnres_folded(ln_p, p, x, valid, nb)  x + ConvModule(LN(x))

and times the fold against two stock compositions:

  baseline  the port's in-model path, as the encoder runs it:
            ``x + 0.5 * ffn(p, layer_norm(ln_p, x))`` and ``x +
            conformer_conv(p, layer_norm(ln_p, x), valid, "batch_norm")[0]``
            (``ops/conformer_ops.py``): the script's own baseline;
  lean      the fewest stock calls: ``F.layer_norm``, ``F.linear`` with its
            bias, ``F.silu``, ``F.linear``, ``torch.add(x, y, alpha=0.5)``
            for P4; ``F.layer_norm``, one [768, 1536] ``F.linear``,
            ``F.glu``, the mask, cuDNN's depthwise ``F.conv1d``, the
            BatchNorm affine (precomputed, the depthwise bias folded in),
            ``F.silu``, ``F.linear`` and the add for P5.

On a card,

    python3 -m gigaam_tpu_torch.probes.fold_probes

prints a line per probe and shape and, last, one JSON object
``{"ffn": {"b32_t512": {...}, "b128_t768": {...}}, "conv": {...}}``: under
each shape the scripts' keys (``baseline_us``, ``foldFFN_us`` or
``foldConv_us``, ``delta_pct``, ``maxrel``) and ``lean_us``,
``delta_lean_pct`` and ``nb``.  Times are microseconds per call from
``gigaam_tpu_torch.profiling.device_timeit`` (40 calls replayed as a CUDA
graph, as the scripts call theirs 40 times a run).  A failure raises; the
scripts record it and go on.

``nb`` is the TPU grid's batch rows per cell, a tiling knob of the Pallas
kernels.  The Hopper kernels tile rows their own way and ignore it: it
stays in the signatures and is recorded in the output.

The scripts time the fold inside ``jax.jit`` with the weights as constants,
so XLA folds the weights' casts and P5's BatchNorm fold away.  Here the fold
weights are prepared once (``prepare_ffn``, ``prepare_conv``) and the timed
call is the kernel wrapper's; the stock paths, too, get their matrices in
bf16 once (the encoder after ``cast_encoder``).

P4 runs on its redesign, ``csrc/ffn_ws.cu``: a row pass writes bf16(LN(x)),
then the two products on ``csrc/conv_ws.cuh``'s warp-specialised,
persistent core (``ws_plan``), the first with the bias and SiLU in its
epilogue, the second with the bias, the 0.5 and the residual
(``ffn_ws``; its stages alone: ``ffn_rows_ws``, ``silu_product_ws``,
``residual_product_ws``, each beside its plain stage).  The one-launch fold
of ``csrc/fold_probes.cu`` stays reachable as ``ffn_fold_ring`` for an A/B
on the same card (it counts no launch).

P5 runs on its redesign, ``csrc/conv_fold_ws.cu``, in four stages: P4's row
pass, the GLU product on the ping-pong core (``conv_ws.cuh``'s
``PingPongCore``: 64 x 256 tiles in clusters of two, W_vg the value and
gate columns interleaved by ``prepare_conv``), the depthwise pass on the
CUDA cores, and the pointwise product with the bias and the residual on the
same core (its stages alone: ``conv_rows_ws``,
``glu_product_ws``, ``depthwise_ws``, ``conv_residual_product_ws``, each
beside its plain stage; ``conv_staged_plain`` composes the plain stages and
equals ``conv_fold_plain`` bit for bit).  ``csrc/fold_probes.cu``'s
``glu_fold_kernel`` + ``dw_proj_kernel`` stay reachable as
``conv_fold_ring`` for an A/B on the same card (it counts no launch).

Beside each kernel wrapper is the plain version of its Pallas body
(``ffn_fold_plain``, ``conv_fold_plain``), rounding where the body rounds.
A wrapper takes it for tensors on the CPU; for CUDA tensors it launches its
kernels or raises.  ``<wrapper>.launches`` counts the calls that launched.
Only the tests and ``chip_smoke.py`` call the plain versions on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cuda_lib
from ..ops.conformer_ops import conformer_conv, ffn, layer_norm
from ..ops.fused_attention import _check_tensor, _require, _stream
from ..ops.precision import full_fp32
from ..profiling import device_timeit
from ..weights import sub_block_from_jax
from .ws_plan import PP_BM, WS_BK, WS_BM, ws_plan

D, DFF, K = 768, 3072, 31
EPS = 1e-5
# (B, T, nb) of the scripts' main
SHAPES = ((32, 512, 1), (128, 768, 4))
PROBES = ("ffn", "conv")
CALLS = 40          # calls a timed run, as the scripts' device_timeit(k=40)
FOLD_KEY = {"ffn": "foldFFN_us", "conv": "foldConv_us"}


# ---------------------------------------------------------------------------
# Weights, as the Pallas wrappers hand them to their kernels
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FfnFoldWeights:
    ln_g: torch.Tensor   # [D] fp32
    ln_b: torch.Tensor
    w1: torch.Tensor     # [D, DFF] compute dtype ([in, out])
    b1: torch.Tensor     # [DFF] fp32
    w2: torch.Tensor     # [DFF, D] compute dtype
    b2: torch.Tensor     # [D] fp32


@dataclasses.dataclass
class ConvFoldWeights:
    ln_g: torch.Tensor   # [D] fp32
    ln_b: torch.Tensor
    wv: torch.Tensor     # [D, D] compute dtype: the GLU's value half
    bv: torch.Tensor     # [D] fp32
    wg: torch.Tensor     # [D, D] compute dtype: its gate half
    bg: torch.Tensor     # [D] fp32
    dw: torch.Tensor     # [K, D] fp32: tap k of channel c at [k, c]
    bns: torch.Tensor    # [D] fp32: BatchNorm's scale
    bnb: torch.Tensor    # [D] fp32: its bias, the depthwise bias folded in
    w2: torch.Tensor     # [D, D] compute dtype
    b2: torch.Tensor     # [D] fp32
    # [D, 2 D]: wv and wg interleaved (``interleave_vg``), the GLU product's
    # weight on the card
    w_vg: Optional[torch.Tensor] = None


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def prepare_ffn(ln_p: Mapping, p: Mapping, dtype: torch.dtype
                ) -> FfnFoldWeights:
    """The port's FFN sub-block parameters (``linear1``, ``linear2``) and
    its LayerNorm's, cast as ``ffn_lnres_folded`` casts them."""
    return FfnFoldWeights(
        _f32(ln_p["scale"]), _f32(ln_p["bias"]),
        p["linear1"]["w"].to(dtype).contiguous(), _f32(p["linear1"]["b"]),
        p["linear2"]["w"].to(dtype).contiguous(), _f32(p["linear2"]["b"]))


def bn_affine(p: Mapping):
    """Inference BatchNorm folded to an fp32 (scale, bias), the depthwise
    bias folded into the bias, as ``conv_lnres_folded`` folds them."""
    bn = p["batch_norm"]
    inv = torch.rsqrt(bn["var"].float() + EPS)
    bns = bn["scale"].float() * inv
    bnb = bn["bias"].float() - bn["mean"].float() * bn["scale"].float() * inv
    if "b" in p["depthwise_conv"]:
        bnb = bnb + p["depthwise_conv"]["b"].float() * bns
    return bns.contiguous(), bnb.contiguous()


def _vg_block(d: int) -> int:
    """The interleave's block: half a product tile's columns (128), or at
    a width it does not divide, the largest block that does."""
    return math.gcd(d, CONV_BN // 2)


def interleave_vg(wv: torch.Tensor, wg: torch.Tensor) -> torch.Tensor:
    """W_vg [D, 2 D] of the GLU's value and gate halves [D, D]: in blocks
    of ``_vg_block(D)`` (128 at D 768) columns, block i of Wv, then block i
    of Wg, so that one 256-wide tile of the product holds the value and the
    gate of the same 128 channels."""
    d, n = wv.shape
    blk = _vg_block(n)
    return torch.stack([wv.reshape(d, n // blk, blk),
                        wg.reshape(d, n // blk, blk)], dim=2).reshape(
        d, 2 * n).contiguous()


def prepare_conv(ln_p: Mapping, p: Mapping, dtype: torch.dtype
                 ) -> ConvFoldWeights:
    """The port's conv-module parameters (depthwise weight [C, 1, K]) and
    its LayerNorm's, cast and folded as ``conv_lnres_folded`` does, with
    the GLU product's interleaved weight built once."""
    pc1 = p["pointwise_conv1"]
    dw = p["depthwise_conv"]["w"]
    bns, bnb = bn_affine(p)
    wv, wg = (pc1["w_value"].to(dtype).contiguous(),
              pc1["w_gate"].to(dtype).contiguous())
    return ConvFoldWeights(
        _f32(ln_p["scale"]), _f32(ln_p["bias"]), wv, _f32(pc1["b_value"]),
        wg, _f32(pc1["b_gate"]),
        _f32(dw.reshape(dw.shape[0], dw.shape[-1]).t()), bns, bnb,
        p["pointwise_conv2"]["w"].to(dtype).contiguous(),
        _f32(p["pointwise_conv2"]["b"]), interleave_vg(wv, wg))


# ---------------------------------------------------------------------------
# Plain versions of the Pallas bodies
# ---------------------------------------------------------------------------

def _layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """The bodies' LayerNorm: fp32 statistics, rounded to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + EPS) * g + b).to(x.dtype)


def _product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a . w`` in fp32, as ``jnp.dot`` with an fp32 result."""
    with full_fp32():
        return a.float() @ w.float()


def _silu(v: torch.Tensor) -> torch.Tensor:
    return v * torch.sigmoid(v)


def ffn_fold_plain(w: FfnFoldWeights, x: torch.Tensor) -> torch.Tensor:
    """``_ffn_lnres_kernel``: x + bf16(0.5 (bf16(SiLU(LN(x) W1 + b1)) W2 +
    b2)), the sum in x's dtype."""
    xn = _layer_norm(x, w.ln_g, w.ln_b)
    h = _silu(_product(xn, w.w1) + w.b1).to(x.dtype)
    y = _product(h, w.w2) + w.b2
    return (0.5 * y).to(x.dtype) + x


def ffn_rows_plain(w: FfnFoldWeights, x: torch.Tensor) -> torch.Tensor:
    """P4's row pass: bf16(LN(x)), fp32 statistics."""
    return _layer_norm(x, w.ln_g, w.ln_b)


def silu_product_plain(xn: torch.Tensor, w1: torch.Tensor,
                       b1: torch.Tensor) -> torch.Tensor:
    """P4's first product: bf16(SiLU(xn w1 + b1)), SiLU in fp32."""
    return _silu(_product(xn, w1) + b1).to(xn.dtype)


def residual_product_plain(h: torch.Tensor, w2: torch.Tensor,
                           b2: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """P4's second product: bf16(bf16(0.5 (h w2 + b2)) + x)."""
    return (0.5 * (_product(h, w2) + b2)).to(x.dtype) + x


def ffn_staged_plain(w: FfnFoldWeights, x: torch.Tensor) -> torch.Tensor:
    """``ffn_fold_plain`` as the redesign's three stages compute it: the
    row pass, the SiLU product, the residual product."""
    h = silu_product_plain(ffn_rows_plain(w, x), w.w1, w.b1)
    return residual_product_plain(h, w.w2, w.b2, x)


def depthwise_taps(y: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """The Pallas body's depthwise conv of y [B, T, C] (any dtype) with taps
    dw [K, C]: K fp32 multiply-adds in order of k over y zero-padded by
    (K - 1) / 2 frames at each end of each batch element ('same')."""
    k, t = dw.shape[0], y.shape[1]
    pad = (k - 1) // 2
    yp = F.pad(y.float(), (0, 0, pad, pad))
    acc = torch.zeros(y.shape, dtype=torch.float32, device=y.device)
    for i in range(k):
        acc = acc + yp[:, i:i + t] * dw[i]
    return acc


def conv_fold_plain(w: ConvFoldWeights, x: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """``_conv_lnres_kernel``: x + bf16(bf16(SiLU(bns taps(y) + bnb)) W2 +
    b2) with y = bf16((xn Wv + bv) sigmoid(xn Wg + bg)) * valid, xn =
    LN(x); the sum in x's dtype."""
    xn = _layer_norm(x, w.ln_g, w.ln_b)
    v = _product(xn, w.wv) + w.bv
    g = _product(xn, w.wg) + w.bg
    y = (v * torch.sigmoid(g)).to(x.dtype) * valid.to(x.dtype)[..., None]
    c = _silu(depthwise_taps(y, w.dw) * w.bns + w.bnb).to(x.dtype)
    return (_product(c, w.w2) + w.b2).to(x.dtype) + x


def conv_rows_plain(w: ConvFoldWeights, x: torch.Tensor) -> torch.Tensor:
    """P5's row pass: bf16(LN(x)), fp32 statistics (P4's)."""
    return _layer_norm(x, w.ln_g, w.ln_b)


def glu_product_plain(w: ConvFoldWeights, xn: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """P5's GLU product: y = bf16((xn Wv + bv) sigmoid(xn Wg + bg)) *
    valid, for xn [B, T, D], valid [B, T]."""
    v = _product(xn, w.wv) + w.bv
    g = _product(xn, w.wg) + w.bg
    return (v * torch.sigmoid(g)).to(xn.dtype) * valid.to(xn.dtype)[..., None]


def depthwise_plain(w: ConvFoldWeights, y: torch.Tensor) -> torch.Tensor:
    """P5's depthwise pass: c = bf16(SiLU(bns taps(y) + bnb)), the taps
    ``depthwise_taps``' (zero outside each batch element)."""
    return _silu(depthwise_taps(y, w.dw) * w.bns + w.bnb).to(y.dtype)


def conv_residual_product_plain(w: ConvFoldWeights, c: torch.Tensor,
                                x: torch.Tensor) -> torch.Tensor:
    """P5's pointwise product: bf16(bf16(c W2 + b2) + x)."""
    return (_product(c, w.w2) + w.b2).to(x.dtype) + x


def conv_staged_plain(w: ConvFoldWeights, x: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """``conv_fold_plain`` as the redesign's four stages compute it: the
    row pass, the GLU product, the depthwise pass, the pointwise product;
    the same values bit for bit."""
    y = glu_product_plain(w, conv_rows_plain(w, x), valid)
    return conv_residual_product_plain(w, depthwise_plain(w, y), x)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _check_ffn_args(w: FfnFoldWeights, x: torch.Tensor) -> None:
    """What ``ffn_fold_kernel`` takes: x [B, T, 768] bf16 with B T >= 1, the
    weights' shapes and dtypes, every tensor contiguous and 16-byte aligned
    on x's device."""
    _require(x.dim() == 3 and x.shape[-1] == D and x.numel() > 0,
             f"x must be [B, T, {D}], got {tuple(x.shape)}")
    _check_tensor("x", x, x.device, torch.bfloat16, x.shape)
    for name, shape in (("ln_g", (D,)), ("ln_b", (D,)), ("w1", (D, DFF)),
                        ("b1", (DFF,)), ("w2", (DFF, D)), ("b2", (D,))):
        _check_tensor(name, getattr(w, name), x.device,
                      x.dtype if name[0] == "w" else torch.float32, shape)


def _check_conv_args(w: ConvFoldWeights, x: torch.Tensor,
                     valid: Optional[torch.Tensor]) -> None:
    """What the conv fold's kernels take: x [B, T, 768] bf16, valid [B, T]
    bool (None: a stage that reads no mask), the weights' shapes and
    dtypes, every tensor contiguous and 16-byte aligned on x's device."""
    _require(x.dim() == 3 and x.shape[-1] == D and x.numel() > 0,
             f"x must be [B, T, {D}], got {tuple(x.shape)}")
    _check_tensor("x", x, x.device, torch.bfloat16, x.shape)
    if valid is not None:
        _check_tensor("valid", valid, x.device, torch.bool, x.shape[:2])
    for name in ("ln_g", "ln_b", "bv", "bg", "bns", "bnb", "b2"):
        _check_tensor(name, getattr(w, name), x.device, torch.float32, (D,))
    for name in ("wv", "wg", "w2"):
        _check_tensor(name, getattr(w, name), x.device, x.dtype, (D, D))
    _check_tensor("dw", w.dw, x.device, torch.float32, (K, D))


# P4's redesign (csrc/ffn_ws.cu): WsCore<256, 2, true>'s tile columns and
# cluster, and the products' epilogues (its Mode)
FFN_BN, FFN_CLUSTER = 256, 2
_SILU_BIAS, _RESIDUAL = 1, 2


def ffn_plans(m: int, slots: int, splits=(None, None)):
    """The plans (``ws_plan``: units, grid, splits) of P4's two products
    for M rows on ``slots`` blocks: xn [M, 768] . W1 [768, 3072], then h
    [M, 3072] . W2 [3072, 768]; ``splits`` forces either's K splits."""
    row_tiles = -(-m // WS_BM)
    return tuple(ws_plan(row_tiles, n // FFN_BN, k // WS_BK, slots, m * n,
                         FFN_BN, FFN_CLUSTER, forced)
                 for (n, k), forced in zip(((DFF, D), (D, DFF)), splits))


@functools.lru_cache(maxsize=None)
def _ffn_slots(index: int) -> int:
    """The products' persistent grid's ceiling on card ``index``: blocks of
    clusters of two that it holds at once, at most one an SM."""
    out = (ctypes.c_int * 1)()
    with torch.cuda.device(index):
        cuda_lib.check(cuda_lib.library("ffn_ws").gigaam_ffn_ws_max_clusters(
            out), "gigaam_ffn_ws_max_clusters")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return min(sms, 2 * out[0])


@functools.lru_cache(maxsize=None)
def _device_plan(m: int, n: int, k: int, splits, index: int):
    """(units on card ``index``, grid, splits) of one product, made once a
    shape: the first call copies the plan to the card, so it must not be
    under CUDA-graph capture."""
    units, grid, splits = ws_plan(-(-m // WS_BM), n // FFN_BN, k // WS_BK,
                                  _ffn_slots(index), m * n, FFN_BN,
                                  FFN_CLUSTER, splits)
    return torch.from_numpy(units).to(f"cuda:{index}"), grid, splits


def _check_rows(name: str, a: torch.Tensor, dev, width: int) -> int:
    _require(a.dim() == 2 and a.shape[1] == width and a.shape[0] >= 1
             and a.shape[0] * DFF < 2 ** 31,
             f"{name} must be [M, {width}] with 1 <= M < 2^31 / {DFF}, got "
             f"{tuple(a.shape)}")
    _check_tensor(name, a, dev, torch.bfloat16, a.shape)
    return a.shape[0]


def _product_ws(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor,
                x, mode: int, splits) -> torch.Tensor:
    """The epilogue ``mode`` of a [M, K] . b [K, N] on ``ffn_ws_kernel``
    (and the partials' reduction where the plan splits K)."""
    (m, k), n = a.shape, b.shape[1]
    units, grid, splits = _device_plan(m, n, k, splits, a.device.index)
    out = torch.empty(m, n, dtype=a.dtype, device=a.device)
    partial = (torch.empty(splits, m, n, dtype=torch.float32, device=a.device)
               if splits > 1 else None)
    with torch.cuda.device(a.device):
        cuda_lib.check(cuda_lib.library("ffn_ws").gigaam_ffn_ws_product(
            a.data_ptr(), b.data_ptr(), bias.data_ptr(),
            None if x is None else x.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(), units.data_ptr(),
            m, n, k, len(units), grid, splits, mode, _stream(a.device)),
            "gigaam_ffn_ws_product")
    return out


def _rows_ws(w, x2: torch.Tensor) -> torch.Tensor:
    """``ffn_rows_kernel`` on x2 [M, 768]; ``w``: P4's or P5's weights
    (their LayerNorm's)."""
    xn = torch.empty_like(x2)
    with torch.cuda.device(x2.device):
        cuda_lib.check(cuda_lib.library("ffn_ws").gigaam_ffn_ws_rows(
            x2.data_ptr(), w.ln_g.data_ptr(), w.ln_b.data_ptr(),
            xn.data_ptr(), x2.shape[0], _stream(x2.device)),
            "gigaam_ffn_ws_rows")
    return xn


def ffn_rows_ws(w, x2: torch.Tensor) -> torch.Tensor:
    """P4's row pass on the card (``ffn_rows_kernel``): bf16(LN(x2)) for
    x2 [M, 768] bf16, ``w`` P4's or P5's weights.  Counts no launch."""
    _check_rows("x", x2, x2.device, D)
    for name in ("ln_g", "ln_b"):
        _check_tensor(name, getattr(w, name), x2.device, torch.float32, (D,))
    return _rows_ws(w, x2)


def silu_product_ws(xn: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    splits: int = None) -> torch.Tensor:
    """P4's first product on the card: bf16(SiLU(xn w1 + b1)) [M, 3072],
    in the plan's K splits or ``splits``.  Counts no launch."""
    _check_rows("xn", xn, xn.device, D)
    _check_tensor("w1", w1, xn.device, torch.bfloat16, (D, DFF))
    _check_tensor("b1", b1, xn.device, torch.float32, (DFF,))
    return _product_ws(xn, w1, b1, None, _SILU_BIAS, splits)


def residual_product_ws(h: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                        x2: torch.Tensor, splits: int = None) -> torch.Tensor:
    """P4's second product on the card: bf16(bf16(0.5 (h w2 + b2)) + x2)
    [M, 768], in the plan's K splits or ``splits``.  Counts no launch."""
    m = _check_rows("h", h, h.device, DFF)
    _check_tensor("w2", w2, h.device, torch.bfloat16, (DFF, D))
    _check_tensor("b2", b2, h.device, torch.float32, (D,))
    _check_tensor("x", x2, h.device, torch.bfloat16, (m, D))
    return _product_ws(h, w2, b2, x2, _RESIDUAL, splits)


def ffn_ws(w: FfnFoldWeights, x: torch.Tensor,
           splits=(None, None)) -> torch.Tensor:
    """P4 on the card by the redesign: the row pass, then the two products
    (their K splits the plans' or ``splits``), the arguments checked once.
    Counts no launch."""
    _check_ffn_args(w, x)
    x2 = x.view(-1, D)
    _require(x2.shape[0] * DFF < 2 ** 31, f"B T = {x2.shape[0]} is too large")
    h = _product_ws(_rows_ws(w, x2), w.w1, w.b1, None, _SILU_BIAS,
                    splits[0])
    return _product_ws(h, w.w2, w.b2, x2, _RESIDUAL, splits[1]).view_as(x)


def ffn_fold(w: FfnFoldWeights, x: torch.Tensor) -> torch.Tensor:
    """P4: x + 0.5 FFN(LN(x)) for x [B, T, 768]: on the card (bf16) the
    redesign, ``ffn_ws`` (a row pass and two products on the
    warp-specialised core, h [B T, 3072] in between); ``ffn_fold_plain`` on
    the CPU."""
    if x.device.type == "cpu":
        return ffn_fold_plain(w, x)
    out = ffn_ws(w, x)
    ffn_fold.launches += 1
    return out


def ffn_fold_ring(w: FfnFoldWeights, x: torch.Tensor) -> torch.Tensor:
    """P4 on the design the redesign replaced: one launch of
    ``ffn_fold_kernel`` (64 rows a block, h in shared memory, ``gemm.cuh``'s
    TMA ring).  Card only; counts no launch: kept for an A/B on the same
    card."""
    _check_ffn_args(w, x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        cuda_lib.check(cuda_lib.library("fold_probes").gigaam_ffn_fold(
            x.data_ptr(), w.ln_g.data_ptr(), w.ln_b.data_ptr(),
            w.w1.data_ptr(), w.b1.data_ptr(), w.w2.data_ptr(),
            w.b2.data_ptr(), out.data_ptr(), x.shape[0] * x.shape[1],
            _stream(x.device)), "gigaam_ffn_fold")
    return out


# P5's redesign (csrc/conv_fold_ws.cu): its products' tiles (PingPongCore:
# PP_BM rows, 256 columns, clusters of two) and epilogues (its Mode)
CONV_BN, CONV_CLUSTER = 256, 2
_GLU, _CONV_RESIDUAL = 1, 2


def conv_plans(m: int, slots: int):
    """The plans (``ws_plan``: units, grid) of P5's two products for M rows
    on ``slots`` blocks, K unsplit: xn [M, 768] . W_vg [768, 1536], then
    c [M, 768] . W2 [768, 768], in 64-row tiles paired in clusters of two;
    unit i of a block runs on its consumer warpgroup i % 2."""
    row_tiles = -(-m // PP_BM)
    return tuple(ws_plan(row_tiles, n // CONV_BN, D // WS_BK, slots, m * n,
                         CONV_BN, CONV_CLUSTER, splits=1)[:2]
                 for n in (2 * D, D))


@functools.lru_cache(maxsize=None)
def _conv_slots(index: int) -> int:
    """The products' persistent grid's ceiling on card ``index``: blocks of
    clusters of two that it holds at once, at most one an SM."""
    out = (ctypes.c_int * 1)()
    with torch.cuda.device(index):
        cuda_lib.check(cuda_lib.library("conv_fold_ws").gigaam_conv_ws_slots(
            out), "gigaam_conv_ws_slots")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return min(sms, out[0])


@functools.lru_cache(maxsize=None)
def _device_conv_plans(m: int, index: int):
    """``conv_plans`` on card ``index``, made once a shape: the first call
    copies the plans to the card, so it must not be under CUDA-graph
    capture."""
    return tuple((torch.from_numpy(units).to(f"cuda:{index}"), grid)
                 for units, grid in conv_plans(m, _conv_slots(index)))


def _launch_conv_product(a2: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, gate_bias, valid, x2,
                         out: torch.Tensor, mode: int) -> None:
    """One product on ``conv_fold_ws_kernel<mode>`` (arguments checked by
    the caller): the GLU's (gate bias, valid) or the residual's (x2)."""
    m, dev = a2.shape[0], a2.device
    units, grid = _device_conv_plans(m, dev.index)[mode - 1]
    ptr = lambda t: None if t is None else t.data_ptr()
    cuda_lib.check(cuda_lib.library("conv_fold_ws").gigaam_conv_ws_product(
        a2.data_ptr(), weight.data_ptr(), bias.data_ptr(), ptr(gate_bias),
        ptr(valid), ptr(x2), out.data_ptr(), units.data_ptr(), len(units),
        grid, m, mode, _stream(dev)), "gigaam_conv_ws_product")


def _launch_depthwise(w: ConvFoldWeights, y: torch.Tensor,
                      c: torch.Tensor) -> None:
    b, t, _ = y.shape
    cuda_lib.check(cuda_lib.library("conv_fold_ws").gigaam_conv_ws_depthwise(
        y.data_ptr(), w.dw.data_ptr(), w.bns.data_ptr(), w.bnb.data_ptr(),
        c.data_ptr(), b, t, _stream(y.device)), "gigaam_conv_ws_depthwise")


def _check_conv_ws_args(w: ConvFoldWeights, x: torch.Tensor,
                        valid: Optional[torch.Tensor]) -> None:
    """``_check_conv_args`` and what the redesign takes besides: W_vg
    [768, 1536] in x's dtype (``prepare_conv``), B < 65536 and B T 768 <
    2^31."""
    _check_conv_args(w, x, valid)
    _require(w.w_vg is not None,
             "the card path needs w_vg: prepare_conv builds it")
    _check_tensor("w_vg", w.w_vg, x.device, x.dtype, (D, 2 * D))
    _require(x.shape[0] < 65536 and x.numel() < 2 ** 31,
             f"x {tuple(x.shape)} is too large for the card path")


def _conv_ws(w: ConvFoldWeights, x: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """The redesign's four launches (arguments checked by the caller)."""
    x2 = x.view(-1, D)
    y, c, out = (torch.empty_like(x) for _ in range(3))
    with torch.cuda.device(x.device):
        xn = _rows_ws(w, x2)
        _launch_conv_product(xn, w.w_vg, w.bv, w.bg, valid, None, y, _GLU)
        _launch_depthwise(w, y, c)
        _launch_conv_product(c.view(-1, D), w.w2, w.b2, None, None, x2, out,
                             _CONV_RESIDUAL)
    return out


def conv_rows_ws(w: ConvFoldWeights, x: torch.Tensor) -> torch.Tensor:
    """P5's row pass alone on the card (P4's ``ffn_rows_kernel``):
    bf16(LN(x)) for x [B, T, 768] bf16.  Counts no launch."""
    return ffn_rows_ws(w, x.view(-1, D)).view_as(x)


def glu_product_ws(w: ConvFoldWeights, xn: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """P5's GLU product alone on the card (``conv_fold_ws_kernel<1>``): y
    [B, T, 768] for xn [B, T, 768] bf16.  Counts no launch."""
    _check_conv_ws_args(w, xn, valid)
    y = torch.empty_like(xn)
    with torch.cuda.device(xn.device):
        _launch_conv_product(xn.view(-1, D), w.w_vg, w.bv, w.bg, valid, None,
                             y, _GLU)
    return y


def depthwise_ws(w: ConvFoldWeights, y: torch.Tensor) -> torch.Tensor:
    """P5's depthwise pass alone on the card (``conv_dw_kernel``): c
    [B, T, 768] for y [B, T, 768] bf16.  Counts no launch."""
    _check_conv_ws_args(w, y, None)
    c = torch.empty_like(y)
    with torch.cuda.device(y.device):
        _launch_depthwise(w, y, c)
    return c


def conv_residual_product_ws(w: ConvFoldWeights, c: torch.Tensor,
                             x: torch.Tensor) -> torch.Tensor:
    """P5's pointwise product alone on the card
    (``conv_fold_ws_kernel<2>``): bf16(bf16(c W2 + b2) + x) for c, x
    [B, T, 768] bf16.  Counts no launch."""
    _check_conv_ws_args(w, x, None)
    _check_tensor("c", c, x.device, x.dtype, x.shape)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch_conv_product(c.view(-1, D), w.w2, w.b2, None, None,
                             x.view(-1, D), out, _CONV_RESIDUAL)
    return out


def conv_fold(w: ConvFoldWeights, x: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """P5: x + ConvModule(LN(x)) for x [B, T, 768], valid [B, T] (True: a
    real frame): on the card (bf16) the redesign (the row pass, the GLU
    product, the depthwise pass, the pointwise product); ``conv_fold_plain``
    on the CPU."""
    if x.device.type == "cpu":
        return conv_fold_plain(w, x, valid)
    _check_conv_ws_args(w, x, valid)
    out = _conv_ws(w, x, valid)
    conv_fold.launches += 1
    return out


def conv_fold_ring(w: ConvFoldWeights, x: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """P5 on the design the redesign replaced: ``glu_fold_kernel`` then
    ``dw_proj_kernel`` (y, their [B, T, 768] handover, is scratch).  Card
    only; counts no launch: kept for an A/B on the same card."""
    _require(x.device.type == "cuda", "conv_fold_ring runs on the card only")
    _check_conv_args(w, x, valid)
    y = torch.empty_like(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        cuda_lib.check(cuda_lib.library("fold_probes").gigaam_conv_fold(
            x.data_ptr(), w.ln_g.data_ptr(), w.ln_b.data_ptr(),
            w.wv.data_ptr(), w.bv.data_ptr(), w.wg.data_ptr(),
            w.bg.data_ptr(), valid.data_ptr(), w.dw.data_ptr(),
            w.bns.data_ptr(), w.bnb.data_ptr(), w.w2.data_ptr(),
            w.b2.data_ptr(), y.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], _stream(x.device)), "gigaam_conv_fold")
    return out


KERNELS = (ffn_fold, conv_fold)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


reset_launch_counts()


def ffn_lnres_folded(ln_p: Mapping, p: Mapping, x: torch.Tensor, nb: int
                     ) -> torch.Tensor:
    """The script's P4 entry: the port's FFN parameters and LayerNorm's, x
    [B, T, 768]; ``nb`` must divide B and is otherwise ignored."""
    _require(x.shape[0] % nb == 0, f"nb {nb} does not divide B {x.shape[0]}")
    return ffn_fold(prepare_ffn(ln_p, p, x.dtype), x)


def conv_lnres_folded(ln_p: Mapping, p: Mapping, x: torch.Tensor,
                      valid: torch.Tensor, nb: int) -> torch.Tensor:
    """The script's P5 entry: the port's conv-module parameters and
    LayerNorm's, x [B, T, 768], valid [B, T]; ``nb`` must divide B and is
    otherwise ignored."""
    _require(x.shape[0] % nb == 0, f"nb {nb} does not divide B {x.shape[0]}")
    return conv_fold(prepare_conv(ln_p, p, x.dtype), x, valid)


# ---------------------------------------------------------------------------
# The stock compositions
# ---------------------------------------------------------------------------

def ffn_baseline(ln_p: Mapping, p: Mapping, x: torch.Tensor) -> torch.Tensor:
    """(a) The encoder's FFN sub-block: ``x + 0.5 * ffn(LN(x))``."""
    return x + 0.5 * ffn(p, layer_norm(ln_p, x))


def conv_baseline(ln_p: Mapping, p: Mapping, x: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """(a) The encoder's conv sub-block in inference."""
    return x + conformer_conv(p, layer_norm(ln_p, x), valid, "batch_norm")[0]


def lean_ffn_weights(ln_p: Mapping, p: Mapping, dtype: torch.dtype) -> dict:
    """Path (b)'s FFN parameters, all in ``dtype``, the matrices [out, in]
    as ``F.linear`` takes them."""
    return {"ln_g": ln_p["scale"].to(dtype), "ln_b": ln_p["bias"].to(dtype),
            "w1": p["linear1"]["w"].t().to(dtype).contiguous(),
            "b1": p["linear1"]["b"].to(dtype),
            "w2": p["linear2"]["w"].t().to(dtype).contiguous(),
            "b2": p["linear2"]["b"].to(dtype)}


def ffn_lean(lw: dict, x: torch.Tensor) -> torch.Tensor:
    """(b) ``F.layer_norm``, ``F.linear`` + bias, ``F.silu``, ``F.linear``
    + bias, ``torch.add(x, y, alpha=0.5)``."""
    xn = F.layer_norm(x, (x.shape[-1],), lw["ln_g"], lw["ln_b"], EPS)
    h = F.silu(F.linear(xn, lw["w1"], lw["b1"]))
    return torch.add(x, F.linear(h, lw["w2"], lw["b2"]), alpha=0.5)


def lean_conv_weights(ln_p: Mapping, p: Mapping, dtype: torch.dtype) -> dict:
    """Path (b)'s conv-module parameters in ``dtype``: the value and gate
    halves as one [2 D, D] ``F.linear`` weight, the BatchNorm affine
    precomputed with the depthwise bias folded in, as [D, 1] columns."""
    pc1 = p["pointwise_conv1"]
    bns, bnb = bn_affine(p)
    return {
        "ln_g": ln_p["scale"].to(dtype), "ln_b": ln_p["bias"].to(dtype),
        "w_vg": torch.cat([pc1["w_value"], pc1["w_gate"]], dim=1).t()
        .to(dtype).contiguous(),
        "b_vg": torch.cat([pc1["b_value"], pc1["b_gate"]]).to(dtype),
        "dw": p["depthwise_conv"]["w"].to(dtype),
        "bns": bns[:, None].to(dtype), "bnb": bnb[:, None].to(dtype),
        "w2": p["pointwise_conv2"]["w"].t().to(dtype).contiguous(),
        "b2": p["pointwise_conv2"]["b"].to(dtype)}


def conv_lean(lw: dict, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(b) ``F.layer_norm``, one ``F.linear`` to value and gate, ``F.glu``,
    the mask ([B, T, 1] in x's dtype), the depthwise ``F.conv1d``, the
    BatchNorm affine (``torch.addcmul``), ``F.silu``, ``F.linear`` and the
    residual add."""
    d = x.shape[-1]
    xn = F.layer_norm(x, (d,), lw["ln_g"], lw["ln_b"], EPS)
    y = F.glu(F.linear(xn, lw["w_vg"], lw["b_vg"]), dim=-1) * mask
    c = F.conv1d(y.transpose(1, 2), lw["dw"], None,
                 padding=(lw["dw"].shape[-1] - 1) // 2, groups=d)
    c = F.silu(torch.addcmul(lw["bnb"], c, lw["bns"]))
    return torch.add(x, F.linear(c.transpose(1, 2), lw["w2"], lw["b2"]))


# ---------------------------------------------------------------------------
# The scripts' inputs and runners
# ---------------------------------------------------------------------------

def ffn_inputs(b: int, t: int):
    """P4's inputs as the script draws them (``default_rng(0)``, the same
    order and scales): (ln_p, p, x), JAX-layout numpy trees and x float64
    [B, T, D]."""
    rng = np.random.default_rng(0)
    f32 = lambda a: np.asarray(a, np.float32)
    p = {"linear1": {"w": f32(0.05 * rng.standard_normal((D, DFF))),
                     "b": f32(0.01 * rng.standard_normal(DFF))},
         "linear2": {"w": f32(0.05 * rng.standard_normal((DFF, D))),
                     "b": f32(0.01 * rng.standard_normal(D))}}
    ln_p = {"scale": f32(1.0 + 0.1 * rng.standard_normal(D)),
            "bias": f32(0.1 * rng.standard_normal(D))}
    return ln_p, p, 0.5 * rng.standard_normal((b, t, D))


def conv_inputs(b: int, t: int):
    """P5's inputs as the script draws them: (ln_p, p, x, valid) with the
    script's ragged lengths (the first row full, the others t - 77)."""
    rng = np.random.default_rng(0)
    f32a = lambda *s: np.asarray(0.05 * rng.standard_normal(s), np.float32)
    p = {
        "pointwise_conv1": {"w_value": f32a(D, D), "b_value": f32a(D),
                            "w_gate": f32a(D, D), "b_gate": f32a(D)},
        "depthwise_conv": {"w": f32a(K, 1, D), "b": f32a(D)},
        "batch_norm": {"scale": 1.0 + f32a(D), "bias": f32a(D),
                       "mean": f32a(D), "var": 1.0 + np.abs(f32a(D))},
        "pointwise_conv2": {"w": f32a(D, D), "b": f32a(D)},
    }
    ln_p = {"scale": 1.0 + f32a(D), "bias": f32a(D)}
    x = 0.5 * rng.standard_normal((b, t, D))
    lens = np.full((b,), t)
    lens[1:] = max(1, t - 77)
    return ln_p, p, x, np.arange(t)[None, :] < lens[:, None]


def tree_to(tree, dev, matrices=None):
    """A tree of CPU tensors on ``dev``; with ``matrices`` a dtype, the
    leaves of two or more dimensions cast to it."""
    return {k: tree_to(v, dev, matrices) if isinstance(v, dict)
            else v.to(dev, matrices if matrices is not None and v.dim() >= 2
                      else v.dtype) for k, v in tree.items()}


def run(b: int, t: int, nb: int, probe: str = "ffn", device=None) -> dict:
    """One shape of one probe ("ffn": P4, "conv": P5), as the script's
    ``run``: the fold's error against the baseline and the three times."""
    _require(probe in PROBES, f"probe {probe!r} is none of {PROBES}")
    dev = torch.device("cuda" if device is None else device)
    dt = torch.bfloat16
    if probe == "ffn":
        ln_np, p_np, x_np = ffn_inputs(b, t)
    else:
        ln_np, p_np, x_np, valid_np = conv_inputs(b, t)
        valid = torch.from_numpy(valid_np).to(dev)
        mask = valid[..., None].to(dt)
    x = torch.from_numpy(x_np).to(dev, dt)
    ln_p = tree_to(sub_block_from_jax(ln_np), dev)
    p32 = tree_to(sub_block_from_jax(p_np), dev)
    p16 = tree_to(p32, dev, dt)

    if probe == "ffn":
        w = prepare_ffn(ln_p, p32, dt)
        lw = lean_ffn_weights(ln_p, p32, dt)
        base = lambda xx: ffn_baseline(ln_p, p16, xx)
        lean = lambda xx: ffn_lean(lw, xx)
        fold = lambda xx: ffn_fold(w, xx)
        got = ffn_lnres_folded(ln_p, p32, x, nb)
        tmin = t
    else:
        w = prepare_conv(ln_p, p32, dt)
        lw = lean_conv_weights(ln_p, p32, dt)
        base = lambda xx: conv_baseline(ln_p, p16, xx, valid)
        lean = lambda xx: conv_lean(lw, xx, mask)
        fold = lambda xx: conv_fold(w, xx, valid)
        got = conv_lnres_folded(ln_p, p32, x, valid, nb)
        tmin = int(valid_np.sum(axis=1).min())

    res = {"nb": nb}
    dt_b = device_timeit(base, [x], k=CALLS)
    res["baseline_us"] = round(dt_b * 1e6, 1)
    want = base(x).float()
    err = ((got.float() - want).abs() / (want.abs() + 1.0))[:, :tmin]
    res["maxrel"] = float(err.max())
    dt_l = device_timeit(lean, [x], k=CALLS)
    res["lean_us"] = round(dt_l * 1e6, 1)
    dt_f = device_timeit(fold, [x], k=CALLS)
    res[FOLD_KEY[probe]] = round(dt_f * 1e6, 1)
    res["delta_pct"] = round(100.0 * (dt_f - dt_b) / dt_b, 1)
    res["delta_lean_pct"] = round(100.0 * (dt_f - dt_l) / dt_l, 1)
    print(f"{probe} b{b} t{t} nb{nb}: baseline {res['baseline_us']} us, "
          f"lean {res['lean_us']} us, fold {res[FOLD_KEY[probe]]} us "
          f"({res['delta_pct']:+}% against the baseline, "
          f"{res['delta_lean_pct']:+}% against lean), maxrel "
          f"{res['maxrel']:.4f}", flush=True)
    return res


def main(device=None) -> dict:
    """Both scripts' ``main`` on ``device`` (the card when None): prints and
    returns the results by probe and shape."""
    out = {probe: {f"b{b}_t{t}": run(b, t, nb, probe, device)
                   for b, t, nb in SHAPES} for probe in PROBES}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
