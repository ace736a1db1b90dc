"""The attention-fold probes on the card (P6, P7, P8).

Counterpart of ``benchmarks/pallas_attn_fold_probe.py`` (P6, P7) and
``benchmarks/pallas_attn_lnres_probe.py`` (P8).  Each folds the rotary
attention module into one Pallas kernel on the TPU; on Hopper each is, like
K1/K2 (``ops/fused_attention.py``), four launches: the row pass, a Q/K/V
product, the SDPA and an output product.  P6 and P7 run on their redesign,
``csrc/attn_fold_ws.cu``: K1/K2's row pass, the two products on
``csrc/conv_ws.cuh``'s warp-specialised persistent cores and, between
them, P9's pipelined head walk with o stored packed (``csrc/sdpa_groups_
ws.cu``); each probe's question becomes a schedule of the cores:

  P7 foldB  folded_attention(..., per_head_weights=False)
            ``fold_lane_slices``: ping-pong (each consumer warpgroup owns
            whole tiles, one's epilogue under the other's products), 64 x
            256 tiles that straddle heads, in clusters of two with the
            weight boxes multicast (128 rows a box)
  P7 foldA  folded_attention(..., per_head_weights=True)
            ``fold_heads``: ping-pong, 64 x 192 tiles of four whole heads,
            Q and K read K-major from the per-head weight blocks
  P6        folded_attention_nb(..., nb)
            ``fold_nb``: more rows a weight box: nb 1 as foldB; nb 2
            cooperative 128 x 256 tiles (``WsCore``); nb 4 the same in
            clusters of two with the weight boxes multicast (256 rows a box)
  P8        lnres_folded(ln_params, ..., nb)
            ``fold_lnres``: K1's function (pre-LN x to x + attention(LN(x)))
            with the residual added to the fp32 accumulator and rounded once,
            on P6's stages at P6's schedule for its nb: K1's row pass with
            the LayerNorm, the Q/K/V product on xr (Q, K) and xn (V), the
            packed walk, and an output product with the fp32-residual
            epilogue (``csrc/attn_lnres_ws.cu``)

The kernels P6, P7 and P8 ran on before (``attn_fold_probe.cu``'s N-128 and
N-48 products around K3) stay reachable as ``fold_ring`` and ``lnres_ring``
for an A/B on the same card; they count no launch.  The redesign's stages
run alone as ``qkv_ws``, ``sdpa_packed_ws``, ``out_ws`` and
``out_residual_ws`` (after ``fa.ln_rope``), each beside its plain stage
(``qkv_plain``, ``sdpa_packed_plain``, ``out_plain``,
``out_residual_plain``; ``fold_staged_plain`` and ``lnres_staged_plain``
compose them and equal ``fold_plain`` and ``lnres_plain`` bit for bit); the
plans are pure functions (``fold_plans``).

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
from ..ops import fused_attention as fa
from ..ops.attention import rotary_mha
from ..ops.conformer_ops import layer_norm
from ..ops.attention import _split_heads
from ..ops.fused_attention import _check_tensor, _require, _stream
from ..ops.precision import full_fp32
from ..ops.rotary import rotary_tables
from ..profiling import device_timeit
from ..weights import sub_block_from_jax
from .fold_probes import tree_to
from .sdpa_ablation import _device_groups_plan
from .ws_plan import PP_BM, WS_BK, WS_BM, ws_plan

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


def _fold_of(w: AttnFoldWeights, heads: bool) -> fa.FoldedWeights:
    """The [D, D] weights that the plain versions multiply by: foldA's
    per-head blocks put back in place of Wq and Wk with ``heads``."""
    if not heads:
        return w.fold
    return dataclasses.replace(w.fold, wq=_heads_to_full(w.wq_heads),
                               wk=_heads_to_full(w.wk_heads))


def qkv_plain(w: AttnFoldWeights, xr: torch.Tensor, x: torch.Tensor,
              heads: bool = False):
    """The redesign's Q/K/V stage, plain: (q, k, v) [B, 16, T, 48] =
    bf16(xr Wq + bq), bf16(xr Wk + bk), bf16(x Wv + bv), products and bias
    in fp32; ``heads``: Wq and Wk from foldA's per-head blocks."""
    f = _fold_of(w, heads)
    dt = x.dtype
    with full_fp32():
        def proj(a: torch.Tensor, wm: torch.Tensor, bias: torch.Tensor):
            return _split_heads((a.float() @ wm.float() + bias).to(dt), H)

        return proj(xr, f.wq, f.bq), proj(xr, f.wk, f.bk), proj(x, f.wv, f.bv)


def sdpa_packed_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """The SDPA stage, plain: K3's (scale 1, Wq carries it), o packed [B, T,
    768], head h at columns 48 h .."""
    with full_fp32():
        o = fa._sdpa_plain(q, k, v, valid, 1.0)
        b, h, t, d = o.shape
        return o.transpose(1, 2).reshape(b, t, h * d)


def out_plain(w: AttnFoldWeights, o: torch.Tensor) -> torch.Tensor:
    """The output stage, plain: bf16(o Wo + bo), accumulated in fp32."""
    with full_fp32():
        return (o.float() @ w.fold.wo.float() + w.fold.bo).to(o.dtype)


def out_residual_plain(w: AttnFoldWeights, o: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """P8's output stage, plain: bf16(o Wo + bo + x), accumulated in fp32
    and rounded once (x the pre-LN input)."""
    with full_fp32():
        return (o.float() @ w.fold.wo.float() + w.fold.bo
                + x.float()).to(x.dtype)


def fold_staged_plain(w: AttnFoldWeights, x: torch.Tensor,
                      valid: torch.Tensor, heads: bool = False
                      ) -> torch.Tensor:
    """``fold_plain`` as the redesign's stages: the row pass, the Q/K/V
    stage, the SDPA with o packed, the output stage; the same values bit
    for bit."""
    with full_fp32():
        xr = fa.ln_rope_plain(x, w.cos, w.sin, H)[1]
        return out_plain(w, sdpa_packed_plain(*qkv_plain(w, xr, x, heads),
                                              valid))


def lnres_staged_plain(w: AttnFoldWeights, x: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """``lnres_plain`` as the redesign's stages: the row pass with the
    LayerNorm (xn, xr), the Q/K/V stage (Q, K on xr, V on xn), the SDPA
    with o packed, the output stage with the fp32 residual; the same values
    bit for bit."""
    f = w.fold
    with full_fp32():
        xn, xr = fa.ln_rope_plain(x, w.cos, w.sin, H, f.ln_scale, f.ln_bias)
        return out_residual_plain(
            w, sdpa_packed_plain(*qkv_plain(w, xr, xn), valid), x)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _check_args(w: AttnFoldWeights, x: torch.Tensor, valid: torch.Tensor,
                nb: int, heads: bool, lnres: bool) -> None:
    """What the card path takes: x [B, T, 768] bf16 with B T >= 1, nb in
    NB_TILES dividing B, the [T, 48] fp32 tables, valid [B, T] bool (None:
    a stage that reads no mask), the weights' shapes and dtypes (foldA: its
    [16, 48, 768] blocks), every tensor contiguous and 16-byte aligned on
    x's device."""
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
    if valid is not None:
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
    """Four launches of ``csrc/attn_fold_probe.cu``'s design (P6, P7 and
    P8's before their redesign): the row pass, a Q/K/V GEMM of the
    probe's library, K3's SDPA core and the probe's output GEMM.  Their
    scratch (xr, xn for P8, q, k, v and the SDPA output o, each [B*T, D]
    bf16) is one allocation, as in K1/K2's ``_folded_cuda``."""
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


# The redesign (csrc/attn_fold_ws.cu).  Its schedules (the source's
# Schedule), the wrappers' own, and their output tiles: (rows, columns,
# cluster).  foldB (and P6 at nb 1) on ping-pong tiles in clusters of two
# with the weight boxes multicast (128 rows a box), which took its Q/K/V
# product below the unshared ping-pong's; foldA's K-major per-head blocks
# ran slower multicast, so foldA's tiles are unshared (PERF.md section 6);
# P6 at nb 2 and 4 on cooperative 128-row tiles
LANE_SLICES, HEAD_TILES, COOP, COOP_CLUSTER = 0, 1, 2, 3
SCHEDULE_TILES = {LANE_SLICES: (PP_BM, 256, 2), HEAD_TILES: (PP_BM, 192, 1),
                  COOP: (WS_BM, 256, 1), COOP_CLUSTER: (WS_BM, 256, 2)}
FOLDB_SCHEDULE, FOLDA_SCHEDULE = LANE_SLICES, HEAD_TILES
NB_SCHEDULE = {1: LANE_SLICES, 2: COOP, 4: COOP_CLUSTER}
# P8's output product (csrc/attn_lnres_ws.cu) is built for P6's schedules
LNRES_SCHEDULES = tuple(NB_SCHEDULE.values())


def fold_plans(m: int, schedule: int, slots: int):
    """((units, grid) of the Q/K/V product, the same of the output
    product) for M rows on ``slots`` blocks: xr|x [M, 768] . [768, 2304],
    then o [M, 768] . Wo [768, 768], in the schedule's tiles: ``ws_plan``
    with K unsplit (12 items a unit; at the probes' smallest shape, B 1,
    T 500, the card still holds every unit at once).  On the ping-pong
    core unit i of a block runs on its consumer warpgroup i % 2."""
    bm, bn, cluster = SCHEDULE_TILES[schedule]
    row_tiles = -(-m // bm)
    return tuple(ws_plan(row_tiles, n // bn, D // WS_BK, slots, m * n, bn,
                         cluster, splits=1)[:2] for n in (3 * D, D))


@functools.lru_cache(maxsize=None)
def _fold_slots(schedule: int, index: int) -> int:
    """The schedule's persistent grids' ceiling on card ``index``: blocks
    (in its clusters) that the card holds at once, at most one an SM."""
    out = (ctypes.c_int * 1)()
    with torch.cuda.device(index):
        cuda_lib.check(cuda_lib.library("attn_fold_ws").gigaam_fold_ws_slots(
            schedule, out), "gigaam_fold_ws_slots")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return min(sms, out[0])


@functools.lru_cache(maxsize=None)
def _device_fold_plans(m: int, schedule: int, index: int):
    """``fold_plans`` on card ``index``, made once a shape: the first call
    copies the plans to the card, so it must not be under CUDA-graph
    capture."""
    return tuple((torch.from_numpy(units).to(f"cuda:{index}"), grid)
                 for units, grid in fold_plans(m, schedule,
                                               _fold_slots(schedule, index)))


def _launch_qkv_ws(w: AttnFoldWeights, xr: int, x: int, qkv, m: int,
                   t: int, schedule: int, dev) -> None:
    f = w.fold
    (units, grid), _ = _device_fold_plans(m, schedule, dev.index)
    wq, wk = ((w.wq_heads, w.wk_heads) if schedule == HEAD_TILES
              else (f.wq, f.wk))
    cuda_lib.check(cuda_lib.library("attn_fold_ws").gigaam_fold_ws_qkv(
        xr, x, wq.data_ptr(), wk.data_ptr(), f.wv.data_ptr(),
        f.bq.data_ptr(), f.bk.data_ptr(), f.bv.data_ptr(), *qkv,
        units.data_ptr(), len(units), grid, m, t, schedule, _stream(dev)),
        "gigaam_fold_ws_qkv")


def _launch_sdpa_ws(qkv, valid: torch.Tensor, o: int, b: int, t: int,
                    dev) -> None:
    units = _device_groups_plan(b, H, t, H, dev.index)
    cuda_lib.check(cuda_lib.library("attn_fold_ws").gigaam_fold_ws_sdpa(
        *qkv, valid.data_ptr(), o, units.data_ptr(), len(units), b, H, t,
        1.0, _stream(dev)), "gigaam_fold_ws_sdpa")


def _launch_out_ws(w: AttnFoldWeights, o: int, out: int, m: int,
                   schedule: int, dev) -> None:
    _, (units, grid) = _device_fold_plans(m, schedule, dev.index)
    cuda_lib.check(cuda_lib.library("attn_fold_ws").gigaam_fold_ws_out(
        o, w.fold.wo.data_ptr(), w.fold.bo.data_ptr(), out, units.data_ptr(),
        len(units), grid, m, schedule, _stream(dev)), "gigaam_fold_ws_out")


def _launch_out_residual_ws(w: AttnFoldWeights, o: int, x: int, out: int,
                            m: int, schedule: int, dev) -> None:
    _, (units, grid) = _device_fold_plans(m, schedule, dev.index)
    cuda_lib.check(cuda_lib.library("attn_lnres_ws").gigaam_lnres_ws_out(
        o, w.fold.wo.data_ptr(), w.fold.bo.data_ptr(), x, out,
        units.data_ptr(), len(units), grid, m, schedule, _stream(dev)),
        "gigaam_lnres_ws_out")


def _lnres_ws(w: AttnFoldWeights, x: torch.Tensor, valid: torch.Tensor,
              schedule: int) -> torch.Tensor:
    """P8 on the redesign (arguments checked by the caller): the row pass
    with the LayerNorm, the Q/K/V product (Q, K on xr, V on xn), the packed
    walk and the output product with the fp32 residual, their scratch (xr,
    xn, q, k, v, o, each [B*T, D] bf16) one allocation."""
    b, t, d = x.shape
    m, dev, f = b * t, x.device, w.fold
    n = m * d
    scratch = torch.empty(6 * n, dtype=x.dtype, device=dev)
    xr, xn, *qkv, o = (scratch.data_ptr() + 2 * n * i for i in range(6))
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        fa._launch_ln_rope(x, w.cos, w.sin, f.ln_scale, f.ln_bias, xn, xr,
                           _stream(dev))
        _launch_qkv_ws(w, xr, xn, qkv, m, t, schedule, dev)
        _launch_sdpa_ws(qkv, valid, o, b, t, dev)
        _launch_out_residual_ws(w, o, x.data_ptr(), out.data_ptr(), m,
                                schedule, dev)
    return out


def _fold_ws(w: AttnFoldWeights, x: torch.Tensor, valid: torch.Tensor,
             schedule: int) -> torch.Tensor:
    """The redesign's four launches (arguments checked by the caller): the
    row pass, the Q/K/V product, the packed walk and the output product,
    their scratch (xr, q, k, v, o, each [B*T, D] bf16) one allocation."""
    b, t, d = x.shape
    m, dev = b * t, x.device
    n = m * d
    scratch = torch.empty(5 * n, dtype=x.dtype, device=dev)
    xr, *qkv, o = (scratch.data_ptr() + 2 * n * i for i in range(5))
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        fa._launch_ln_rope(x, w.cos, w.sin, None, None, x.data_ptr(), xr,
                           _stream(dev))
        _launch_qkv_ws(w, xr, x.data_ptr(), qkv, m, t, schedule, dev)
        _launch_sdpa_ws(qkv, valid, o, b, t, dev)
        _launch_out_ws(w, o, out.data_ptr(), m, schedule, dev)
    return out


def _check_schedule(schedule: int) -> None:
    _require(schedule in SCHEDULE_TILES,
             f"schedule must be one of {sorted(SCHEDULE_TILES)}, got "
             f"{schedule}")


def qkv_ws(w: AttnFoldWeights, xr: torch.Tensor, x: torch.Tensor,
           schedule: int):
    """The redesign's Q/K/V product alone on the card (``qkv_plain`` on the
    CPU): xr, x [B, T, 768] bf16 -> (q, k, v) [B, 16, T, 48] in the
    schedule's tiles (the head schedules read foldA's per-head blocks).
    Counts no launch."""
    heads = schedule == HEAD_TILES
    if x.device.type == "cpu":
        return qkv_plain(w, xr, x, heads)
    _check_schedule(schedule)
    _check_args(w, x, None, 1, heads, False)
    _check_tensor("xr", xr, x.device, x.dtype, x.shape)
    b, t, _ = x.shape
    qkv = [torch.empty(b, H, t, DH, dtype=x.dtype, device=x.device)
           for _ in range(3)]
    with torch.cuda.device(x.device):
        _launch_qkv_ws(w, xr.data_ptr(), x.data_ptr(),
                       [a.data_ptr() for a in qkv], b * t, t, schedule,
                       x.device)
    return tuple(qkv)


def sdpa_packed_ws(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """The SDPA stage alone on the card (``sdpa_packed_plain`` on the CPU):
    q, k, v [B, 16, T, 48] bf16, valid [B, T] -> o [B, T, 768]: P9's walk
    (``csrc/sdpa_walk.cuh``, 16 heads a cell, ``groups_plan``) storing o
    packed.  Counts no launch."""
    if q.device.type == "cpu":
        return sdpa_packed_plain(q, k, v, valid)
    _require(q.dim() == 4 and q.shape[1:2] == (H,) and q.shape[3] == DH
             and q.numel() > 0, f"q must be [B, {H}, T, {DH}], got "
             f"{tuple(q.shape)}")
    b, _, t, _ = q.shape
    for name, a in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, a, q.device, torch.bfloat16, (b, H, t, DH))
    _check_tensor("valid", valid, q.device, torch.bool, (b, t))
    o = torch.empty(b, t, D, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _launch_sdpa_ws([a.data_ptr() for a in (q, k, v)], valid,
                        o.data_ptr(), b, t, q.device)
    return o


def out_ws(w: AttnFoldWeights, o: torch.Tensor, schedule: int
           ) -> torch.Tensor:
    """The output product alone on the card (``out_plain`` on the CPU): o
    [B, T, 768] bf16 packed -> bf16(o Wo + bo) in the schedule's tiles.
    Counts no launch."""
    if o.device.type == "cpu":
        return out_plain(w, o)
    _check_schedule(schedule)
    _require(o.dim() == 3 and o.shape[-1] == D and o.numel() > 0,
             f"o must be [B, T, {D}], got {tuple(o.shape)}")
    _check_tensor("o", o, o.device, torch.bfloat16, o.shape)
    fa._check_fold_weights(w.fold, D, o.device)
    out = torch.empty_like(o)
    with torch.cuda.device(o.device):
        _launch_out_ws(w, o.data_ptr(), out.data_ptr(),
                       o.shape[0] * o.shape[1], schedule, o.device)
    return out


def _check_lnres_schedule(schedule: int) -> None:
    _require(schedule in LNRES_SCHEDULES,
             f"P8's schedule must be one of {LNRES_SCHEDULES}, got "
             f"{schedule}")


def out_residual_ws(w: AttnFoldWeights, o: torch.Tensor, x: torch.Tensor,
                    schedule: int) -> torch.Tensor:
    """P8's output product alone on the card (``out_residual_plain`` on
    the CPU): o [B, T, 768] bf16 packed, x the pre-LN input -> bf16(o Wo +
    bo + x) in the schedule's tiles (``lnres_out_*_kernel``).  Counts no
    launch."""
    if o.device.type == "cpu":
        return out_residual_plain(w, o, x)
    _check_lnres_schedule(schedule)
    _require(o.dim() == 3 and o.shape[-1] == D and o.numel() > 0,
             f"o must be [B, T, {D}], got {tuple(o.shape)}")
    _check_tensor("o", o, o.device, torch.bfloat16, o.shape)
    _check_tensor("x", x, o.device, torch.bfloat16, o.shape)
    fa._check_fold_weights(w.fold, D, o.device)
    out = torch.empty_like(o)
    with torch.cuda.device(o.device):
        _launch_out_residual_ws(w, o.data_ptr(), x.data_ptr(),
                                out.data_ptr(), o.shape[0] * o.shape[1],
                                schedule, o.device)
    return out


def fold_ws(w: AttnFoldWeights, x: torch.Tensor, valid: torch.Tensor,
            schedule: int) -> torch.Tensor:
    """P6/P7's function on the redesign in any of its schedules (the
    wrappers each run theirs), arguments checked; ``fold_plain`` on the
    CPU.  Counts no launch."""
    heads = schedule == HEAD_TILES
    if x.device.type == "cpu":
        return fold_plain(w, x, valid, heads=heads)
    _check_schedule(schedule)
    _check_args(w, x, valid, 1, heads, False)
    return _fold_ws(w, x, valid, schedule)


def fold_ring(w: AttnFoldWeights, x: torch.Tensor, valid: torch.Tensor,
              nb: int = 1, heads: bool = False) -> torch.Tensor:
    """P6/P7 on the design the redesign replaced: ``csrc/attn_fold_probe.
    cu``'s N-128 (``heads``: N-48 per-head) Q/K/V GEMM at 64 nb-row tiles,
    K3's SDPA and its output GEMM, after the row pass.  Card only; counts no
    launch: kept for an A/B on the same card."""
    _require(x.device.type == "cuda", "fold_ring runs on the card only")
    return _fold_cuda(w, x, valid, nb, heads=heads)


def lnres_ring(w: AttnFoldWeights, x: torch.Tensor, valid: torch.Tensor,
               nb: int) -> torch.Tensor:
    """P8 on the design the redesign replaced: ``csrc/attn_fold_probe.
    cu``'s row pass with the LayerNorm, ``qkv_kernel<nb, 128>``, K3's SDPA
    and ``out_proj_kernel<nb, 128, 2>`` (bo and x added to the fp32
    accumulator).  Card only; counts no launch: kept for an A/B on the same
    card."""
    _require(x.device.type == "cuda", "lnres_ring runs on the card only")
    return _fold_cuda(w, x, valid, nb, lnres=True)


def _refuse_grad(name: str, w: AttnFoldWeights, x: torch.Tensor) -> None:
    fa._refuse_grad(name, (x, *fa._weight_tensors(w.fold)))


def fold_lane_slices(w: AttnFoldWeights, x: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """P7 foldB: post-LN x [B, T, 768] -> the module output, the products
    on 64 x 256 tiles that straddle heads, the store splitting them per
    head, on the ping-pong schedule in clusters of two with the weight
    boxes multicast (``fold_qkv_pp_kernel<256, 2, false>``,
    ``fold_out_pp_kernel<256, 2>``) around the packed walk; ``fold_plain``
    on the CPU."""
    _refuse_grad("fold_lane_slices", w, x)
    if x.device.type == "cpu":
        return fold_plain(w, x, valid)
    _check_args(w, x, valid, 1, False, False)
    out = _fold_ws(w, x, valid, FOLDB_SCHEDULE)
    fold_lane_slices.launches += 1
    return out


def fold_heads(w: AttnFoldWeights, x: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """P7 foldA: as ``fold_lane_slices``, with q and k from the per-head
    blocks, on 64 x 192 tiles of four whole heads
    (``fold_qkv_pp_kernel<192, 1, true>``, ``fold_out_pp_kernel<192,
    1>``)."""
    _refuse_grad("fold_heads", w, x)
    if x.device.type == "cpu":
        return fold_plain(w, x, valid, heads=True)
    _check_args(w, x, valid, 1, True, False)
    out = _fold_ws(w, x, valid, FOLDA_SCHEDULE)
    fold_heads.launches += 1
    return out


def fold_nb(w: AttnFoldWeights, x: torch.Tensor, valid: torch.Tensor,
            nb: int) -> torch.Tensor:
    """P6: as ``fold_lane_slices`` with more rows a weight box: nb 1 on
    foldB's schedule, nb 2 on cooperative 128 x 256 tiles
    (``fold_qkv_coop_kernel<1>``, ``fold_out_coop_kernel<1>``), nb 4 the
    same in clusters of two with the weight boxes multicast (``<2>``)."""
    _refuse_grad("fold_nb", w, x)
    if x.device.type == "cpu":
        return fold_plain(w, x, valid)
    _check_args(w, x, valid, nb, False, False)
    out = _fold_ws(w, x, valid, NB_SCHEDULE[nb])
    fold_nb.launches += 1
    return out


def fold_lnres(w: AttnFoldWeights, x: torch.Tensor, valid: torch.Tensor,
               nb: int) -> torch.Tensor:
    """P8: pre-LN x [B, T, 768] -> x + attention(LN(x)), the residual
    added to the output product's fp32 accumulator, on P6's schedule for
    ``nb`` (nb 1: ping-pong 64 x 256 in clusters of two; nb 2: cooperative
    128 x 256; nb 4: the same in clusters of two; the output product
    ``lnres_out_pp_kernel<256, 2>``, ``lnres_out_coop_kernel<1>``,
    ``<2>``); ``lnres_plain`` on the CPU."""
    _refuse_grad("fold_lnres", w, x)
    if x.device.type == "cpu":
        return lnres_plain(w, x, valid)
    _check_args(w, x, valid, nb, False, True)
    out = _lnres_ws(w, x, valid, NB_SCHEDULE[nb])
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
