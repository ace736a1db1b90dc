"""The SDPA ablation on the card: where does K3's time go?

Counterpart of ``benchmarks/sdpa_ablation.py``.  K3's function (masked SDPA,
``_attn_kernel``) and variants of it, each changing one thing, measured
standalone at the v3 shape (B 8 x T' 501, 16 heads of 48):

  label                body             computes
  A_full               k_full           K3's function
  F_copy_only          k_copy           o = q: the cost of a block
  B_two_matmuls        k_scores_only    bf16(bf16(q.k^T).v): the products alone
  D_no_max_pass        k_no_max         A with exp(s - 20) for the row max
  E_prescaled_q        k_prescaled      A without the scale multiply
  E2_madd_row          k_maddrow        no scale, the mask an fp32 additive row
  G_bf16_softmax       k_bf16_softmax   E2 with the exponential in bf16
  I_allheads_cell      k_allheads       A, one block walks 16 heads
  J_4heads_cell        k_allheads       A, one block walks 4 heads
  K_identity_maps      k_full           A, the mask pre-broadcast per head
  H_packed_lane_slice  k_full_packed    A on the packed [B, T, H*48] layout

Only A, I, J, K and H compute K3's function; the rest are read for their
time.  On a card:

    python3 -m gigaam_tpu_torch.probes.sdpa_ablation
    SDPA_ABLATION_FULLSET=1 SDPA_ABLATION_PACKED=1 \\
        python3 -m gigaam_tpu_torch.probes.sdpa_ablation

prints a line per label and, last, a JSON object of microseconds per call by
label (``gigaam_tpu_torch.profiling.device_timeit``, chained, 100 calls a
run), as the script does; the two switches add the same labels.

A, B, D, E, E2, G and K run the per-head walk's redesign,
``csrc/sdpa_heads_ws.cu``: persistent blocks, one an SM, each walking a run
of ``heads_plan``'s units (a head and a pair of query tiles), a producer
warp filling one K/V ring that two consumer warpgroups read, one query tile
each; the kernels it replaced, of ``csrc/sdpa_ablation.cu`` on K3's own
body (``csrc/sdpa_core.cuh``, whose full variant in the head-major layout
is K3's code), stay reachable as ``heads_sdpa_kept`` for an A/B on the same
card (it counts no launch).  F, the copy, stays on its kernel of
``csrc/sdpa_ablation.cu``, which reads at its byte bound.  I
and J run the head-group walk's redesign, ``csrc/sdpa_groups_ws.cu``: a
producer warp and two consumer warpgroups, one block a run of a cell's
heads by ``groups_plan``; the head-group layout of ``csrc/sdpa_ablation.cu``
stays reachable as ``allheads_sdpa_serial`` for an A/B on the same card (it
counts no launch).  H runs the walk's packed instance,
``csrc/sdpa_packed_heads_ws.cu`` (the same device code,
``csrc/sdpa_heads_walk.cuh``, each head's tiles read through a 4-D tensor
map of [B, T, H, 48] and o stored packed); K3's body in the packed layout of
``csrc/sdpa_ablation.cu`` stays reachable as ``packed_sdpa_kept`` (no launch
counted).
Beside each wrapper is the plain version of its Pallas body, in the
body's full-row form: fp32 scores, the masked term ``(mask - 1) * 1e9``,
``scale = 1/sqrt(48)``, P cast to bf16 before P.V and the division after.
The kernels take the softmax online over 64-key tiles, which differs from
the full row by rounding only.  A wrapper takes the plain version for tensors
on the CPU; for CUDA tensors it launches its kernel or raises.
``<wrapper>.launches`` counts its launches.
"""

from __future__ import annotations

import functools
import json
import math
import os

import numpy as np
import torch

from ..ops import cuda_lib
from ..ops.fused_attention import _check_tensor, _require, _stream
from ..ops.precision import full_fp32
from ..profiling import device_timeit

B, H, T, D = 8, 16, 501, 48
NEG_INF = -1e9
SCALE = 1.0 / math.sqrt(D)

# csrc/sdpa_core.cuh: SdpaVariant and SdpaLayout
_FULL, _COPY, _TWO_PRODUCTS, _NO_MAX, _NO_SCALE, _MADD_ROW, _BF16_EXP = range(7)
_HEADS, _HEAD_GROUPS, _MASK_PER_HEAD, _PACKED = range(4)


# ---------------------------------------------------------------------------
# Plain versions, one per Pallas body.  q, k, v [N, T, 48] with mask (or
# madd) [N, 1, T]: one row of the grid's cells each.
# ---------------------------------------------------------------------------

def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a . b`` in fp32, as ``dot_general`` with an fp32 result."""
    with full_fp32():
        return a.float() @ b.float()


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return _product(q, k.transpose(-1, -2))


def _mask_term(mask: torch.Tensor) -> torch.Tensor:
    return (mask.float() - 1.0) * (-NEG_INF)


def _finish(p, denom, v, like) -> torch.Tensor:
    """``(bf16(p) . v) / denom`` in ``like``'s dtype."""
    return (_product(p.to(v.dtype), v) / denom).to(like.dtype)


def _softmax_out(s, v, like, shift=None) -> torch.Tensor:
    """``exp(s - m) . v / sum exp(s - m)`` with m the row max, or ``shift``."""
    p = torch.exp(s - (s.amax(dim=-1, keepdim=True) if shift is None
                       else shift))
    return _finish(p, p.sum(dim=-1, keepdim=True), v, like)


def full_plain(q, k, v, mask):
    """``k_full``: K3's function."""
    return _softmax_out(_scores(q, k) * SCALE + _mask_term(mask), v, q)


def copy_plain(q, k, v, mask):
    """``k_copy``: o = q."""
    return q.clone()


def scores_only_plain(q, k, v, mask):
    """``k_scores_only``: ``bf16(bf16(q . k^T) . v)``; no scale, no mask."""
    return _product(_scores(q, k).to(v.dtype), v).to(q.dtype)


def no_max_plain(q, k, v, mask):
    """``k_no_max``: ``k_full`` with ``exp(s - 20)`` for ``exp(s - max)``."""
    return _softmax_out(_scores(q, k) * SCALE + _mask_term(mask), v, q,
                        shift=20.0)


def prescaled_plain(q, k, v, mask):
    """``k_prescaled``: ``k_full`` without the scale."""
    return _softmax_out(_scores(q, k) + _mask_term(mask), v, q)


def maddrow_plain(q, k, v, madd):
    """``k_maddrow``: no scale, ``madd`` the fp32 additive mask."""
    return _softmax_out(_scores(q, k) + madd, v, q)


def bf16_softmax_plain(q, k, v, madd):
    """``k_bf16_softmax``: ``k_maddrow`` with ``p = exp(bf16(s - max))``
    in bf16, summed in fp32."""
    s = _scores(q, k) + madd
    p = torch.exp((s - s.amax(dim=-1, keepdim=True)).to(torch.bfloat16))
    return _finish(p, p.float().sum(dim=-1, keepdim=True), v, q)


def allheads_plain(q4, k4, v4, mask):
    """``k_allheads``: ``k_full`` on [B, H, T, 48], mask [B, 1, T]."""
    return full_plain(q4, k4, v4, mask[:, None])


def _split(x3: torch.Tensor) -> torch.Tensor:
    """[B, T, H*48] -> [B, H, T, 48]"""
    b, t, hd = x3.shape
    return x3.reshape(b, t, hd // D, D).transpose(1, 2)


def full_packed_plain(q3, k3, v3, mask):
    """``k_full_packed``: ``k_full`` on the packed [B, T, H*48], head h the
    columns 48 h .. 48 h + 47; mask [B, 1, T]."""
    o = full_plain(_split(q3), _split(k3), _split(v3), mask[:, None])
    return o.transpose(1, 2).reshape(q3.shape)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _check_qkv(q, k, v, shape) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, x, q.device, torch.bfloat16, shape)


def _check_mask(mask, device, madd: bool, shape) -> None:
    """The script's mask: int8 0/1 flags, or the fp32 additive row."""
    _check_tensor("madd" if madd else "mask", mask, device,
                  torch.float32 if madd else torch.int8, shape)


def _launch(variant: int, layout: int, q, k, v, mask, batch: int,
            n_heads: int, t: int, heads_per_block: int = 1) -> torch.Tensor:
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        cuda_lib.check(cuda_lib.library("sdpa_ablation").gigaam_sdpa_ablation(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), variant, layout, batch, n_heads, t,
            heads_per_block, SCALE, _stream(q.device)), "gigaam_sdpa_ablation")
    return out


# The plan of the per-head walk's redesign (csrc/sdpa_heads_ws.cu)

def heads_plan(n_bh: int, t: int, slots: int) -> np.ndarray:
    """int32 [blocks, 2], one persistent block each: (first unit, units).
    A unit is (head bh, a pair of 64-row query tiles), numbered ``bh *
    pairs + pair``, so that the units of a head are neighbours (they read
    the same keys); the units are cut into ``min(units, slots)`` contiguous
    runs whose lengths differ by one at most, the longer first."""
    pairs = -(-(-(-t // 64)) // 2)
    units = n_bh * pairs
    blocks = min(units, slots)
    counts = units // blocks + (np.arange(blocks) < units % blocks)
    firsts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.stack([firsts, counts], axis=1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _device_heads_plan(n_bh: int, t: int, index: int) -> torch.Tensor:
    """``heads_plan`` on card ``index``, one block an SM, made once a shape:
    the first call of a shape copies it to the card, so it must not be under
    CUDA-graph capture."""
    return torch.from_numpy(heads_plan(n_bh, t, _sm_count(index))).to(
        f"cuda:{index}")


def _walk(variant: int, layout: int, q, k, v, mask, batch: int,
          n_heads: int, t: int, plan=None, out=None) -> torch.Tensor:
    """``sdpa_heads_ws_kernel`` of ``variant`` on q, k, v [B*H, T, 48] into
    ``out`` (new when None), by ``plan`` (``heads_plan``'s, on the card;
    the device plan of the shape when None)."""
    if plan is None:
        plan = _device_heads_plan(batch * n_heads, t, q.device.index)
    out = torch.empty_like(q) if out is None else out
    with torch.cuda.device(q.device):
        cuda_lib.check(cuda_lib.library("sdpa_heads_ws").gigaam_sdpa_heads_ws(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), plan.data_ptr(), len(plan), variant, layout,
            batch, n_heads, t, SCALE, _stream(q.device)),
            "gigaam_sdpa_heads_ws")
    return out


def _check_heads(variant: int, q, k, v, mask):
    """(B, H, T) of a ``run`` kernel's q, k, v [B*H, T, 48] and mask (or
    madd) [B, 1, T]."""
    n, t = q.shape[:2]
    b = mask.shape[0]
    _require(q.dim() == 3 and n % b == 0,
             f"q must be [B*H, T, {D}] for a mask [B, 1, T], got "
             f"{tuple(q.shape)} and {tuple(mask.shape)}")
    _check_qkv(q, k, v, (n, t, D))
    _check_mask(mask, q.device, variant in (_MADD_ROW, _BF16_EXP), (b, 1, t))
    return b, n // b, t


def _heads_call(wrapper, variant: int, plain, q, k, v, mask):
    """A ``run`` kernel: q, k, v [B*H, T, 48], mask [B, 1, T]; cell (b, h)
    reads mask row b (the script's index map ``i // H``).  On the card the
    per-head walk, but for the copy, which keeps its kernel."""
    n = q.shape[0]
    if q.device.type == "cpu":
        return plain(q, k, v, mask.repeat_interleave(n // mask.shape[0],
                                                     dim=0))
    b, h, t = _check_heads(variant, q, k, v, mask)
    route = _launch if variant == _COPY else _walk
    out = route(variant, _HEADS, q, k, v, mask, b, h, t)
    wrapper.launches += 1
    return out


def full_sdpa(q, k, v, mask):
    """A_full (``k_full``).  q, k, v [B*H, T, 48] bf16, mask [B, 1, T] int8
    of 0/1 -> [B*H, T, 48]."""
    return _heads_call(full_sdpa, _FULL, full_plain, q, k, v, mask)


def copy_sdpa(q, k, v, mask):
    """F_copy_only (``k_copy``), as ``full_sdpa``."""
    return _heads_call(copy_sdpa, _COPY, copy_plain, q, k, v, mask)


def scores_only_sdpa(q, k, v, mask):
    """B_two_matmuls (``k_scores_only``), as ``full_sdpa``."""
    return _heads_call(scores_only_sdpa, _TWO_PRODUCTS, scores_only_plain,
                       q, k, v, mask)


def no_max_sdpa(q, k, v, mask):
    """D_no_max_pass (``k_no_max``), as ``full_sdpa``."""
    return _heads_call(no_max_sdpa, _NO_MAX, no_max_plain, q, k, v, mask)


def prescaled_sdpa(q, k, v, mask):
    """E_prescaled_q (``k_prescaled``), as ``full_sdpa``."""
    return _heads_call(prescaled_sdpa, _NO_SCALE, prescaled_plain,
                       q, k, v, mask)


def maddrow_sdpa(q, k, v, madd):
    """E2_madd_row (``k_maddrow``): as ``full_sdpa`` with ``madd`` [B, 1,
    T] fp32, the additive mask."""
    return _heads_call(maddrow_sdpa, _MADD_ROW, maddrow_plain, q, k, v, madd)


def bf16_softmax_sdpa(q, k, v, madd):
    """G_bf16_softmax (``k_bf16_softmax``), as ``maddrow_sdpa``."""
    return _heads_call(bf16_softmax_sdpa, _BF16_EXP, bf16_softmax_plain,
                       q, k, v, madd)


# The plan of the head-group walk's redesign (csrc/sdpa_groups_ws.cu): a
# unit's fixed cost in key-tile steps (its first Q load, the ring's fill,
# the epilogue)
GROUP_UNIT_STEPS = 2


def groups_cost(cells: int, parts: int, heads_per_block: int, t: int,
                slots: int) -> int:
    """The modelled time, in key-tile steps of one consumer warpgroup, of
    cutting each of ``cells`` cells of ``heads_per_block`` heads into
    ``parts`` runs, one block a run and one block an SM of ``slots``: the
    waves of blocks, each a run's heads split over the two consumers
    walking T's key tiles, plus ``GROUP_UNIT_STEPS``."""
    run = heads_per_block // parts
    waves = -(-cells * parts // slots)
    return waves * (-(-run // 2) * -(-t // 64) + GROUP_UNIT_STEPS)


def groups_plan(batch: int, n_heads: int, t: int, heads_per_block: int,
                slots: int) -> np.ndarray:
    """units int32 [U, 4], one block each: (batch element, 64-row query
    tile, first head, heads).  A cell (query tile, group of
    ``heads_per_block`` heads, batch element) is cut into runs of equal
    length, a divisor of the group, of least ``groups_cost`` (the fewest
    runs on a tie); a unit is one run, so a block walks a contiguous run of
    one cell's heads.  Units of one batch element and head run are
    neighbours across the query tiles (they read the same keys)."""
    q_tiles = -(-t // 64)
    groups = n_heads // heads_per_block
    cells = batch * q_tiles * groups
    divisors = [d for d in range(1, heads_per_block + 1)
                if heads_per_block % d == 0]
    parts = min(divisors, key=lambda d: (
        groups_cost(cells, d, heads_per_block, t, slots), d))
    run = heads_per_block // parts
    units = [(b, qt, g * heads_per_block + p * run, run)
             for b in range(batch) for g in range(groups)
             for p in range(parts) for qt in range(q_tiles)]
    return np.asarray(units, dtype=np.int32).reshape(-1, 4)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _device_groups_plan(batch: int, n_heads: int, t: int,
                        heads_per_block: int, index: int) -> torch.Tensor:
    """``groups_plan`` on card ``index``, made once a shape: the first call
    of a shape copies it to the card, so it must not be under CUDA-graph
    capture."""
    return torch.from_numpy(groups_plan(
        batch, n_heads, t, heads_per_block, _sm_count(index))).to(
            f"cuda:{index}")


def _check_allheads(q4, k4, v4, mask, heads_per_block: int):
    _require(q4.dim() == 4, f"q must be [B, H, T, {D}], got {tuple(q4.shape)}")
    b, h, t = q4.shape[:3]
    _require(heads_per_block >= 1 and h % heads_per_block == 0,
             f"heads_per_block {heads_per_block} does not divide H = {h}")
    _check_qkv(q4, k4, v4, (b, h, t, D))
    _check_mask(mask, q4.device, False, (b, 1, t))
    return b, h, t


def allheads_sdpa(q4, k4, v4, mask, heads_per_block: int = H):
    """I_allheads_cell / J_4heads_cell (``k_allheads``): q, k, v [B, H, T,
    48], mask [B, 1, T]; on the card ``sdpa_groups_ws_kernel``, one block a
    run of a cell's heads (``groups_plan``; a cell is a 64-row query tile,
    a group of ``heads_per_block`` heads and a batch element), its two
    consumer warpgroups walking the run's heads in turn; ``allheads_plain``
    on the CPU."""
    if q4.device.type == "cpu":
        return allheads_plain(q4, k4, v4, mask)
    b, h, t = _check_allheads(q4, k4, v4, mask, heads_per_block)
    units = _device_groups_plan(b, h, t, heads_per_block, q4.device.index)
    out = torch.empty_like(q4)
    with torch.cuda.device(q4.device):
        cuda_lib.check(cuda_lib.library("sdpa_groups_ws")
                       .gigaam_sdpa_groups_ws(
                           q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                           mask.data_ptr(), out.data_ptr(), units.data_ptr(),
                           len(units), b, h, t, SCALE, _stream(q4.device)),
                       "gigaam_sdpa_groups_ws")
    allheads_sdpa.launches += 1
    return out


def allheads_sdpa_serial(q4, k4, v4, mask, heads_per_block: int = H):
    """``allheads_sdpa`` on the design the redesign replaced: K3's body in
    the head-group layout of ``csrc/sdpa_ablation.cu``, one warpgroup a
    (query tile, group, batch element) walking the group's heads in turn.
    Card only; counts no launch: kept for an A/B on the same card."""
    b, h, t = _check_allheads(q4, k4, v4, mask, heads_per_block)
    return _launch(_FULL, _HEAD_GROUPS, q4, k4, v4, mask, b, h, t,
                   heads_per_block)


def _check_identity(q, k, v, mask_bh):
    _require(q.dim() == 3, f"q must be [B*H, T, {D}], got {tuple(q.shape)}")
    n, t = q.shape[:2]
    _check_qkv(q, k, v, (n, t, D))
    _check_mask(mask_bh, q.device, False, (n, 1, t))
    return n, t


def identity_maps_sdpa(q, k, v, mask_bh):
    """K_identity_maps (``k_full`` with the mask per cell): q, k, v [B*H, T,
    48], mask_bh [B*H, 1, T]; cell i reads mask row i.  On the card the
    per-head walk."""
    if q.device.type == "cpu":
        return full_plain(q, k, v, mask_bh)
    n, t = _check_identity(q, k, v, mask_bh)
    # one batch element of n heads: mask row b * n_heads + h = h
    out = _walk(_FULL, _MASK_PER_HEAD, q, k, v, mask_bh, 1, n, t)
    identity_maps_sdpa.launches += 1
    return out


# the wrappers on the per-head walk: (variant, layout) of each
_HEADS_WS = {"full_sdpa": (_FULL, _HEADS),
             "scores_only_sdpa": (_TWO_PRODUCTS, _HEADS),
             "no_max_sdpa": (_NO_MAX, _HEADS),
             "prescaled_sdpa": (_NO_SCALE, _HEADS),
             "maddrow_sdpa": (_MADD_ROW, _HEADS),
             "bf16_softmax_sdpa": (_BF16_EXP, _HEADS),
             "identity_maps_sdpa": (_FULL, _MASK_PER_HEAD)}


def heads_sdpa_kept(wrapper, q, k, v, mask):
    """``wrapper`` (one of ``_HEADS_WS``: a P12 body or P10) on the design
    the per-head walk replaced: K3's body in ``csrc/sdpa_ablation.cu``, one
    warpgroup a (64-row query tile, head, batch element).  Card only;
    counts no launch: kept for an A/B on the same card."""
    variant, layout = _HEADS_WS[wrapper.__name__]
    if layout == _MASK_PER_HEAD:
        b, (h, t) = 1, _check_identity(q, k, v, mask)
    else:
        b, h, t = _check_heads(variant, q, k, v, mask)
    return _launch(variant, layout, q, k, v, mask, b, h, t)


def _check_packed(q3, k3, v3, mask):
    """(B, H, T) of q, k, v [B, T, H*48] and mask [B, 1, T]."""
    _require(q3.dim() == 3 and q3.shape[-1] % D == 0,
             f"q must be [B, T, H*{D}], got {tuple(q3.shape)}")
    b, t, hd = q3.shape
    _check_qkv(q3, k3, v3, (b, t, hd))
    _check_mask(mask, q3.device, False, (b, 1, t))
    return b, hd // D, t


def _packed_walk(q3, k3, v3, mask, b: int, t: int, plan=None, out=None,
                 flat: int = -1) -> torch.Tensor:
    """``sdpa_packed_heads_ws_kernel`` on q, k, v [B, T, 16*48] into ``out``
    (new when None), by ``plan`` (``heads_plan``'s over the B*16 heads, on
    the card; the device plan of the shape when None).  ``flat`` >= 0 reads
    each tile through a 3-D map over the flat columns at column 48 h +
    ``flat``: a slip that ``chip_smoke.py`` plants."""
    if plan is None:
        plan = _device_heads_plan(b * H, t, q3.device.index)
    out = torch.empty_like(q3) if out is None else out
    with torch.cuda.device(q3.device):
        cuda_lib.check(cuda_lib.library("sdpa_packed_heads_ws")
                       .gigaam_sdpa_packed_heads_ws(
                           q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                           mask.data_ptr(), out.data_ptr(), plan.data_ptr(),
                           len(plan), b, H, t, flat, SCALE,
                           _stream(q3.device)),
                       "gigaam_sdpa_packed_heads_ws")
    return out


def packed_sdpa(q3, k3, v3, mask):
    """H_packed_lane_slice (``k_full_packed``): q, k, v [B, T, H*48] ->
    [B, T, H*48], head h the columns 48 h .. 48 h + 47; mask [B, 1, T].  On
    the card the per-head walk's packed instance
    (``csrc/sdpa_packed_heads_ws.cu``, H = 16 only), each head's tiles read
    through a 4-D tensor map of [B, T, H, 48]."""
    if q3.device.type == "cpu":
        return full_packed_plain(q3, k3, v3, mask)
    b, h, t = _check_packed(q3, k3, v3, mask)
    _require(h == H, f"packed_sdpa takes {H} heads on the card, got {h}")
    out = _packed_walk(q3, k3, v3, mask, b, t)
    packed_sdpa.launches += 1
    return out


def packed_sdpa_kept(q3, k3, v3, mask):
    """``packed_sdpa`` on the design the walk replaced: K3's body in the
    packed layout of ``csrc/sdpa_ablation.cu``, one warpgroup a (64-row
    query tile, head, batch element).  Card only; counts no launch: kept for
    an A/B on the same card."""
    b, h, t = _check_packed(q3, k3, v3, mask)
    return _launch(_FULL, _PACKED, q3, k3, v3, mask, b, h, t)


KERNELS = (full_sdpa, copy_sdpa, scores_only_sdpa, no_max_sdpa,
           prescaled_sdpa, maddrow_sdpa, bf16_softmax_sdpa, allheads_sdpa,
           identity_maps_sdpa, packed_sdpa)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# Runners: each times one kernel and fills results[label] in microseconds
# ---------------------------------------------------------------------------

def _time(label: str, call, x, results: dict) -> None:
    us = device_timeit(call, [x], k=100, chain=True) * 1e6
    results[label] = round(us, 1)
    print(f"{label:24s} {us:8.1f} us", flush=True)


def run_allheads(q, k, v, mask, label, results, heads_per_cell=H):
    """``allheads_sdpa`` on q, k, v [B*H, T, 48] viewed as [B, H, T, 48]."""
    q4, k4, v4 = (x.reshape(mask.shape[0], -1, *x.shape[1:])
                  for x in (q, k, v))
    _time(label, lambda qq: allheads_sdpa(qq, k4, v4, mask, heads_per_cell),
          q4, results)


def run_identity_maps(q, k, v, mask, label, results):
    """``identity_maps_sdpa`` with the mask [B, 1, T] broadcast to [B*H, 1,
    T]."""
    mask_bh = mask.repeat_interleave(q.shape[0] // mask.shape[0], dim=0)
    _time(label, lambda qq: identity_maps_sdpa(qq, k, v, mask_bh), q,
          results)


def run_packed(q3, k3, v3, mask, label, results):
    """``packed_sdpa`` on q3, k3, v3 [B, T, H*48]."""
    _time(label, lambda qq: packed_sdpa(qq, k3, v3, mask), q3, results)


def run(kernel, q, k, v, mask, label, results):
    """One of the head-major wrappers (``full_sdpa`` ... ``bf16_softmax_sdpa``)
    on q, k, v [B*H, T, 48] and mask (or madd) [B, 1, T]."""
    _time(label, lambda qq: kernel(qq, k, v, mask), q, results)


def main(device=None) -> dict:
    """The script's ``main`` on ``device`` (the card when None): prints and
    returns the microseconds per call by label."""
    dev = torch.device("cuda" if device is None else device)
    rng = np.random.default_rng(0)
    bh = B * H
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, T, D)))
               .to(dev, torch.bfloat16) for _ in range(3))
    mask = torch.ones((B, 1, T), dtype=torch.int8, device=dev)
    madd = torch.zeros((B, 1, T), dtype=torch.float32, device=dev)

    results = {}
    run(full_sdpa, q, k, v, mask, "A_full", results)
    run(copy_sdpa, q, k, v, mask, "F_copy_only", results)
    run_allheads(q, k, v, mask, "I_allheads_cell", results)
    run_allheads(q, k, v, mask, "J_4heads_cell", results, heads_per_cell=4)
    run_identity_maps(q, k, v, mask, "K_identity_maps", results)
    if os.environ.get("SDPA_ABLATION_FULLSET"):
        run(scores_only_sdpa, q, k, v, mask, "B_two_matmuls", results)
        run(no_max_sdpa, q, k, v, mask, "D_no_max_pass", results)
        run(prescaled_sdpa, q, k, v, mask, "E_prescaled_q", results)
        run(maddrow_sdpa, q, k, v, madd, "E2_madd_row", results)
        run(bf16_softmax_sdpa, q, k, v, madd, "G_bf16_softmax", results)
    if os.environ.get("SDPA_ABLATION_PACKED"):
        q3 = q.reshape(B, H, T, D).transpose(1, 2).reshape(B, T, H * D)
        run_packed(q3, q3, q3, mask, "H_packed_lane_slice", results)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
