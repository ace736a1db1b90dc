"""The conv2d-subsampling probes on the card (P1-P3).

Counterpart of ``benchmarks/pallas_subsampling_probe.py``.  The
subsampling's second stage is a 3x3 stride-2 conv from 768 to 768 channels.
Split its zero-padded input X [2T + 1, 33, 768] (time, frequency, channel)
by the parity of each coordinate into four blocks, ee = X[1::2, 1::2]
[T, 16], eo = X[1::2, 0::2] [T, 17], oe = X[0::2, 1::2] [T + 1, 16] and oo
= X[0::2, 0::2] [T + 1, 17]; the conv's output (t, f) is then the sum of nine
taps, each a row of one block at (t + dt, f + df) times a [768, 768] weight
(``TAPS_WITH_COPIES``, ``TAP_POSITIONS``).  Each probe is a hand-written
Hopper kernel:

  P1  taps_product(ee, eo, oe, oo, w, taps)   bf16(sum_i tap_i . w[i])
  P2  im2col_product(ee, eo, oe, oo, w, wl)   one K-6912 product over the
      [M, 6912] patch of the nine taps: bf16(patch . w) at frequency row 0
      of each step, or with wl bf16(bf16(relu(patch . w)) viewed [T, 12288]
      . wl)
  P3  smem_copy(x, n_bytes)                   2 x through the top of a
      dynamic shared-memory buffer of n_bytes, and the blocks an SM holds

P1 and P2 run on ``csrc/subsampling_ws.cu``: a warp-specialised, persistent
implicit GEMM (``csrc/conv_ws.cuh``) whose A tiles are 4-D TMA boxes of the
blocks at each tap's offset, so P2's patch is only ever a view: no
[M, 6912] tensor is written.  Each launch walks a plan, a static list of
work units (``ws_plan``, a pure function of the shapes and the card's SM
count): the column tiles of one row tile side by side, K split where the
tiles do not fill the card, partner row tiles for the cluster of two that
shares the weights by multicast.  The earlier design, ``gemm.cuh``'s TMA
ring (``csrc/subsampling_probe.cu``: ``taps_kernel``, ``patch_kernel`` +
``probe_gemm_kernel``), stays callable as ``taps_product_ring`` and
``im2col_product_ring`` for an A/B on the same card; ``taps_ws`` runs the
redesign's steps one by one (``WS_STEPS``).  P3 runs on
``csrc/smem_probe_ws.cu``: eight blocks, one row of x each, every block
claiming the whole buffer and moving its row into the buffer's top with one
bulk copy on an mbarrier; the earlier single block,
``csrc/subsampling_probe.cu``'s ``smem_probe_kernel``, stays callable as
``smem_copy_kept`` for an A/B on the same card.

Each block takes a leading batch dimension (ee [B, T, 16, 768] ...); the
script's calls are B 1, and the same kernels run the main path's stage 2 at
B 16, T 500.  P1's aligned variant (``TAPS_ALIGNED``) repeats the aligned
taps and never reads eo or oo, which then have 16 frequency rows.

On a card,

    python3 -m gigaam_tpu_torch.probes.subsampling_probe

runs the script's ``main``: P1 at T 32, 64, 128 (aligned and with copies),
P2 at T 64, 128 (without and with the linear), then P3's ladder, and
prints one JSON object under the script's keys (``taps_tb{T}_aligned``,
``taps_tb{T}_with_copies``, ``im2col_tb{T}``, ``im2col_lin_tb{T}``,
``vmem``).  Each time has ``us`` and ``tflops`` (the script's operation
counts) and ``library_us`` and ``delta_pct``, against one stock call of the
same function: cuDNN's ``F.conv2d(X, W, stride=2)`` on the interleaved X
(P1 with copies, P2), a ``torch.matmul`` of the nine taps' concatenation
(P1 aligned: repeated taps are no conv), the conv in ``channels_last``,
``F.relu`` and ``F.linear`` (P2 with the linear), ``x * 2`` (P3).  The conv
runs on X in the port's own layout (NCHW, as its subsampling runs it);
``library_cl_us`` and ``delta_cl_pct`` time it again with X and W in
``channels_last``, the layout the blocks keep.  Times are
microseconds per call from ``gigaam_tpu_torch.profiling.device_timeit``
(200 calls replayed as a CUDA graph, as the script's ``k=200``).  ``vmem``
holds the script's ``max_scratch_mb``, ``fail_at_mb`` and ``err`` (MB of
2^20 bytes), ``max_scratch_bytes`` and the blocks per SM at each granted
size in KB.

Beside each kernel wrapper is the plain version of its Pallas body
(``taps_plain``, ``im2col_plain``, ``vmem_plain``): fp32 products of bf16
values, summed in fp32 and rounded where the body rounds.  A wrapper takes
it for tensors on the CPU; for CUDA tensors it launches its kernels or
raises.  ``<wrapper>.launches`` counts the calls that launched.  Only the
tests and ``chip_smoke.py`` call the plain versions on the card; the ring
and the steps count nothing: they are only compared and timed.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cuda_lib
from ..ops.fused_attention import _check_tensor, _require, _stream
from ..ops.precision import full_fp32
from ..profiling import device_timeit
from .ws_plan import WS_BK, WS_BM, ws_cost, ws_plan  # noqa: F401

D = 768
FREQ = 16                  # output frequencies a time step
EE, EO, OE, OO = range(4)  # the blocks; bit 0: odd frequency, bit 1: odd time
# (block, dt, df) of each tap: the stage-2 conv's nine
TAPS_WITH_COPIES = ((EE, 0, 0), (EO, 0, 0), (EO, 0, 1), (OE, 0, 0),
                    (OE, 1, 0), (OO, 0, 0), (OO, 0, 1), (OO, 1, 0),
                    (OO, 1, 1))
# the script's alignment-best case: [ee, ee, ee, oe_lo, oe_hi, oe_lo, oe_hi,
# ee, oe_lo]
TAPS_ALIGNED = ((EE, 0, 0), (EE, 0, 0), (EE, 0, 0), (OE, 0, 0), (OE, 1, 0),
                (OE, 0, 0), (OE, 1, 0), (EE, 0, 0), (OE, 0, 0))
TAPS = {True: TAPS_WITH_COPIES, False: TAPS_ALIGNED}
# the conv kernel's (kh, kw) of each tap of TAPS_WITH_COPIES
TAP_POSITIONS = ((1, 1), (1, 0), (1, 2), (0, 1), (2, 1), (0, 0), (0, 2),
                 (2, 0), (2, 2))
CALLS = 200               # calls a timed run, as the script's k=200
TB_TAPS = (32, 64, 128)
TB_IM2COL = (64, 128)
# P3's ladder in KB: the card's, up to and past the opt-in limit (227 KB on
# an H100)
SMEM_LADDER_KB = (16, 32, 64, 96, 128, 160, 192, 224, 227, 228)
PROBE_ROWS, PROBE_COLS = 8, 1024   # P3's x
MB = 1024 * 1024


class SharedMemoryRefused(RuntimeError):
    """The card refused P3's buffer size before any launch."""

    def __init__(self, n_bytes: int, code: int):
        super().__init__(f"{n_bytes} bytes of dynamic shared memory refused "
                         f"(CUDA error {code})")
        self.n_bytes, self.code = n_bytes, code


# ---------------------------------------------------------------------------
# Plain versions of the Pallas bodies
# ---------------------------------------------------------------------------

def tap_rows(blocks, tap, steps: int) -> torch.Tensor:
    """Tap ``(block, dt, df)``'s rows [B, T, 16, C] of the four blocks."""
    block, dt, df = tap
    return blocks[block][:, dt:dt + steps, df:df + FREQ]


def taps_plain(ee, eo, oe, oo, w, taps) -> torch.Tensor:
    """P1's body: bf16(sum_i tap_i . w[i]) for w [9, C, N], the fp32
    products summed in the table's order."""
    blocks, steps = (ee, eo, oe, oo), ee.shape[1]
    acc = None
    with full_fp32():
        for i, tap in enumerate(taps):
            p = tap_rows(blocks, tap, steps).float() @ w[i].float()
            acc = p if acc is None else acc + p
    return acc.to(ee.dtype)


def patch_plain(ee, eo, oe, oo) -> torch.Tensor:
    """P2's patch [B, T, 16, 9 C]: the taps with copies side by side."""
    blocks, steps = (ee, eo, oe, oo), ee.shape[1]
    return torch.cat([tap_rows(blocks, tap, steps)
                      for tap in TAPS_WITH_COPIES], dim=-1)


def im2col_plain(ee, eo, oe, oo, w, wl=None) -> torch.Tensor:
    """P2's body: s2 = patch . w [9 C, N] in fp32; without ``wl``
    bf16(s2) at frequency row 0 of each step, [B, T, N]; with ``wl`` [16 N,
    N'] bf16(bf16(relu(s2)) viewed [B, T, 16 N] . wl) (f-major, the
    contiguous view of [B, T, 16, N])."""
    b, steps = ee.shape[:2]
    with full_fp32():
        s2 = patch_plain(ee, eo, oe, oo).float() @ w.float()
        if wl is None:
            return s2.to(ee.dtype)[:, :, 0]
        s2b = torch.relu(s2).to(ee.dtype).reshape(b, steps, -1)
        return (s2b.float() @ wl.float()).to(ee.dtype)


def vmem_plain(x: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """P3's body: x into an n_bytes scratch (its last rows), 2 x out."""
    buf = torch.zeros(n_bytes // x.element_size(), dtype=x.dtype,
                      device=x.device)
    buf[-x.numel():] = x.reshape(-1)
    return (buf[-x.numel():] * 2).reshape(x.shape)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(tiles: int, k_tiles: int, sms: int) -> int:
    """How many blocks share each 128 x 128 output tile's K range: one
    where the tiles give every SM a block, else enough that they do (at
    most one K tile a block)."""
    return 1 if tiles >= sms else min(k_tiles, math.ceil(sms / tiles))


# ---------------------------------------------------------------------------
# The plan of the warp-specialised kernel (csrc/subsampling_ws.cu)
# ---------------------------------------------------------------------------

WS_STEPS_A_TILE = WS_BM // FREQ   # time steps of a taps row tile
# the kernel's variants: name -> (code, columns of a tile, blocks a cluster)
WS_VARIANTS = {"multicast": (0, 256, 2), "wide": (1, 256, 1),
               "inflight": (2, 128, 1), "producer": (3, 128, 1)}
WS_VARIANT = "multicast"   # what taps_product and im2col_product launch
# the design's steps, in the order they were added: (label, variant,
# persistent grid); each is timed against the one before it
WS_STEPS = (("producer warp", "producer", False),
            ("products in flight", "inflight", False),
            ("128 x 256 tiles", "wide", False),
            ("persistent", "wide", True),
            ("multicast", "multicast", True))
def ws_taps_rows(row_tile: int, batch: int, steps: int) -> range:
    """The output rows m = (b T + t) 16 + f that the kernel stores for a
    taps row tile (its epilogue): 8 steps of one batch element, none past
    T, none for a phantom tile."""
    tiles_per_b = -(-steps // WS_STEPS_A_TILE)
    b, t0 = divmod(row_tile, tiles_per_b)
    if b >= batch:
        return range(0)
    t0 *= WS_STEPS_A_TILE
    t1 = min(t0 + WS_STEPS_A_TILE, steps)
    return range((b * steps + t0) * FREQ, (b * steps + t1) * FREQ)


def ws_gemm_rows(row_tile: int, m: int) -> range:
    """The rows the kernel stores for a row tile of a plain product."""
    return range(min(row_tile * WS_BM, m), min((row_tile + 1) * WS_BM, m))


@functools.lru_cache(maxsize=None)
def _cluster_slots(index: int) -> int:
    """Blocks of the multicast variant (clusters of two) that card
    ``index`` holds at once, as the runtime reports them."""
    out = (ctypes.c_int * 1)()
    with torch.cuda.device(index):
        cuda_lib.check(cuda_lib.library("subsampling_ws")
                       .gigaam_ws_max_clusters(out), "gigaam_ws_max_clusters")
    return 2 * out[0]


def ws_slots(variant: str, index: int) -> int:
    """The persistent grid's ceiling for ``variant`` on card ``index``."""
    sms = _sm_count(index)
    if WS_VARIANTS[variant][2] == 1:
        return sms
    return min(sms, _cluster_slots(index))


@functools.lru_cache(maxsize=None)
def _device_plan(row_tiles: int, col_tiles: int, k_items: int, outputs: int,
                 variant: str, persistent: bool, splits, index: int):
    """(units on card ``index``, grid, splits), made once a shape: the
    first call of a shape copies its plan to the card, so it must not be
    under CUDA-graph capture."""
    _, bn, cluster = WS_VARIANTS[variant]
    units, grid, splits = ws_plan(row_tiles, col_tiles, k_items,
                                  ws_slots(variant, index), outputs, bn,
                                  cluster, splits, persistent)
    return torch.from_numpy(units).to(f"cuda:{index}"), grid, splits


def _partials(splits: int, m: int, n: int, dev):
    """fp32 scratch for the split products' partials, or None."""
    return (torch.empty(splits, m, n, dtype=torch.float32, device=dev)
            if splits > 1 else None)


def _ptr(t) -> int:
    return None if t is None else t.data_ptr()


def _tap_table(taps) -> ctypes.Array:
    return (ctypes.c_int * 27)(*[v for tap in taps for v in tap])


def _check_blocks(ee, eo, oe, oo, taps) -> None:
    """What the kernels take: ee [B, T, 16, 768], eo [B, T, F, 768], oe
    [B, T + 1, 16, 768], oo [B, T + 1, F, 768] with F 16 or 17, bf16,
    contiguous, 16-byte aligned, on ee's device; nine taps (block, dt, df),
    each reading inside its block."""
    _require(ee.dim() == 4 and tuple(ee.shape[2:]) == (FREQ, D)
             and ee.numel() > 0,
             f"ee must be [B, T, {FREQ}, {D}], got {tuple(ee.shape)}")
    b, steps = ee.shape[:2]
    f_odd = eo.shape[2] if eo.dim() == 4 else 0
    _require(f_odd in (FREQ, FREQ + 1),
             f"eo must be [B, T, 16 or 17, {D}], got {tuple(eo.shape)}")
    for name, x, shape in (("ee", ee, (b, steps, FREQ, D)),
                           ("eo", eo, (b, steps, f_odd, D)),
                           ("oe", oe, (b, steps + 1, FREQ, D)),
                           ("oo", oo, (b, steps + 1, f_odd, D))):
        _check_tensor(name, x, ee.device, torch.bfloat16, shape)
    _require(len(taps) == 9, f"nine taps, got {len(taps)}")
    for i, (block, dt, df) in enumerate(taps):
        _require(block in range(4) and dt in (0, 1) and df in (0, 1),
                 f"tap {i} is {(block, dt, df)}")
        _require(dt <= block >> 1 and df <= (f_odd - FREQ) * (block & 1),
                 f"tap {i} {(block, dt, df)} reads past its block")


def _ws_taps(ee, eo, oe, oo, w, taps, out, relu: bool,
             variant: str = WS_VARIANT, persistent: bool = True,
             splits: int = None) -> None:
    """out [B T 16, 768] (a contiguous tensor of that size) = bf16(sum_i
    tap_i . w[i]), relu'd where asked, on ``ws_conv_kernel`` (and the
    partials' reduction where the plan splits K)."""
    dev = ee.device
    code, bn, _ = WS_VARIANTS[variant]
    b, steps = ee.shape[:2]
    m = b * steps * FREQ
    units, grid, splits = _device_plan(
        b * math.ceil(steps / WS_STEPS_A_TILE), D // bn, 9 * D // WS_BK,
        m * D, variant, persistent, splits, dev.index)
    partial = _partials(splits, m, D, dev)
    cuda_lib.check(cuda_lib.library("subsampling_ws").gigaam_ws_taps(
        ee.data_ptr(), eo.data_ptr(), oe.data_ptr(), oo.data_ptr(),
        w.data_ptr(), out.data_ptr(), _ptr(partial), units.data_ptr(),
        _tap_table(taps), b, steps, eo.shape[2], len(units), grid, splits,
        int(relu), code, _stream(dev)), "gigaam_ws_taps")


def _ws_gemm(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
             splits: int = None) -> None:
    """out [M, N] = bf16(a [M, K] . b [K, N]) on ``ws_conv_kernel``'s
    plain-product mode (``WS_VARIANT``, persistent, the plan's K splits or
    ``splits``)."""
    m, k = a.shape
    n = b.shape[1]
    code, bn, _ = WS_VARIANTS[WS_VARIANT]
    units, grid, splits = _device_plan(
        math.ceil(m / WS_BM), n // bn, k // WS_BK, m * n, WS_VARIANT, True,
        splits, a.device.index)
    partial = _partials(splits, m, n, a.device)
    cuda_lib.check(cuda_lib.library("subsampling_ws").gigaam_ws_gemm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), _ptr(partial),
        units.data_ptr(), m, n, k, len(units), grid, splits, 0, code,
        _stream(a.device)), "gigaam_ws_gemm")


def taps_ws(ee, eo, oe, oo, w, taps, variant: str = WS_VARIANT,
            persistent: bool = True, splits: int = None) -> torch.Tensor:
    """P1 on the card by the redesign: ``variant`` (``WS_VARIANTS``) on a
    persistent grid or one block a unit, the plan's K splits or
    ``splits``.  Counts no launch: ``chip_smoke.py`` holds the design's
    steps and splits to the plain version with it."""
    _check_blocks(ee, eo, oe, oo, taps)
    _check_tensor("w", w, ee.device, torch.bfloat16, (9, D, D))
    out = torch.empty_like(ee)
    with torch.cuda.device(ee.device):
        _ws_taps(ee, eo, oe, oo, w, taps, out, False, variant, persistent,
                 splits)
    return out


def taps_plan_splits(batch: int, steps: int, index: int = 0) -> int:
    """The K splits of the plan that ``taps_product`` runs for B
    ``batch``, T ``steps`` on card ``index``."""
    _, bn, cluster = WS_VARIANTS[WS_VARIANT]
    row_tiles = batch * math.ceil(steps / WS_STEPS_A_TILE)
    return ws_plan(row_tiles, D // bn, 9 * D // WS_BK,
                   ws_slots(WS_VARIANT, index), batch * steps * FREQ * D, bn,
                   cluster)[2]


def linear_ws(a: torch.Tensor, b: torch.Tensor,
              splits: int = None) -> torch.Tensor:
    """P2's linear alone on the redesign: bf16(a [M, K] . b [K, N]) for bf16
    row-major a and b, K a multiple of 64, N of 256, in the plan's K splits
    or ``splits``.  Counts no launch."""
    _require(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0]
             and a.shape[1] % WS_BK == 0 and b.shape[1] % 256 == 0,
             f"a {tuple(a.shape)} . b {tuple(b.shape)}")
    _check_tensor("a", a, a.device, torch.bfloat16, tuple(a.shape))
    _check_tensor("b", b, a.device, torch.bfloat16, tuple(b.shape))
    out = torch.empty(a.shape[0], b.shape[1], dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        _ws_gemm(a, b, out, splits)
    return out


def taps_product(ee, eo, oe, oo, w, taps) -> torch.Tensor:
    """P1: bf16(sum_i tap_i . w[i]) [B, T, 16, 768] for w [9, 768, 768]
    ([in, out] a tap): one launch of ``ws_conv_kernel`` on the card (and of
    ``ws_reduce_kernel`` where the plan splits K), ``taps_plain`` on the
    CPU."""
    if ee.device.type == "cpu":
        return taps_plain(ee, eo, oe, oo, w, taps)
    out = taps_ws(ee, eo, oe, oo, w, taps)
    taps_product.launches += 1
    return out


def im2col_ws(ee, eo, oe, oo, w, wl=None) -> torch.Tensor:
    """P2 on the card by the redesign (``WS_VARIANT`` on the plan).
    Counts no launch."""
    _check_blocks(ee, eo, oe, oo, TAPS_WITH_COPIES)
    dev = ee.device
    _check_tensor("w", w, dev, torch.bfloat16, (9 * D, D))
    if wl is not None:
        _check_tensor("wl", wl, dev, torch.bfloat16, (FREQ * D, D))
    b, steps = ee.shape[:2]
    m = b * steps * FREQ
    _require(m * D < 2 ** 31, f"B T = {b * steps} is too large")
    s2 = torch.empty(m, D, dtype=ee.dtype, device=dev)
    with torch.cuda.device(dev):
        # the patch's column order is the taps with copies, w's rows tap
        # by tap: w viewed [9, 768, 768] is P1's weight
        _ws_taps(ee, eo, oe, oo, w, TAPS_WITH_COPIES, s2, wl is not None)
        if wl is None:
            return s2.view(b, steps, FREQ, D)[:, :, 0]
        out = torch.empty(b, steps, D, dtype=ee.dtype, device=dev)
        _ws_gemm(s2.view(b * steps, FREQ * D), wl, out.view(b * steps, D))
    return out


def im2col_product(ee, eo, oe, oo, w, wl=None) -> torch.Tensor:
    """P2 for w [6912, 768] and, with the linear, wl [12288, 768]: on the
    card ``ws_conv_kernel`` computes the whole [B T 16, 768] product over
    the patch seen as a view (the taps with copies, no [M, 6912] tensor;
    bf16, relu'd with the linear, which is a second ``ws_conv_kernel`` run
    with a plain 2-D A); ``im2col_plain`` on the CPU.  Returns [B, T, 768]:
    without the linear frequency row 0 of the product (a view of it)."""
    if ee.device.type == "cpu":
        return im2col_plain(ee, eo, oe, oo, w, wl)
    out = im2col_ws(ee, eo, oe, oo, w, wl)
    im2col_product.launches += 1
    return out


def taps_product_ring(ee, eo, oe, oo, w, taps) -> torch.Tensor:
    """P1 on ``gemm.cuh``'s TMA ring (``taps_kernel``, one block a 128 x 128
    tile, K split over blocks where the tiles are few): the design the
    redesign replaced, kept for an A/B on the same card."""
    _check_blocks(ee, eo, oe, oo, taps)
    _check_tensor("w", w, ee.device, torch.bfloat16, (9, D, D))
    b, steps = ee.shape[:2]
    out = torch.empty_like(ee)
    splits = split_plan((D // 128) * b * math.ceil(steps / 8), 9 * D // 64,
                        _sm_count(ee.device.index or 0))
    partial = _partials(splits, b * steps * FREQ, D, ee.device)
    with torch.cuda.device(ee.device):
        cuda_lib.check(cuda_lib.library("subsampling_probe").gigaam_taps(
            ee.data_ptr(), eo.data_ptr(), oe.data_ptr(), oo.data_ptr(),
            w.data_ptr(), out.data_ptr(), _ptr(partial), _tap_table(taps), b,
            steps, eo.shape[2], splits, _stream(ee.device)), "gigaam_taps")
    return out


def _gemm(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
          relu: bool) -> None:
    """out [M, N] = bf16(a [M, K] . b [K, N]), relu'd when asked, on
    ``probe_gemm_kernel`` (K split over blocks where the tiles are few)."""
    m, k = a.shape
    n = b.shape[1]
    splits = split_plan((n // 128) * math.ceil(m / 128), k // 64,
                        _sm_count(a.device.index or 0))
    partial = _partials(splits, m, n, a.device)
    cuda_lib.check(cuda_lib.library("subsampling_probe").gigaam_probe_gemm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), _ptr(partial), m, n, k,
        splits, int(relu), _stream(a.device)), "gigaam_probe_gemm")


def im2col_product_ring(ee, eo, oe, oo, w, wl=None) -> torch.Tensor:
    """P2 on the TMA ring: ``patch_kernel`` writes the patch [B T 16, 6912]
    to device memory, then ``probe_gemm_kernel`` computes the whole
    [B T 16, 768] product (and the linear, a second run): the design the
    redesign replaced, kept for an A/B on the same card."""
    _check_blocks(ee, eo, oe, oo, TAPS_WITH_COPIES)
    dev = ee.device
    _check_tensor("w", w, dev, torch.bfloat16, (9 * D, D))
    if wl is not None:
        _check_tensor("wl", wl, dev, torch.bfloat16, (FREQ * D, D))
    b, steps = ee.shape[:2]
    m = b * steps * FREQ
    _require(m * 9 * D // 8 < 2 ** 31, f"B T = {b * steps} is too large")
    patch = torch.empty(m, 9 * D, dtype=ee.dtype, device=dev)
    s2 = torch.empty(m, D, dtype=ee.dtype, device=dev)
    with torch.cuda.device(dev):
        cuda_lib.check(cuda_lib.library("subsampling_probe").gigaam_im2col(
            ee.data_ptr(), eo.data_ptr(), oe.data_ptr(), oo.data_ptr(),
            patch.data_ptr(), _tap_table(TAPS_WITH_COPIES), b, steps,
            eo.shape[2], _stream(dev)), "gigaam_im2col")
        _gemm(patch, w, s2, relu=wl is not None)
        if wl is None:
            return s2.view(b, steps, FREQ, D)[:, :, 0]
        out = torch.empty(b, steps, D, dtype=ee.dtype, device=dev)
        _gemm(s2.view(b * steps, FREQ * D), wl, out.view(b * steps, D),
              relu=False)
    return out


def _smem_probe(entry: str, x: torch.Tensor, n_bytes: int):
    """(2 x, blocks an SM holds) of the P3 kernel behind C entry ``entry``
    (``library:function``)."""
    _check_tensor("x", x, x.device, torch.bfloat16, (PROBE_ROWS, PROBE_COLS))
    _require(n_bytes % 16 == 0 and n_bytes >= 2 * x.numel(),
             f"n_bytes {n_bytes} must be a multiple of 16 and hold x")
    name, fn = entry.split(":")
    out = torch.empty_like(x)
    result = (ctypes.c_int * 2)()
    with torch.cuda.device(x.device):
        rc = getattr(cuda_lib.library(name), fn)(
            x.data_ptr(), out.data_ptr(), n_bytes, result, _stream(x.device))
    if result[1]:
        raise SharedMemoryRefused(n_bytes, rc)
    cuda_lib.check(rc, fn)
    return out, result[0]


def smem_copy(x: torch.Tensor, n_bytes: int):
    """P3: (2 x, blocks of the kernel an SM holds) for x [8, 1024] bf16
    copied through a dynamic shared-memory buffer of ``n_bytes``; raises
    ``SharedMemoryRefused`` for a size the card refuses (nothing is
    launched then).  ``vmem_plain`` on the CPU, with no block count.  On
    the card ``csrc/smem_probe_ws.cu``: eight blocks, each claiming the
    whole buffer and bringing one row into its top with one bulk copy."""
    if x.device.type == "cpu":
        return vmem_plain(x, n_bytes), None
    got = _smem_probe("smem_probe_ws:gigaam_smem_probe_ws", x, n_bytes)
    smem_copy.launches += 1
    return got


def smem_copy_kept(x: torch.Tensor, n_bytes: int):
    """``smem_copy`` on the design the bulk copy replaced: one block of
    ``csrc/subsampling_probe.cu`` copying all of x through its buffer.
    Card only; counts no launch: kept for an A/B on the same card."""
    return _smem_probe("subsampling_probe:gigaam_smem_probe", x, n_bytes)


def empty_launch(device) -> None:
    """An empty kernel on P3's grid: the floor one launch reaches.  Card
    only; counts no launch."""
    with torch.cuda.device(device):
        cuda_lib.check(cuda_lib.library("smem_probe_ws")
                       .gigaam_smem_probe_ws_empty(_stream(device)),
                       "gigaam_smem_probe_ws_empty")


KERNELS = (taps_product, im2col_product, smem_copy)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


reset_launch_counts()


# ---------------------------------------------------------------------------
# Layouts and the library calls
# ---------------------------------------------------------------------------

def conv_weight(w: torch.Tensor) -> torch.Tensor:
    """The conv's weight [N, C, 3, 3] of the taps' w [9, C, N]."""
    out = w.new_zeros(w.shape[2], w.shape[1], 3, 3)
    for i, (kh, kw) in enumerate(TAP_POSITIONS):
        out[:, :, kh, kw] = w[i].t()
    return out


def interleave(ee, eo, oe, oo) -> torch.Tensor:
    """X [B, C, 2T + 1, 33] (a ``channels_last`` tensor) of the four
    blocks with 17 frequency rows in eo and oo."""
    b, steps, _, c = ee.shape
    x = ee.new_zeros(b, 2 * steps + 1, 2 * FREQ + 1, c)
    x[:, 1::2, 1::2], x[:, 1::2, 0::2] = ee, eo
    x[:, 0::2, 1::2], x[:, 0::2, 0::2] = oe, oo
    return x.permute(0, 3, 1, 2)


def parity_blocks(x: torch.Tensor):
    """(ee, eo, oe, oo), each [B, T(+1), F, C] contiguous, of X [B, C,
    2T + 1, 33]."""
    return tuple(x[:, :, h::2, w::2].permute(0, 2, 3, 1).contiguous()
                 for h, w in ((1, 1), (1, 0), (0, 1), (0, 0)))


def stage2_blocks(x1: torch.Tensor):
    """The blocks of the stage-1 output x1 [B, C, 2T, 32] as the stage-2
    conv with padding 1 reads it: X is x1 behind one zero row and column."""
    return parity_blocks(F.pad(x1, (1, 0, 1, 0)))


def conv_library(x: torch.Tensor, w4: torch.Tensor, padding: int = 0):
    """cuDNN's stage-2 conv, ``F.conv2d(x, W, stride=2)``: [B, N, T, 16]."""
    return F.conv2d(x, w4, stride=2, padding=padding)


def conv_linear_library(x: torch.Tensor, w4: torch.Tensor,
                        wl_t: torch.Tensor, padding: int = 0):
    """The stock P2 with the linear: the conv (x and W ``channels_last``, so
    that the output's [B, T, 16, N] is a view), ``F.relu``, the f-major
    flatten and ``F.linear`` by wl_t [N', 16 N]."""
    y = F.relu(F.conv2d(x, w4, stride=2, padding=padding))
    b, n, steps, f = y.shape
    return F.linear(y.permute(0, 2, 3, 1).reshape(b, steps, f * n), wl_t)


def conv_cl_library(ee, eo, oe, oo, w):
    """(the conv, its arguments) with X and W [N, C, 3, 3] in
    ``channels_last``, the layout the blocks keep (channels innermost);
    w [9, C, N] or [9 C, N]."""
    cl = torch.channels_last
    w4 = conv_weight(w.reshape(9, ee.shape[-1], -1))
    return conv_library, [interleave(ee, eo, oe, oo).contiguous(
        memory_format=cl), w4.contiguous(memory_format=cl)]


def taps_library(ee, eo, oe, oo, w, with_copies: bool):
    """(stock call, its arguments) of P1's function on these inputs: the
    conv on the interleaved X with copies; aligned, one ``torch.matmul`` of
    the nine taps' [M, 9 C] concatenation by w.reshape(9 C, N)."""
    if with_copies:
        return conv_library, [interleave(ee, eo, oe, oo).contiguous(),
                              conv_weight(w)]
    blocks, steps = (ee, eo, oe, oo), ee.shape[1]
    cat = torch.cat([tap_rows(blocks, tap, steps) for tap in TAPS_ALIGNED],
                    dim=-1)
    return torch.matmul, [cat.reshape(-1, cat.shape[-1]),
                          w.reshape(-1, w.shape[-1])]


def im2col_library(ee, eo, oe, oo, w, wl=None):
    """(stock call, its arguments) of P2's function: the conv, or the conv
    in ``channels_last``, ``F.relu`` and ``F.linear``."""
    c = ee.shape[-1]
    w4 = conv_weight(w.reshape(9, c, -1))
    x = interleave(ee, eo, oe, oo)
    if wl is None:
        return conv_library, [x.contiguous(), w4]
    cl = torch.channels_last
    return conv_linear_library, [x.contiguous(memory_format=cl),
                                 w4.contiguous(memory_format=cl),
                                 wl.t().contiguous()]


# ---------------------------------------------------------------------------
# The script's inputs and probes
# ---------------------------------------------------------------------------

def taps_inputs(tb: int, with_copies: bool):
    """P1's inputs as the script draws them (``default_rng(0)``, the same
    order and scales): ee, eo, oe, oo, w as float64 numpy arrays, the blocks
    without a batch dimension."""
    fe = FREQ + 1 if with_copies else FREQ
    rng = np.random.default_rng(0)
    blocks = [rng.standard_normal(shape) for shape in (
        (tb, FREQ, D), (tb, fe, D), (tb + 1, FREQ, D), (tb + 1, fe, D))]
    return (*blocks, 0.02 * rng.standard_normal((9, D, D)))


def im2col_inputs(tb: int):
    """P2's inputs as the script draws them: ee, eo, oe, oo, w [9 D, D],
    wl [16 D, D]."""
    rng = np.random.default_rng(0)
    blocks = [rng.standard_normal(shape) for shape in (
        (tb, FREQ, D), (tb, FREQ + 1, D), (tb + 1, FREQ, D),
        (tb + 1, FREQ + 1, D))]
    return (*blocks, 0.02 * rng.standard_normal((9 * D, D)),
            0.02 * rng.standard_normal((FREQ * D, D)))


def _on(arrays, dev, batched: int):
    """bf16 tensors on ``dev``; the first ``batched`` get a batch of 1."""
    return [torch.from_numpy(np.asarray(a)).to(dev, torch.bfloat16)[None]
            if i < batched else
            torch.from_numpy(np.asarray(a)).to(dev, torch.bfloat16)
            for i, a in enumerate(arrays)]


def _timed(fn, args, flops: float, library, library_cl=None) -> dict:
    """The kernel's time beside each (call, arguments) given: the library
    call and, for the conv, the same conv in ``channels_last``."""
    dt = device_timeit(fn, args, k=CALLS)
    res = {"us": round(dt * 1e6, 2), "tflops": round(flops / dt / 1e12, 1)}
    for name, lib in (("", library), ("_cl", library_cl)):
        if lib is not None:
            dl = device_timeit(*lib, k=CALLS)
            res[f"library{name}_us"] = round(dl * 1e6, 2)
            res[f"delta{name}_pct"] = round(100.0 * (dt - dl) / dl, 1)
    return res


def probe_taps(tb: int = 64, with_copies: bool = False, device=None) -> dict:
    """P1 at the script's shape (B 1, T tb) on ``device`` (the card when
    None): the kernel and its library call, microseconds per call."""
    dev = torch.device("cuda" if device is None else device)
    ee, eo, oe, oo, w = _on(taps_inputs(tb, with_copies), dev, 4)
    taps = TAPS[with_copies]
    m = tb * FREQ
    return _timed(lambda *a: taps_product(*a, taps), [ee, eo, oe, oo, w],
                  9 * 2 * m * D * D,
                  taps_library(ee, eo, oe, oo, w, with_copies),
                  conv_cl_library(ee, eo, oe, oo, w) if with_copies else None)


def probe_im2col(tb: int = 64, fuse_linear: bool = False,
                 device=None) -> dict:
    """P2 at the script's shape (B 1, T tb), without or with the linear."""
    dev = torch.device("cuda" if device is None else device)
    ee, eo, oe, oo, w, wl = _on(im2col_inputs(tb), dev, 4)
    wl = wl if fuse_linear else None
    m = tb * FREQ
    flops = 9 * 2 * m * D * D + (fuse_linear and 2 * tb * 16 * D * D or 0)
    return _timed(lambda *a: im2col_product(*a, wl), [ee, eo, oe, oo, w],
                  flops, im2col_library(ee, eo, oe, oo, w, wl),
                  None if fuse_linear else conv_cl_library(ee, eo, oe, oo, w))


def probe_vmem(device=None) -> dict:
    """P3: the largest dynamic shared memory a block is granted, up the
    ladder ``SMEM_LADDER_KB`` until the card refuses a size (the one error
    recorded; any other raises), with the blocks an SM holds at each."""
    dev = torch.device("cuda" if device is None else device)
    x = torch.ones(PROBE_ROWS, PROBE_COLS, dtype=torch.bfloat16, device=dev)
    res = {"max_scratch_mb": 0.0, "max_scratch_bytes": 0,
           "blocks_per_sm": {}}
    for kb in SMEM_LADDER_KB:
        n_bytes = kb * 1024
        try:
            out, blocks = smem_copy(x, n_bytes)
        except SharedMemoryRefused as e:
            res.update(fail_at_mb=n_bytes / MB, err=str(e)[:120])
            break
        float(out.float().sum())
        res["max_scratch_mb"] = n_bytes / MB
        res["max_scratch_bytes"] = n_bytes
        res["blocks_per_sm"][str(kb)] = blocks
    return res


def main(device=None) -> dict:
    """The script's ``main`` on ``device`` (the card when None): prints a
    line per probe and, last, the results as one JSON object."""
    res = {}
    for tb in TB_TAPS:
        for with_copies, name in ((False, "aligned"), (True, "with_copies")):
            key = f"taps_tb{tb}_{name}"
            res[key] = probe_taps(tb, with_copies, device)
            print(f"taps tb={tb} {name}:", res[key], flush=True)
    for tb in TB_IM2COL:
        res[f"im2col_tb{tb}"] = probe_im2col(tb, False, device)
        print(f"im2col tb={tb}:", res[f"im2col_tb{tb}"], flush=True)
        res[f"im2col_lin_tb{tb}"] = probe_im2col(tb, True, device)
        print(f"im2col+lin tb={tb}:", res[f"im2col_lin_tb{tb}"], flush=True)
    res["vmem"] = probe_vmem(device)
    print("vmem:", res["vmem"], flush=True)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
