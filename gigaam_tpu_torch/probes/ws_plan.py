"""The work plans of the warp-specialised, persistent GEMM cores
(``csrc/conv_ws.cuh``): which (row tile, column tile, K range) each block
of the persistent grid takes, and where K is split.  Pure functions of the
shapes and the card's slots, so that the CPU tests can check them.  The
kernels on the cooperative core ``WsCore`` (``csrc/subsampling_ws.cu``, P1
and P2, ``csrc/ffn_ws.cu``, P4, and P6's in ``csrc/attn_fold_ws.cu``) and
on the ping-pong core ``PingPongCore`` (P7's and P6 nb 1's in
``csrc/attn_fold_ws.cu``, [64, bn] tiles with K unsplit; unit i of a block
runs on its consumer warpgroup i % 2) walk the units of ``ws_plan``.
"""

from __future__ import annotations

import numpy as np

WS_BM, WS_BK = 128, 64     # rows of an output tile; K columns an item
PP_BM = 64                 # rows of a ping-pong output tile: a consumer's
# the model's constants: the card the plan is made for (H100 SXM), and a
# unit's fixed cost in K items (the ring's fill, the epilogue)
WS_PEAK_BF16, WS_PEAK_BYTES, WS_MODEL_SMS = 989e12, 3.35e12, 132
WS_UNIT_ITEMS = 4


def ws_cost(tiles: int, splits: int, k_items: int, slots: int,
            outputs: int, bn: int = 256) -> float:
    """A plan's modelled time, in the time one SM takes for one K item of
    one [128, bn] tile at the card's peak: ceil(tiles x splits / slots)
    waves of units, each its share of the K items plus ``WS_UNIT_ITEMS``,
    and with splits > 1 the partials' fp32 write and read (8 bytes an
    output value a split) and the reduction at the memory rate."""
    item_s = 2 * WS_BM * bn * WS_BK * WS_MODEL_SMS / WS_PEAK_BF16
    waves = -(-tiles * splits // slots)
    fixup = 0.0 if splits == 1 else (
        8 * splits * outputs / WS_PEAK_BYTES / item_s)
    return waves * (k_items / splits + WS_UNIT_ITEMS) + fixup


def ws_splits(tiles: int, k_items: int, slots: int, outputs: int,
              bn: int = 256) -> int:
    """The K splits of least ``ws_cost`` (the fewest on a tie): where the
    tiles leave SMs idle, as many as one wave holds; past that, a split
    only where it evens out the last wave."""
    costs = [ws_cost(tiles, s, k_items, slots, outputs, bn)
             for s in range(1, k_items + 1)]
    return 1 + min(range(len(costs)), key=lambda i: (costs[i], i))


def ws_plan(row_tiles: int, col_tiles: int, k_items: int, slots: int,
            outputs: int, bn: int = 256, cluster: int = 1,
            splits: int = None, persistent: bool = True):
    """(units int32 [U, 4], grid, splits): the work list that
    a kernel on ``csrc/conv_ws.cuh``'s core
    walks, unit u on block u % grid.  A unit is (row
    tile, column tile | split << 16, first K item, K items); splits K
    ranges of k_items // splits or one more.  Row tiles go in groups of
    ``cluster`` (the last group padded with phantom tiles past the end,
    which read zeros and store nothing); within a group, for each split,
    for each column tile, the group's row tiles are consecutive units:
    partners, on the two blocks of a cluster, sharing the column tile and
    the K range.  The column tiles of one row tile are neighbours, so they
    run at the same time.  ``slots``: the blocks the card holds at once;
    the grid is that many (a multiple of ``cluster``), or one block a unit
    without ``persistent``.  ``splits`` None: ``ws_splits``."""
    groups = -(-row_tiles // cluster)
    if splits is None:
        splits = ws_splits(groups * cluster * col_tiles, k_items, slots,
                           outputs, bn)
    units = []
    for g in range(groups):
        for s in range(splits):
            first = s * k_items // splits
            count = (s + 1) * k_items // splits - first
            for c in range(col_tiles):
                for r in range(g * cluster, (g + 1) * cluster):
                    units.append((r, c | s << 16, first, count))
    units = np.asarray(units, dtype=np.int32).reshape(-1, 4)
    grid = (min(len(units), slots // cluster * cluster) if persistent
            else len(units))
    return units, grid, splits

