"""The warp-specialised redesign of the subsampling probes P1 and P2
(``csrc/subsampling_ws.cu`` on ``csrc/conv_ws.cuh``, driven by
``gigaam_tpu_torch/probes/subsampling_probe.py``).

On the CPU the plan that the wrappers hand the kernel is held to what the
kernel needs of it (``ws_plan``, a pure function): every (output tile, K
item) in exactly one unit, no row tile across a batch element (the rows the
epilogue stores, ``ws_taps_rows``), partner units on the two blocks of each
cluster with the same column tile and K range, the column tiles of a row
tile side by side, one wave where the tiles leave SMs idle and K split to
fill it, forced splits in order, at the script's shapes (B 1, T 32-128), the
main path's B 16, T 500 and its linear, the edges T 1, 7, 8, 9, 13, on a
132-SM and a 114-SM card, for every variant of the kernel.

The tests marked ``gpu`` hold the kernels against ``taps_plain`` and
``im2col_plain`` on the card, in bf16, within a tenth of the output's RMS
plus one bf16 rounding of the value (as ``chip_smoke.py`` holds them): a
persistent tail, cluster pairs across a batch edge, the split of K at B 1,
T 32 (the plan's and forced), both tap tables, each of the design's steps,
P2 with and without the linear, the linear's K splits, no patch allocated;
they skip without one (on the card:
``pytest --noconftest -m gpu tests/test_torch_subsampling_ws.py``).
"""

import math

import numpy as np
import pytest
import torch

from gigaam_tpu_torch.probes import subsampling_probe as sp

TAPS_K = 9 * sp.D // sp.WS_BK        # 108 K items
LIN_K = sp.FREQ * sp.D // sp.WS_BK   # 192
SHAPES = [(1, 1), (1, 7), (1, 8), (1, 9), (1, 13), (3, 7), (2, 13), (1, 32),
          (1, 64), (1, 128), (2, 500), (16, 500)]
CARDS = [132, 114]


def taps_plan(b, t, sms, variant, persistent=True):
    _, bn, cluster = sp.WS_VARIANTS[variant]
    return sp.ws_plan(b * math.ceil(t / sp.WS_STEPS_A_TILE), sp.D // bn,
                      TAPS_K, sms, b * t * sp.FREQ * sp.D, bn, cluster,
                      persistent=persistent)


def coverage(units, n_tiles, col_tiles, k_items):
    """counts[row tile, column tile, K item] over the units; phantom row
    tiles (past n_tiles) counted in the last row"""
    counts = np.zeros((n_tiles + 1, col_tiles, k_items), dtype=np.int64)
    for r, cs, first, count in units:
        counts[min(r, n_tiles), cs & 0xffff, first:first + count] += 1
    return counts


@pytest.mark.parametrize("sms", CARDS)
@pytest.mark.parametrize("variant", list(sp.WS_VARIANTS))
@pytest.mark.parametrize("b,t", SHAPES)
def test_taps_plan_covers_every_tile_and_k_item_once(b, t, variant, sms):
    _, bn, cluster = sp.WS_VARIANTS[variant]
    units, grid, splits = taps_plan(b, t, sms, variant)
    row_tiles = b * math.ceil(t / 8)
    counts = coverage(units, row_tiles, sp.D // bn, TAPS_K)
    assert (counts[:row_tiles] == 1).all()
    # the phantom that pads the last cluster group is a whole tile's worth
    phantoms = -row_tiles % cluster
    assert (counts[row_tiles] == phantoms).all()
    assert (units[:, 3] >= 1).all()
    assert len({int(cs) >> 16 for cs in units[:, 1]}) == splits
    # the rows the epilogue stores: each real row tile inside one batch
    # element, every output row exactly once a column tile
    rows = np.zeros(b * t * sp.FREQ, dtype=np.int64)
    for r in range(row_tiles + phantoms):
        stored = sp.ws_taps_rows(r, b, t)
        if r >= row_tiles:
            assert len(stored) == 0
            continue
        assert len(stored) > 0
        first, last = stored[0] // (t * sp.FREQ), stored[-1] // (t * sp.FREQ)
        assert first == last == r // math.ceil(t / 8)
        rows[stored.start:stored.stop] += 1
    assert (rows == 1).all()
    # the grid: one block a slot (a multiple of the cluster), never more
    # than the units
    assert grid == min(len(units), sms // cluster * cluster)
    assert grid % cluster == 0 and len(units) % cluster == 0


@pytest.mark.parametrize("sms", CARDS)
@pytest.mark.parametrize("b,t", [(1, 1), (1, 64), (16, 500)])
def test_linear_plan_covers_every_tile_and_k_item_once(b, t, sms):
    m = b * t
    for variant, (_, bn, cluster) in sp.WS_VARIANTS.items():
        row_tiles = math.ceil(m / sp.WS_BM)
        units, grid, splits = sp.ws_plan(row_tiles, sp.D // bn, LIN_K, sms,
                                         m * sp.D, bn, cluster)
        counts = coverage(units, row_tiles, sp.D // bn, LIN_K)
        assert (counts[:row_tiles] == 1).all()
        assert (counts[row_tiles] == -row_tiles % cluster).all()
        stored = [sp.ws_gemm_rows(r, m) for r in range(row_tiles + 1)]
        assert sum(len(s) for s in stored) == m and len(stored[-1]) == 0


@pytest.mark.parametrize("sms", CARDS)
@pytest.mark.parametrize("b,t", [(3, 7), (1, 13), (2, 500), (16, 500),
                                 (1, 32)])
def test_cluster_partners_share_a_column_tile_and_k_range(b, t, sms):
    units, grid, _ = taps_plan(b, t, sms, "multicast")
    assert len(units) % 2 == 0 and grid % 2 == 0
    lo, hi = units[0::2], units[1::2]
    assert (lo[:, 1:] == hi[:, 1:]).all()          # column, split, K range
    assert (lo[:, 0] % 2 == 0).all() and (hi[:, 0] == lo[:, 0] + 1).all()
    # unit u runs on block u % grid: partners on blocks 2c and 2c + 1 of
    # one cluster, in the same round
    for u in range(0, len(units), 2):
        assert (u % grid) % 2 == 0 and (u + 1) % grid == u % grid + 1
    # with an odd count of row tiles a batch element, some pair straddles
    # a batch edge: its two tiles store rows of two elements
    tiles_per_b = math.ceil(t / 8)
    straddles = [
        r for r in lo[:, 0]
        if len(sp.ws_taps_rows(r + 1, b, t))
        and r // tiles_per_b != (r + 1) // tiles_per_b]
    assert bool(straddles) == (tiles_per_b % 2 == 1 and b > 1)


@pytest.mark.parametrize("variant", list(sp.WS_VARIANTS))
@pytest.mark.parametrize("b,t", [(1, 64), (2, 500), (16, 500)])
def test_a_row_tiles_column_tiles_run_side_by_side(b, t, variant):
    """The units of one row tile (all its column tiles and splits) are
    consecutive but for its cluster partner's, so that they run in one
    round of the persistent grid."""
    _, bn, cluster = sp.WS_VARIANTS[variant]
    units, grid, splits = taps_plan(b, t, 132, variant)
    per_tile = cluster * splits * (sp.D // bn)
    for r in np.unique(units[:, 0]):
        at = np.flatnonzero(units[:, 0] == r)
        assert at[-1] - at[0] < per_tile and at[0] // per_tile == (
            at[-1] // per_tile)
    assert per_tile <= grid


@pytest.mark.parametrize("sms", CARDS)
@pytest.mark.parametrize("b,t", SHAPES)
def test_splits_fill_the_card_in_one_wave(b, t, sms):
    """Where the tiles leave half the card idle, K splits to fill it as
    ``split_plan`` does, within the persistent grid's one wave (at least
    eight splits, or as many as the wave holds); the choice is the least of
    the plan's cost model; the main path's stage 2 never splits."""
    for variant, (_, bn, cluster) in sp.WS_VARIANTS.items():
        units, grid, splits = taps_plan(b, t, sms, variant)
        row_tiles = b * math.ceil(t / 8)
        tiles = (row_tiles + -row_tiles % cluster) * (sp.D // bn)
        costs = [sp.ws_cost(tiles, s, TAPS_K, sms, b * t * sp.FREQ * sp.D,
                            bn) for s in range(1, TAPS_K + 1)]
        assert splits == 1 + int(np.argmin(costs))
        if 2 * tiles <= sms:
            # at least eight splits, or as many as one wave holds
            assert splits >= min(sms // tiles, 8)
            assert len(units) <= sms and grid == len(units)
        if tiles >= sms:
            assert splits <= 2
    units, grid, splits = taps_plan(16, 500, sms, "multicast")
    assert splits == 1 and grid == sms // 2 * 2
    # the linear at B 16, T 500: 63 x 3 tiles, 1.4 waves unsplit; two
    # splits even out the waves
    _, grid, splits = sp.ws_plan(63, 3, LIN_K, 132, 8000 * sp.D)
    assert splits == 2 and grid == 132


@pytest.mark.parametrize("splits", [2, 3, 5, 8])
@pytest.mark.parametrize("b,t", [(1, 32), (1, 64), (3, 7)])
def test_forced_splits_plan_covers_each_tile_in_order(b, t, splits):
    """A forced K split (``taps_ws(splits=)``, the splits chip_smoke.py
    times): every (tile, K item) once, each tile's splits in slot order
    over contiguous K ranges that make up its whole K, cluster partners on
    the same range, and one wave of the persistent grid."""
    row_tiles = b * math.ceil(t / 8)
    units, grid, got = sp.ws_plan(row_tiles, 3, TAPS_K, 132,
                                  b * t * sp.FREQ * sp.D, splits=splits,
                                  cluster=2)
    assert got == splits
    assert grid == min(len(units), 132)
    counts = coverage(units, row_tiles, 3, TAPS_K)
    assert (counts[:row_tiles] == 1).all()
    assert (counts[row_tiles] == -row_tiles % 2).all()
    for r in np.unique(units[:, 0]):
        for c in range(3):
            tile = units[(units[:, 0] == r) & (units[:, 1] & 0xffff == c)]
            assert [int(cs) >> 16 for cs in tile[:, 1]] == list(range(splits))
            assert tile[0, 2] == 0 and tile[-1, 2] + tile[-1, 3] == TAPS_K
            assert (tile[1:, 2] == tile[:-1, 2] + tile[:-1, 3]).all()
    assert (units[0::2, 1:] == units[1::2, 1:]).all()


def test_non_persistent_grid_is_a_block_a_unit():
    for b, t in SHAPES:
        units, grid, _ = taps_plan(b, t, 132, "producer", persistent=False)
        assert grid == len(units)


def test_steps_name_variants_in_the_order_they_were_added():
    assert [label for label, _, _ in sp.WS_STEPS] == [
        "producer warp", "products in flight", "128 x 256 tiles",
        "persistent", "multicast"]
    assert all(v in sp.WS_VARIANTS for _, v, _ in sp.WS_STEPS)
    assert sp.WS_VARIANT in sp.WS_VARIANTS


def test_cpu_wrappers_take_the_plain_version():
    rng = np.random.default_rng(5)
    b, t, d = 2, 3, sp.D
    blocks = [torch.from_numpy(rng.standard_normal(s)).to(torch.bfloat16)
              for s in ((b, t, 16, d), (b, t, 17, d), (b, t + 1, 16, d),
                        (b, t + 1, 17, d))]
    w = torch.from_numpy(0.02 * rng.standard_normal((9, d, d))).to(
        torch.bfloat16)
    sp.reset_launch_counts()
    assert torch.equal(sp.taps_product(*blocks, w, sp.TAPS_WITH_COPIES),
                       sp.taps_plain(*blocks, w, sp.TAPS_WITH_COPIES))
    assert sp.taps_product.launches == 0


# ---------------------------------------------------------------------------
# On the card: the redesign against the plain versions, bf16
# ---------------------------------------------------------------------------

GPU_REL, GPU_RTOL = 0.1, 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest "
                    "--noconftest -m gpu tests/test_torch_subsampling_ws.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_blocks(b, tb, fe, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(b, t, f, sp.D, generator=gen, device=dev,
                        dtype=torch.bfloat16)
            for t, f in ((tb, 16), (tb, fe), (tb + 1, 16), (tb + 1, fe))]


def card_weights(dev, *shape, seed=1):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (0.02 * torch.randn(*shape, generator=gen, device=dev)).to(
        torch.bfloat16)


def assert_kernel_close(got, ref):
    got, ref = got.float(), ref.float()
    rms = float(ref.pow(2).mean().sqrt())
    err = (got - ref).abs()
    assert float((err - GPU_RTOL * ref.abs()).max()) <= GPU_REL * rms


@pytest.mark.gpu
@pytest.mark.parametrize("b,tb", [
    (16, 100),   # a persistent tail: 624 units on 132 slots
    (3, 7),      # a cluster pair across a batch edge, and a phantom tile
    (2, 500),    # tile 62 of element 0 beside tile 0 of element 1
    (1, 32),     # the plan's split of K
    (1, 1)])
@pytest.mark.parametrize("with_copies", [True, False])
def test_cuda_ws_taps_matches_plain(cuda, b, tb, with_copies):
    blocks = card_blocks(b, tb, 17 if with_copies else 16, cuda)
    w = card_weights(cuda, 9, sp.D, sp.D)
    taps = sp.TAPS[with_copies]
    before = sp.taps_product.launches
    got = sp.taps_product(*blocks, w, taps)
    assert sp.taps_product.launches == before + 1
    assert_kernel_close(got, sp.taps_plain(*blocks, w, taps))
    assert torch.equal(sp.taps_product(*blocks, w, taps), got)


@pytest.mark.gpu
@pytest.mark.parametrize("label,variant,persistent", sp.WS_STEPS)
def test_cuda_each_step_matches_plain(cuda, label, variant, persistent):
    blocks = card_blocks(5, 13, 17, cuda, seed=2)
    w = card_weights(cuda, 9, sp.D, sp.D)
    got = sp.taps_ws(*blocks, w, sp.TAPS_WITH_COPIES, variant, persistent)
    assert_kernel_close(got, sp.taps_plain(*blocks, w, sp.TAPS_WITH_COPIES))


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 2, 5, 11])
@pytest.mark.parametrize("variant", ["multicast", "wide"])
def test_cuda_forced_splits_match_plain(cuda, splits, variant):
    blocks = card_blocks(1, 32, 17, cuda, seed=3)
    w = card_weights(cuda, 9, sp.D, sp.D)
    got = sp.taps_ws(*blocks, w, sp.TAPS_WITH_COPIES, variant,
                     splits=splits)
    assert_kernel_close(got, sp.taps_plain(*blocks, w, sp.TAPS_WITH_COPIES))


@pytest.mark.gpu
@pytest.mark.parametrize("b,tb", [(1, 32), (3, 7), (16, 100)])
@pytest.mark.parametrize("fuse_linear", [False, True])
def test_cuda_ws_im2col_matches_plain(cuda, b, tb, fuse_linear):
    blocks = card_blocks(b, tb, 17, cuda, seed=4)
    w = card_weights(cuda, 9 * sp.D, sp.D)
    wl = card_weights(cuda, 16 * sp.D, sp.D, seed=5) if fuse_linear else None
    before = sp.im2col_product.launches
    got = sp.im2col_product(*blocks, w, wl)
    assert sp.im2col_product.launches == before + 1
    assert got.shape == (b, tb, sp.D)
    assert_kernel_close(got, sp.im2col_plain(*blocks, w, wl))
    assert torch.equal(sp.im2col_product(*blocks, w, wl), got)


@pytest.mark.gpu
@pytest.mark.parametrize("lin_splits", [1, 2, 3])
def test_cuda_linear_splits_match_plain(cuda, lin_splits):
    """P2's linear alone at a forced K split, on relu(P2's first product)
    from the plain version, held to its fp32 product rounded once."""
    b, tb = 4, 50
    blocks = card_blocks(b, tb, 17, cuda, seed=6)
    w = card_weights(cuda, 9, sp.D, sp.D)
    wl = card_weights(cuda, 16 * sp.D, sp.D, seed=7)
    a = torch.relu(sp.taps_plain(*blocks, w, sp.TAPS_WITH_COPIES)).reshape(
        b * tb, 16 * sp.D)
    got = sp.linear_ws(a, wl, splits=lin_splits)
    assert_kernel_close(got, (a.float() @ wl.float()).to(torch.bfloat16))


@pytest.mark.gpu
def test_cuda_im2col_allocates_no_patch(cuda):
    """P2's path holds the product and the output, never an [M, 6912]
    patch."""
    b, tb = 4, 64
    blocks = card_blocks(b, tb, 17, cuda, seed=8)
    w = card_weights(cuda, 9 * sp.D, sp.D)
    wl = card_weights(cuda, 16 * sp.D, sp.D, seed=9)
    sp.im2col_product(*blocks, w, wl)        # the plan is on the card
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sp.im2col_product(*blocks, w, wl)
    torch.cuda.synchronize()
    m = b * tb * sp.FREQ
    peak = torch.cuda.max_memory_allocated() - base
    # s2, the output and the linear's fp32 partials: under half the patch
    assert peak < m * 9 * sp.D * 2 // 2
