"""The attention-fold probes P6 and P7 on their redesign
(``csrc/attn_fold_ws.cu``: K1/K2's row pass, the Q/K/V and output products
on ``csrc/conv_ws.cuh``'s ping-pong and cooperative cores, and P9's walk
with o stored packed (``csrc/sdpa_groups_ws.cu``), driven by
``gigaam_tpu_torch/probes/attn_fold_probes.py``).

On the CPU the plans (``ws_plan`` with K unsplit, as the ping-pong core
walks it, and ``fold_plans``: pure functions of M and the card's slots)
are held to what the kernels need of them: every
(row tile, column tile) in exactly one unit with all 12 K items, cluster
partners on one column tile, a block's consecutive units on alternate
consumers, no 192-wide tile straddling a head and no tile straddling
column 768 or 1536, at M 1, 7, 500, 4096, 8000, 24576 and 98304, N 768
and 2304, tiles 192 and 256 wide, on cards of 132 and 114 SMs; the staged
plain version (the row pass, the Q/K/V stage with its bias and rounding,
head-major q, k, v, the SDPA, o packed, the output stage) equals
``fold_plain`` bit for bit at B 1-3, T 1-130, with and without per-head
weights; the wrappers and the stages take their plain versions for CPU
tensors and count no launch.

The tests marked ``gpu`` hold each stage against its plain stage on the
card in bf16 at M 500 and 8000 and at T 7, 65 and 501 with ragged masks,
the SDPA stage bit-equal to K3 (``gigaam_sdpa``) on the same q, k, v, each
wrapper and schedule against ``fold_plain`` within a tenth of the output's
RMS plus one bf16 rounding of the value (``chip_smoke.py``'s limit), two
calls bit-equal, and the redesign against the kept kernels
(``fold_ring``); they skip without a card (on the card: ``pytest
--noconftest -m gpu tests/test_torch_attn_fold_ws.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from gigaam_tpu_torch.ops import fused_attention as fa
from gigaam_tpu_torch.probes import attn_fold_probes as afp
from gigaam_tpu_torch.probes.ws_plan import PP_BM, WS_BK, WS_BM, ws_plan
from gigaam_tpu_torch.weights import sub_block_from_jax

D, H, DH = afp.D, afp.H, afp.DH
ROWS = [1, 7, 500, 4096, 8000, 24576, 98304]
WIDTHS = [768, 2304]
TILES = [192, 256]
CARDS = [132, 114]
K_ITEMS = D // WS_BK


def pingpong_owners(n_units, grid):
    """(block, consumer) of each unit as ``PingPongCore`` runs a plan: unit
    u on block u % grid, the block's i-th unit on consumer i % 2."""
    u = np.arange(n_units)
    return u % grid, (u // grid) % 2


def coverage(units, row_tiles, col_tiles):
    """counts[row tile, column tile]; phantom row tiles (a cluster's pad
    past the last) in the last row"""
    counts = np.zeros((row_tiles + 1, col_tiles), dtype=np.int64)
    for r, c, first, count in units:
        assert first == 0 and count == K_ITEMS
        counts[min(r, row_tiles), c] += 1
    return counts


@pytest.mark.parametrize("sms", CARDS)
@pytest.mark.parametrize("bn", TILES)
@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("m", ROWS)
def test_pingpong_plan_covers_every_tile_once(m, n, bn, sms):
    row_tiles = -(-m // PP_BM)
    for cluster in (1, 2):
        units, grid, _ = ws_plan(row_tiles, n // bn, K_ITEMS, sms, m * n,
                                 bn, cluster, splits=1)
        assert units.dtype == np.int32 and units.shape[1] == 4
        counts = coverage(units, row_tiles, n // bn)
        assert (counts[:row_tiles] == 1).all()
        assert (counts[row_tiles] == -row_tiles % cluster).all()
        assert grid == min(len(units), sms // cluster * cluster)
        assert grid % cluster == 0
        if cluster == 2:
            # partners: consecutive units on the two blocks of a cluster,
            # one column tile, neighbouring row tiles
            lo, hi = units[0::2], units[1::2]
            assert (lo[:, 1:] == hi[:, 1:]).all()
            assert (hi[:, 0] == lo[:, 0] + 1).all()


@pytest.mark.parametrize("sms", CARDS)
@pytest.mark.parametrize("m", ROWS)
def test_consecutive_units_of_a_block_go_to_alternate_consumers(m, sms):
    for schedule in (afp.LANE_SLICES, afp.HEAD_TILES):
        for units, grid in afp.fold_plans(m, schedule, sms):
            block, consumer = pingpong_owners(len(units), grid)
            for bl in range(grid):
                mine = consumer[block == bl]
                assert len(mine) >= 1 and mine[0] == 0
                assert (np.diff(mine) != 0).all()
            # cluster partners on the two blocks of a cluster, each on the
            # same consumer of its block
            if afp.SCHEDULE_TILES[schedule][2] == 2:
                assert (block[0::2] % 2 == 0).all()
                assert (block[1::2] == block[0::2] + 1).all()
                assert (consumer[0::2] == consumer[1::2]).all()


@pytest.mark.parametrize("schedule", sorted(afp.SCHEDULE_TILES))
@pytest.mark.parametrize("m", ROWS)
def test_no_tile_straddles_a_head_column_768_or_1536(m, schedule):
    """Each column tile picks its A map (xr before column 1536, x after)
    and its weight (Wq, Wk, Wv by 768s) by itself; a 192-wide tile holds
    four whole heads, which the per-head blocks need."""
    bm, bn, _ = afp.SCHEDULE_TILES[schedule]
    for (units, _), n in zip(afp.fold_plans(m, schedule, 132),
                             (3 * D, D)):
        cols = np.unique(units[:, 1] & 0xffff)
        assert (cols == np.arange(n // bn)).all()
        for c in cols:
            first, last = c * bn, (c + 1) * bn - 1
            assert first // D == last // D
            assert (first < 2 * D) == (last < 2 * D)
            if bn == 192:
                assert first % DH == 0 and (last + 1) % DH == 0
                assert (last + 1 - first) // DH == 4


@pytest.mark.parametrize("sms", CARDS)
@pytest.mark.parametrize("m", ROWS)
def test_cooperative_plans_cover_every_tile_once_unsplit(m, sms):
    for schedule in (afp.COOP, afp.COOP_CLUSTER):
        bm, bn, cluster = afp.SCHEDULE_TILES[schedule]
        row_tiles = -(-m // bm)
        for (units, grid), n in zip(afp.fold_plans(m, schedule, sms),
                                    (3 * D, D)):
            counts = coverage(units, row_tiles, n // bn)
            assert (counts[:row_tiles] == 1).all()
            assert (counts[row_tiles] == -row_tiles % cluster).all()
            assert (units[:, 1] >> 16 == 0).all()
            assert grid == min(len(units), sms // cluster * cluster)


@settings(max_examples=40, deadline=None)
@given(m=st.integers(1, 200000), sms=st.integers(2, 160),
       schedule=st.sampled_from(sorted(afp.SCHEDULE_TILES)))
def test_fold_plans_cover_every_tile_once_drawn(m, sms, schedule):
    bm, bn, cluster = afp.SCHEDULE_TILES[schedule]
    row_tiles = -(-m // bm)
    for (units, grid), n in zip(afp.fold_plans(m, schedule, sms),
                                (3 * D, D)):
        counts = coverage(units, row_tiles, n // bn)
        assert (counts[:row_tiles] == 1).all()
        assert 1 <= grid <= len(units) and grid % cluster == 0


def test_the_wrappers_keep_their_probes_questions():
    """foldB and nb 1 on 64 x 256 ping-pong tiles (in clusters of two),
    foldA on 64 x 192 ones of whole heads, nb 2 and 4 on 128-row
    cooperative tiles, nb 4 in clusters of two."""
    tiles = afp.SCHEDULE_TILES
    assert tiles[afp.FOLDB_SCHEDULE] == (PP_BM, 256, 2)
    assert tiles[afp.FOLDA_SCHEDULE] == (PP_BM, 192, 1)
    assert afp.FOLDA_SCHEDULE == afp.HEAD_TILES
    assert afp.NB_SCHEDULE[1] == afp.FOLDB_SCHEDULE
    assert tiles[afp.NB_SCHEDULE[2]] == (WS_BM, 256, 1)
    assert tiles[afp.NB_SCHEDULE[4]] == (WS_BM, 256, 2)
    assert set(afp.NB_SCHEDULE) == set(afp.NB_TILES)


def test_the_redesign_library_is_registered_for_its_launches():
    """Each entry the wrappers call is in its source with the argument
    count that ``cuda_lib`` declares, and the kernels that
    ``dynamic_resources`` names are the source's instances."""
    import os
    import re

    from gigaam_tpu_torch.ops import cuda_lib

    for lib, fns in (("attn_fold_ws", cuda_lib.SIGNATURES["attn_fold_ws"]),):
        with open(os.path.join(cuda_lib.CSRC_DIR, f"{lib}.cu")) as f:
            text = f.read()
        for fn, argtypes in fns.items():
            m = re.search(rf"int {fn}\(([^)]*)\)", text)
            assert m, fn
            assert len(m.group(1).split(",")) == len(argtypes), fn
    with open(os.path.join(cuda_lib.CSRC_DIR, "attn_fold_ws.cu")) as f:
        text = f.read()
    for kernel in cuda_lib.ATTN_FOLD_WS_KERNELS:
        assert kernel in text, kernel
    assert len(cuda_lib.ATTN_FOLD_WS_KERNELS) == 2 * len(afp.SCHEDULE_TILES) + 1
    # P9's translation unit holds P9's kernel alone
    with open(os.path.join(cuda_lib.CSRC_DIR, "sdpa_groups_ws.cu")) as f:
        assert f.read().count("__global__") == 1


# ---------------------------------------------------------------------------
# The staged plain version, on the CPU
# ---------------------------------------------------------------------------

def cpu_weights(dtype, t):
    params_np, _, _ = afp.fold_inputs(1, 1)
    p32 = afp.tree_to(sub_block_from_jax(params_np), "cpu")
    _, _, cos_w, sin_w, r = afp._tables(t, "cpu")
    return afp.prepare_fold(p32, cos_w, sin_w, r, dtype,
                            per_head_weights=True, divide=True)


def cpu_inputs(b, t, dtype):
    rng = np.random.default_rng(b * 1000 + t)
    x = torch.from_numpy(0.5 * rng.standard_normal((b, t, D))).to(dtype)
    return x, torch.from_numpy(afp.ragged_valid(b, t))


@pytest.mark.parametrize("heads", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t", [(1, 1), (2, 7), (3, 65), (1, 130),
                                 (2, 100)])
def test_staged_plain_equals_the_fold_plain_bit_for_bit(b, t, dtype, heads):
    w = cpu_weights(dtype, t)
    x, valid = cpu_inputs(b, t, dtype)
    got = afp.fold_staged_plain(w, x, valid, heads)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, afp.fold_plain(w, x, valid, heads=heads))


@pytest.mark.parametrize("heads", [False, True])
def test_plain_stages_have_the_kernels_layouts(heads):
    b, t = 2, 9
    w = cpu_weights(torch.bfloat16, t)
    x, valid = cpu_inputs(b, t, torch.bfloat16)
    xr = fa.ln_rope_plain(x, w.cos, w.sin, H)[1]
    q, k, v = afp.qkv_plain(w, xr, x, heads)
    assert all(a.shape == (b, H, t, DH) and a.dtype == x.dtype
               for a in (q, k, v))
    f = afp._fold_of(w, heads)
    # head h of q is columns 48 h .. of the rounded projection
    flat = (xr.float() @ f.wq.float() + f.bq).to(x.dtype)
    assert torch.equal(q[1, 5], flat[1, :, 5 * DH:6 * DH])
    o = afp.sdpa_packed_plain(q, k, v, valid)
    assert o.shape == (b, t, D)
    assert torch.equal(o[:, :, 3 * DH:4 * DH],
                       fa._sdpa_plain(q, k, v, valid, 1.0)[:, 3])


def test_cpu_wrappers_and_stages_take_the_plain_versions():
    b, t = 2, 5
    w = cpu_weights(torch.bfloat16, t)
    x, valid = cpu_inputs(b, t, torch.bfloat16)
    afp.reset_launch_counts()
    ref = afp.fold_plain(w, x, valid)
    assert torch.equal(afp.fold_lane_slices(w, x, valid), ref)
    for nb in (1, 2):
        assert torch.equal(afp.fold_nb(w, x, valid, nb), ref)
    assert torch.equal(afp.fold_heads(w, x, valid),
                       afp.fold_plain(w, x, valid, heads=True))
    for schedule in afp.SCHEDULE_TILES:
        heads = schedule == afp.HEAD_TILES
        assert torch.equal(afp.fold_ws(w, x, valid, schedule),
                           afp.fold_plain(w, x, valid, heads=heads))
    xr = fa.ln_rope(x, w.cos, w.sin, H)[1]
    qkv = afp.qkv_ws(w, xr, x, afp.HEAD_TILES)
    assert all(torch.equal(a, p) for a, p in
               zip(qkv, afp.qkv_plain(w, xr, x, True)))
    o = afp.sdpa_packed_ws(*qkv, valid)
    assert torch.equal(o, afp.sdpa_packed_plain(*qkv, valid))
    assert torch.equal(afp.out_ws(w, o, afp.LANE_SLICES),
                       afp.out_plain(w, o))
    assert all(fn.launches == 0 for fn in afp.KERNELS)
    with pytest.raises(ValueError, match="card only"):
        afp.fold_ring(w, x, valid)


# ---------------------------------------------------------------------------
# On the card: each stage and the whole against the plain version, bf16
# ---------------------------------------------------------------------------

GPU_REL, GPU_RTOL = 0.1, 2.0 ** -7
# (B, T): M 500 and 8000, and T 7, 65, 501 with ragged masks
CARD_SHAPES = [(1, 500), (16, 500), (3, 7), (2, 65), (2, 501)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest "
                    "--noconftest -m gpu tests/test_torch_attn_fold_ws.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_inputs(b, t, dev):
    """The fold script's weights (foldA's blocks too) and x [B, T, 768]
    bf16 drawn on the card; the scripts' ragged lengths with row 0 full,
    and for T > 7 one row cut to 5 frames."""
    w = cpu_weights(torch.bfloat16, t)
    to = lambda obj: dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(dev) for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})
    w = to(dataclasses.replace(w, fold=to(w.fold)))
    gen = torch.Generator(device=dev).manual_seed(b * 1000 + t)
    x = (0.5 * torch.randn(b, t, D, generator=gen, device=dev)).to(
        torch.bfloat16)
    valid = torch.from_numpy(afp.ragged_valid(b, t))
    if b > 1 and t > 7:
        valid[-1, 5:] = False
    return w, x, valid.to(dev)


def assert_close(got, ref, valid=None):
    """Within the limit on the valid query rows (padded rows are garbage by
    contract where the SDPA stands before them)."""
    got, ref = got.float(), ref.float()
    if valid is not None:
        got, ref = got[valid], ref[valid]
    rms = float(ref.pow(2).mean().sqrt())
    err = (got - ref).abs()
    assert float((err - GPU_RTOL * ref.abs()).max()) <= GPU_REL * rms


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", sorted(afp.SCHEDULE_TILES))
@pytest.mark.parametrize("b,t", CARD_SHAPES)
def test_cuda_qkv_stage_matches_plain(cuda, b, t, schedule):
    w, x, _ = card_inputs(b, t, cuda)
    heads = schedule == afp.HEAD_TILES
    xr = fa.ln_rope(x, w.cos, w.sin, H)[1]
    got = afp.qkv_ws(w, xr, x, schedule)
    for g, p in zip(got, afp.qkv_plain(w, xr, x, heads)):
        assert_close(g, p)
    assert all(torch.equal(a, g) for a, g in
               zip(afp.qkv_ws(w, xr, x, schedule), got))


@pytest.mark.gpu
@pytest.mark.parametrize("b,t", CARD_SHAPES)
def test_cuda_sdpa_stage_matches_plain_and_k3_bit_for_bit(cuda, b, t):
    w, x, valid = card_inputs(b, t, cuda)
    xr = fa.ln_rope(x, w.cos, w.sin, H)[1]
    q, k, v = afp.qkv_ws(w, xr, x, afp.LANE_SLICES)
    got = afp.sdpa_packed_ws(q, k, v, valid)
    assert_close(got, afp.sdpa_packed_plain(q, k, v, valid), valid)
    k3 = torch.empty_like(q)
    with torch.cuda.device(cuda):
        fa._launch_sdpa(q, k, v, valid, k3, 1.0)
    k3 = k3.transpose(1, 2).reshape(b, t, D)
    assert torch.equal(got[valid], k3[valid])
    assert torch.equal(afp.sdpa_packed_ws(q, k, v, valid)[valid], got[valid])


@pytest.mark.gpu
@pytest.mark.parametrize("b,t", [(2, 501), (3, 7)])
def test_cuda_sdpa_stage_stores_no_row_past_t(cuda, b, t):
    """In the packed layout a row past T would be the next batch element's
    row: the stage leaves the rows of a sentinel buffer that it does not
    own untouched."""
    w, x, valid = card_inputs(b, t, cuda)
    xr = fa.ln_rope(x, w.cos, w.sin, H)[1]
    q, k, v = afp.qkv_ws(w, xr, x, afp.LANE_SLICES)
    # a [b + 1, t, 768] buffer: the stage writes the first b elements
    o = torch.full((b + 1, t, D), 7.0, dtype=torch.bfloat16, device=cuda)
    with torch.cuda.device(cuda):
        afp._launch_sdpa_ws([a.data_ptr() for a in (q, k, v)], valid,
                            o.data_ptr(), b, t, q.device)
    assert (o[b] == 7.0).all()
    assert torch.equal(o[:b][valid], afp.sdpa_packed_ws(q, k, v, valid)[valid])


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", sorted(afp.SCHEDULE_TILES))
@pytest.mark.parametrize("b,t", CARD_SHAPES)
def test_cuda_out_stage_matches_plain(cuda, b, t, schedule):
    w, x, _ = card_inputs(b, t, cuda)
    got = afp.out_ws(w, x, schedule)
    assert_close(got, afp.out_plain(w, x))
    assert torch.equal(afp.out_ws(w, x, schedule), got)


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", sorted(afp.SCHEDULE_TILES))
@pytest.mark.parametrize("b,t", CARD_SHAPES)
def test_cuda_fold_schedules_match_plain(cuda, b, t, schedule):
    w, x, valid = card_inputs(b, t, cuda)
    heads = schedule == afp.HEAD_TILES
    got = afp.fold_ws(w, x, valid, schedule)
    assert_close(got, afp.fold_plain(w, x, valid, heads=heads), valid)
    assert torch.equal(afp.fold_ws(w, x, valid, schedule), got)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t", [(8, 512), (16, 500), (1, 500), (4, 65)])
def test_cuda_wrappers_run_the_redesign(cuda, b, t):
    """Each wrapper launches the redesign (counted), matches the plain
    version, gives the same bits twice and agrees with the kept kernels."""
    w, x, valid = card_inputs(b, t, cuda)
    calls = [("fold_lane_slices", lambda: afp.fold_lane_slices(w, x, valid),
              False, 1),
             ("fold_heads", lambda: afp.fold_heads(w, x, valid), True, 1)]
    calls += [("fold_nb", lambda nb=nb: afp.fold_nb(w, x, valid, nb), False,
               nb) for nb in afp.NB_TILES if b % nb == 0]
    for name, call, heads, nb in calls:
        fn = getattr(afp, name)
        before = fn.launches
        got = call()
        assert fn.launches == before + 1
        ref = afp.fold_plain(w, x, valid, heads=heads)
        assert_close(got, ref, valid)
        assert torch.equal(call(), got)
        ring = afp.fold_ring(w, x, valid, nb, heads)
        assert fn.launches == before + 2
        assert_close(ring, ref, valid)
        assert_close(got, ring, valid)


@pytest.mark.gpu
def test_cuda_redesign_refuses_what_it_does_not_take(cuda):
    w, x, valid = card_inputs(2, 64, cuda)
    with pytest.raises(ValueError, match="x is torch.float32"):
        afp.fold_lane_slices(w, x.float(), valid)
    with pytest.raises(ValueError, match="schedule must be"):
        afp.fold_ws(w, x, valid, 9)
    with pytest.raises(ValueError, match="nb 4 does not divide"):
        afp.fold_nb(w, x, valid, 4)
    with pytest.raises(ValueError, match="q must be"):
        afp.sdpa_packed_ws(x, x, x, valid)
    with pytest.raises(ValueError, match="o must be"):
        afp.out_ws(w, x[0], afp.LANE_SLICES)


# ---------------------------------------------------------------------------
# The SASS comparison that shows the kept kernels' machine code unchanged
# (gigaam_tpu_torch/tools/sass_compare.py), on a canned disassembly
# ---------------------------------------------------------------------------

SASS_DUMP = """
\tcode for sm_90a
\t\tFunction : _ZN50_GLOBAL__N__f959347b_17_subsampling_ws_cu_3613ae4c14ws_conv_kernelILi128ELi1ELb0EEEvNS_6WsMapsENS_6WsArgsE
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;    /* 0x00000a00ff017b82 */
                                                             /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;        /* 0x0000000000007919 */
\t\tFunction : _ZN45_GLOBAL__N__baf6e285_12_attention_cu_1bef16dc11sdpa_kernelEPK13__nv_bfloat16S2_S2_PKhPS0_Pfiif
        /*0000*/                   EXIT ;                    /* 0x000000000000794d */
"""


def test_sass_functions_names_the_kernels_and_drops_addresses():
    from gigaam_tpu_torch.tools import sass_compare

    funcs = sass_compare.sass_functions(SASS_DUMP)
    assert sorted(funcs) == ["sdpa_kernel", "ws_conv_kernel<128, 1, false>"]
    assert funcs["ws_conv_kernel<128, 1, false>"][1:] == [
        "LDC R1, c[0x0][0x28] ;", "S2R R0, SR_TID.X ;"]
    assert funcs["sdpa_kernel"] == ["EXIT ;"]


@pytest.mark.parametrize("change,differs", [
    (lambda d: d.replace("/*0010*/", "/*0a10*/"), []),
    (lambda d: d.replace("0x000fe40000000800", "0x000fe40000000000"), []),
    (lambda d: d.replace("SR_TID.X", "SR_TID.Y"),
     ["ws_conv_kernel<128, 1, false>"]),
    (lambda d: d[:d.index("\t\tFunction : _ZN45")], ["sdpa_kernel"])])
def test_sass_compare_flags_only_a_changed_or_missing_kernel(change, differs):
    from gigaam_tpu_torch.tools import sass_compare

    old = sass_compare.sass_functions(SASS_DUMP)
    got = sass_compare.compare(old, sass_compare.sass_functions(
        change(SASS_DUMP)))
    assert sorted(got) == sorted(old)
    assert sorted(k for k, r in got.items() if not r["identical"]) == differs
    assert got["sdpa_kernel"]["old_instructions"] == 1
    assert got["sdpa_kernel"]["new_instructions"] == (
        0 if differs == ["sdpa_kernel"] else 1)
