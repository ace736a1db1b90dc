"""The FFN fold probe (P4) on its redesign (``csrc/ffn_ws.cu``: a row pass
and two products on ``csrc/conv_ws.cuh``'s warp-specialised core, driven by
``gigaam_tpu_torch/probes/fold_probes.py``).

On the CPU the plans of the two products (``ffn_plans``, pure functions of
M and the card's slots) are held to what the kernels need of them: every
[128, 256] output tile and K item in exactly one unit, cluster partners on
one column tile and K range, the forced K splits in order, at M 1, 7, 500,
8000, 16384 and 98304 on cards of 132 and 114 SMs; the staged plain version
(the row pass, the SiLU product, the residual product) equals
``ffn_fold_plain`` bit for bit; the wrapper takes the plain version for CPU
tensors.

The tests marked ``gpu`` hold each stage and the whole against its plain
version on the card in bf16 at those M, with forced K splits 1, 2 and 3
and the plans' own, within a tenth of the term's RMS plus one bf16 rounding
of the value (``chip_smoke.py``'s limit), the kept one-launch fold too, and
two calls bit-equal; they skip without a card (on the card: ``pytest
--noconftest -m gpu tests/test_torch_ffn_ws.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gigaam_tpu_torch.probes import fold_probes as fp
from gigaam_tpu_torch.probes.ws_plan import WS_BK, WS_BM
from gigaam_tpu_torch.weights import sub_block_from_jax

D, DFF = fp.D, fp.DFF
ROWS = [1, 7, 500, 8000, 16384, 98304]
CARDS = [132, 114]
SPLITS = [None, 1, 2, 3]


def coverage(units, row_tiles, col_tiles, k_items):
    """counts[row tile, column tile, K item]; phantom row tiles (the
    cluster's pad past the last) in the last row"""
    counts = np.zeros((row_tiles + 1, col_tiles, k_items), dtype=np.int64)
    for r, cs, first, count in units:
        counts[min(r, row_tiles), cs & 0xffff, first:first + count] += 1
    return counts


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("sms", CARDS)
@pytest.mark.parametrize("m", ROWS)
def test_plans_cover_every_tile_and_k_item_once(m, sms, splits):
    row_tiles = -(-m // WS_BM)
    plans = fp.ffn_plans(m, sms, (splits, splits))
    for (units, grid, got_splits), (n, k) in zip(plans,
                                                ((DFF, D), (D, DFF))):
        counts = coverage(units, row_tiles, n // fp.FFN_BN, k // WS_BK)
        assert (counts[:row_tiles] == 1).all()
        assert (counts[row_tiles] == -row_tiles % fp.FFN_CLUSTER).all()
        assert splits is None or got_splits == splits
        assert len({int(cs) >> 16 for cs in units[:, 1]}) == got_splits
        # partners: consecutive units, neighbouring row tiles, one column
        # tile and K range, on the two blocks of a cluster
        assert len(units) % 2 == 0 and grid % 2 == 0
        lo, hi = units[0::2], units[1::2]
        assert (lo[:, 1:] == hi[:, 1:]).all()
        assert (hi[:, 0] == lo[:, 0] + 1).all()
        assert grid == min(len(units), sms // 2 * 2)
        # each split's K range in order, the ranges adjacent
        for s in range(got_splits):
            firsts = sorted({int(u[2]) for u in units
                             if int(u[1]) >> 16 == s})
            assert firsts == [s * (k // WS_BK) // got_splits]


def test_plans_split_k_only_where_the_tiles_leave_the_card_idle():
    """One split where the products' tiles fill the card many times over
    (the scripts' shapes and the main path's); more for a handful of
    rows."""
    for m in (8000, 16384, 98304):
        assert [p[2] for p in fp.ffn_plans(m, 132)] == [1, 1]
    assert all(p[2] > 1 for p in fp.ffn_plans(7, 132))


def ffn_weights(dtype):
    ln_np, p_np, _ = fp.ffn_inputs(1, 1)
    ln_p = fp.tree_to(sub_block_from_jax(ln_np), "cpu")
    p32 = fp.tree_to(sub_block_from_jax(p_np), "cpu")
    return fp.prepare_ffn(ln_p, p32, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t", [(1, 1), (2, 7), (3, 33)])
def test_staged_plain_equals_the_fold_plain_bit_for_bit(b, t, dtype):
    w = ffn_weights(dtype)
    rng = np.random.default_rng(b * 100 + t)
    x = torch.from_numpy(0.5 * rng.standard_normal((b, t, D))).to(dtype)
    assert torch.equal(fp.ffn_staged_plain(w, x), fp.ffn_fold_plain(w, x))


def test_cpu_wrapper_takes_the_plain_version():
    w = ffn_weights(torch.bfloat16)
    x = torch.from_numpy(
        0.5 * np.random.default_rng(0).standard_normal((2, 5, D))).to(
            torch.bfloat16)
    fp.reset_launch_counts()
    assert torch.equal(fp.ffn_fold(w, x), fp.ffn_fold_plain(w, x))
    assert fp.ffn_fold.launches == 0


# ---------------------------------------------------------------------------
# On the card: each stage and the whole against the plain version, bf16
# ---------------------------------------------------------------------------

GPU_REL, GPU_RTOL = 0.1, 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest "
                    "--noconftest -m gpu tests/test_torch_ffn_ws.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_inputs(m, dev):
    """The script's weights on the card (bf16 matrices) and x [1, M, 768]
    bf16 drawn on the card."""
    w = ffn_weights(torch.bfloat16)
    w = dataclasses.replace(w, **{f.name: getattr(w, f.name).to(dev)
                                  for f in dataclasses.fields(w)})
    gen = torch.Generator(device=dev).manual_seed(m)
    x = (0.5 * torch.randn(1, m, D, generator=gen, device=dev)).to(
        torch.bfloat16)
    return w, x


def assert_close(got, ref, base=None):
    """Within the limit on the term beside ``base`` (the residual), or on
    the value itself."""
    got, ref = got.float(), ref.float()
    term = ref if base is None else ref - base.float()
    rms = float(term.pow(2).mean().sqrt())
    err = (got - ref).abs()
    assert float((err - GPU_RTOL * ref.abs()).max()) <= GPU_REL * rms


@pytest.mark.gpu
@pytest.mark.parametrize("m", ROWS)
def test_cuda_row_pass_matches_plain(cuda, m):
    w, x = card_inputs(m, cuda)
    x2 = x.view(m, D)
    assert_close(fp.ffn_rows_ws(w, x2), fp.ffn_rows_plain(w, x2))


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 2, 3, None])
@pytest.mark.parametrize("m", ROWS)
def test_cuda_silu_product_matches_plain(cuda, m, splits):
    w, x = card_inputs(m, cuda)
    xn = fp.ffn_rows_plain(w, x.view(m, D))
    got = fp.silu_product_ws(xn, w.w1, w.b1, splits)
    assert_close(got, fp.silu_product_plain(xn, w.w1, w.b1))
    assert torch.equal(fp.silu_product_ws(xn, w.w1, w.b1, splits), got)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 2, 3, None])
@pytest.mark.parametrize("m", ROWS)
def test_cuda_residual_product_matches_plain(cuda, m, splits):
    w, x = card_inputs(m, cuda)
    x2 = x.view(m, D)
    h = fp.silu_product_plain(fp.ffn_rows_plain(w, x2), w.w1, w.b1)
    got = fp.residual_product_ws(h, w.w2, w.b2, x2, splits)
    assert_close(got, fp.residual_product_plain(h, w.w2, w.b2, x2), x2)
    assert torch.equal(fp.residual_product_ws(h, w.w2, w.b2, x2, splits),
                       got)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("m", ROWS)
def test_cuda_whole_matches_plain_at_forced_splits(cuda, m, splits):
    w, x = card_inputs(m, cuda)
    got = fp.ffn_ws(w, x, (splits, splits))
    assert_close(got, fp.ffn_fold_plain(w, x), x)


@pytest.mark.gpu
@pytest.mark.parametrize("m", ROWS)
def test_cuda_fold_runs_the_redesign(cuda, m):
    w, x = card_inputs(m, cuda)
    before = fp.ffn_fold.launches
    got = fp.ffn_fold(w, x)
    assert fp.ffn_fold.launches == before + 1
    ref = fp.ffn_fold_plain(w, x)
    assert_close(got, ref, x)
    assert torch.equal(fp.ffn_fold(w, x), got)
    # the kept one-launch fold counts nothing and agrees too
    ring = fp.ffn_fold_ring(w, x)
    assert fp.ffn_fold.launches == before + 2
    assert_close(ring, ref, x)


@pytest.mark.gpu
def test_cuda_stages_refuse_what_the_kernels_do_not_take(cuda):
    w, x = card_inputs(64, cuda)
    x2 = x.view(64, D)
    with pytest.raises(ValueError, match="x is torch.float32"):
        fp.ffn_rows_ws(w, x2.float())
    with pytest.raises(ValueError, match="w1 has shape"):
        fp.silu_product_ws(x2, w.w2, w.b1)
    with pytest.raises(ValueError, match="h must be"):
        fp.residual_product_ws(x2, w.w2, w.b2, x2)
