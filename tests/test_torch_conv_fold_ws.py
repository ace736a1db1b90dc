"""The conv-module fold probe (P5) on its redesign (``csrc/conv_fold_ws.cu``:
P4's row pass, the GLU product and the pointwise product on
``csrc/conv_ws.cuh``'s ping-pong core, the depthwise pass on the CUDA cores
between them, driven by ``gigaam_tpu_torch/probes/fold_probes.py``).

On the CPU: the staged plain version (the row pass, the GLU product, the
depthwise pass, the pointwise product with the residual) equals
``conv_fold_plain`` bit for bit in bf16 and fp32 at B 1-3 with ragged
lengths, T 1, T under the 31-tap window and T no multiple of 64; in fp32 it
agrees with the JAX package's ``conformer_conv(layer_norm(x)) + x`` at a
narrow width; ``interleave_vg`` is a column permutation whose blocks give
back Wv and Wg, each 256-wide tile holding the value and the gate of the same 128
channels; the products' plans (``conv_plans``: ``ws_plan`` with K unsplit
for 64-row tiles in clusters of two) cover every tile once; the wrapper
takes the plain version for CPU tensors and counts no launch; the card
path's checks refuse what the kernels do not take; the library's entry
points match their declared signatures.

The tests marked ``gpu`` hold each stage and the whole against its plain
version on the card in bf16 within a tenth of the term's RMS plus one bf16
rounding of the value (``chip_smoke.py``'s limit), two calls bit-equal,
and the kept kernels (``conv_fold_ring``) too; they skip without a card
(on the card: ``pytest --noconftest -m gpu
tests/test_torch_conv_fold_ws.py``).
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from gigaam_tpu_torch.probes import fold_probes as fp
from gigaam_tpu_torch.probes.ws_plan import PP_BM, WS_BK
from gigaam_tpu_torch.weights import sub_block_from_jax

D, K = fp.D, fp.K
NARROW = 64
ROWS = [1, 7, 500, 8000, 24576, 98304]
CARDS = [132, 114]
# (B, T): T 1, under the window, no multiple of 64
SHAPES = [(1, 1), (2, 17), (3, 70), (2, 64), (3, 29)]


def draw_tree(seed, d):
    """(ln_p, p): a conv module and its LayerNorm at width d, JAX layout
    (numpy), the scales of the script's draw."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: np.asarray(0.05 * rng.standard_normal(s), np.float32)
    p = {"pointwise_conv1": {"w_value": f32(d, d), "b_value": f32(d),
                             "w_gate": f32(d, d), "b_gate": f32(d)},
         "depthwise_conv": {"w": f32(K, 1, d), "b": f32(d)},
         "batch_norm": {"scale": 1.0 + f32(d), "bias": f32(d),
                        "mean": f32(d), "var": 1.0 + np.abs(f32(d))},
         "pointwise_conv2": {"w": f32(d, d), "b": f32(d)}}
    return {"scale": 1.0 + f32(d), "bias": f32(d)}, p


def port(tree):
    return fp.tree_to(sub_block_from_jax(tree), "cpu")


def ragged(b, t):
    """Row 0 full, the others shorter (at least one frame)."""
    lens = np.array([t] + [max(1, t - 3 - 5 * i) for i in range(1, b)])
    return np.arange(t)[None, :] < lens[:, None]


def case(b, t, d, dtype, seed=0):
    ln_np, p_np = draw_tree(seed, d)
    w = fp.prepare_conv(port(ln_np), port(p_np), dtype)
    rng = np.random.default_rng(seed + 100 * b + t)
    x = torch.from_numpy(0.5 * rng.standard_normal((b, t, d))).to(dtype)
    return w, x, torch.from_numpy(ragged(b, t))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t", SHAPES)
def test_staged_plain_equals_the_fold_plain_bit_for_bit(b, t, dtype):
    w, x, valid = case(b, t, NARROW, dtype, seed=b + t)
    got = fp.conv_staged_plain(w, x, valid)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, fp.conv_fold_plain(w, x, valid))


def test_staged_plain_equals_the_fold_plain_at_full_width():
    w, x, valid = case(2, 33, D, torch.bfloat16, seed=5)
    assert torch.equal(fp.conv_staged_plain(w, x, valid),
                       fp.conv_fold_plain(w, x, valid))


def test_plain_stages_zero_padded_frames_and_keep_elements_apart():
    """y is zero on padded frames; each element's taps see zeros past its
    ends, so an element's output does not depend on its neighbour."""
    w, x, valid = case(2, 40, NARROW, torch.float32, seed=3)
    xn = fp.conv_rows_plain(w, x)
    y = fp.glu_product_plain(w, xn, valid)
    assert (y[~valid] == 0).all() and (y[valid] != 0).any()
    c = fp.depthwise_plain(w, y)
    alone = fp.depthwise_plain(w, y[1:])
    assert torch.equal(c[1:], alone)


def test_staged_plain_matches_the_jax_conv_module_fp32():
    """x + conformer_conv(layer_norm(x)) of the JAX package (BatchNorm in
    inference), fp32, on the valid frames, within 1e-5 of the largest
    value: the same math, the rounding points no-ops, in another order."""
    import jax.numpy as jnp
    from gigaam_tpu.ops import conformer_ops as jops

    b, t = 3, 40
    ln_np, p_np = draw_tree(11, NARROW)
    rng = np.random.default_rng(12)
    x = (0.5 * rng.standard_normal((b, t, NARROW))).astype(np.float32)
    valid = ragged(b, t)
    jt = lambda tree: {k: jt(v) if isinstance(v, dict) else jnp.asarray(v)
                       for k, v in tree.items()}
    ref = np.asarray(jnp.asarray(x) + jops.conformer_conv(
        jt(p_np), jops.layer_norm(jt(ln_np), jnp.asarray(x)),
        jnp.asarray(valid), "batch_norm")[0])
    w = fp.prepare_conv(port(ln_np), port(p_np), torch.float32)
    got = fp.conv_staged_plain(w, torch.from_numpy(x),
                               torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got[valid], ref[valid], rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("d", [NARROW, 96, D])
def test_interleave_is_a_permutation_that_gives_back_wv_and_wg(d):
    gen = torch.Generator().manual_seed(d)
    wv = torch.randn(d, d, generator=gen)
    wg = torch.randn(d, d, generator=gen)
    w_vg = fp.interleave_vg(wv, wg)
    assert w_vg.shape == (d, 2 * d) and w_vg.is_contiguous()
    # the inverse: block i of each half back in place
    halves = w_vg.reshape(d, -1, 2, fp._vg_block(d))
    assert torch.equal(halves[:, :, 0].reshape(d, d), wv)
    assert torch.equal(halves[:, :, 1].reshape(d, d), wg)
    # every column of Wv and of Wg once: the interleave of the columns'
    # indices is a permutation, and W_vg's columns are those columns
    src = fp.interleave_vg(torch.arange(d)[None].double(),
                           torch.arange(d, 2 * d)[None].double())[0].long()
    assert torch.equal(src.sort().values, torch.arange(2 * d))
    assert torch.equal(w_vg, torch.cat([wv, wg], dim=1)[:, src])


def test_a_product_tile_holds_value_and_gate_of_the_same_channels():
    """At the kernels' width each 256-wide tile c is Wv's columns 128 c ..
    then Wg's same columns: the accumulator's fragment columns 8 j + 2 l
    and 8 (j + 16) + 2 l are the value and the gate of one channel."""
    w, _, _ = case(1, 1, D, torch.bfloat16)
    half = fp.CONV_BN // 2
    for c in range(2 * D // fp.CONV_BN):
        tile = w.w_vg[:, c * fp.CONV_BN:(c + 1) * fp.CONV_BN]
        assert torch.equal(tile[:, :half], w.wv[:, c * half:(c + 1) * half])
        assert torch.equal(tile[:, half:], w.wg[:, c * half:(c + 1) * half])


def coverage(units, row_tiles, col_tiles):
    counts = np.zeros((row_tiles + 1, col_tiles), dtype=np.int64)
    for r, c, first, count in units:
        assert first == 0 and count == D // WS_BK
        counts[min(r, row_tiles), c] += 1
    return counts


@pytest.mark.parametrize("sms", CARDS)
@pytest.mark.parametrize("m", ROWS)
def test_plans_cover_every_tile_once(m, sms):
    row_tiles = -(-m // PP_BM)
    for (units, grid), n in zip(fp.conv_plans(m, sms), (2 * D, D)):
        counts = coverage(units, row_tiles, n // fp.CONV_BN)
        assert (counts[:row_tiles] == 1).all()
        assert (counts[row_tiles] == -row_tiles % fp.CONV_CLUSTER).all()
        assert grid == min(len(units), sms // 2 * 2) and grid % 2 == 0
        # partners: consecutive units, neighbouring row tiles, one column
        lo, hi = units[0::2], units[1::2]
        assert (lo[:, 1:] == hi[:, 1:]).all()
        assert (hi[:, 0] == lo[:, 0] + 1).all()


def test_cpu_wrapper_takes_the_plain_version_and_counts_no_launch():
    w, x, valid = case(2, 21, D, torch.bfloat16, seed=2)
    fp.reset_launch_counts()
    assert torch.equal(fp.conv_fold(w, x, valid),
                       fp.conv_fold_plain(w, x, valid))
    assert fp.conv_fold.launches == 0


def test_card_path_checks_refuse_what_the_kernels_do_not_take():
    w, x, valid = case(2, 16, D, torch.bfloat16)
    fp._check_conv_ws_args(w, x, valid)
    fp._check_conv_ws_args(w, x, None)
    with pytest.raises(ValueError, match="needs w_vg"):
        fp._check_conv_ws_args(dataclasses.replace(w, w_vg=None), x, valid)
    with pytest.raises(ValueError, match="w_vg has shape"):
        fp._check_conv_ws_args(dataclasses.replace(
            w, w_vg=w.w_vg[:, :D].contiguous()), x, valid)
    with pytest.raises(ValueError, match="w_vg is torch.float32"):
        fp._check_conv_ws_args(dataclasses.replace(
            w, w_vg=w.w_vg.float()), x, valid)
    with pytest.raises(ValueError, match="x is torch.float32"):
        fp._check_conv_ws_args(w, x.float(), valid)
    with pytest.raises(ValueError, match="valid has shape"):
        fp._check_conv_ws_args(w, x, valid[:, :8])
    with pytest.raises(ValueError, match="runs on the card only"):
        fp.conv_fold_ring(w, x, valid)


def test_the_redesign_library_is_registered_for_its_launches():
    """Each entry point is in its source with the argument count that
    ``cuda_lib`` declares, and the kernels that ``dynamic_resources`` names
    are the source's."""
    from gigaam_tpu_torch.ops import cuda_lib

    with open(os.path.join(cuda_lib.CSRC_DIR, "conv_fold_ws.cu")) as f:
        text = f.read()
    for fn, argtypes in cuda_lib.SIGNATURES["conv_fold_ws"].items():
        m = re.search(rf"int {fn}\(([^)]*)\)", text)
        assert m, fn
        assert len(m.group(1).split(",")) == len(argtypes), fn
    for kernel in cuda_lib.CONV_FOLD_WS_KERNELS:
        assert kernel.split("<")[0] in text, kernel


# ---------------------------------------------------------------------------
# On the card: each stage and the whole against the plain version, bf16
# ---------------------------------------------------------------------------

GPU_REL, GPU_RTOL = 0.1, 2.0 ** -7
CARD_SHAPES = [(1, 1), (2, 17), (3, 70), (16, 500), (4, 768)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest "
                    "--noconftest -m gpu tests/test_torch_conv_fold_ws.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_case(b, t, dev):
    """The script's weights (full width, bf16 matrices) and x, valid on the
    card."""
    ln_np, p_np, x_np, _ = fp.conv_inputs(1, 1)
    w = fp.prepare_conv(port(ln_np), port(p_np), torch.bfloat16)
    w = dataclasses.replace(w, **{f.name: getattr(w, f.name).to(dev)
                                  for f in dataclasses.fields(w)})
    gen = torch.Generator(device=dev).manual_seed(b * 1000 + t)
    x = (0.5 * torch.randn(b, t, D, generator=gen, device=dev)).to(
        torch.bfloat16)
    return w, x, torch.from_numpy(ragged(b, t)).to(dev)


def assert_close(got, ref, valid, base=None):
    """Within the limit on the valid frames, on the term beside ``base``
    (the residual) or on the value itself."""
    got, ref = got.float()[valid], ref.float()[valid]
    term = ref if base is None else ref - base.float()[valid]
    rms = float(term.pow(2).mean().sqrt())
    err = (got - ref).abs()
    assert float((err - GPU_RTOL * ref.abs()).max()) <= GPU_REL * rms


@pytest.mark.gpu
@pytest.mark.parametrize("b,t", CARD_SHAPES)
def test_cuda_stages_match_their_plain_versions(cuda, b, t):
    w, x, valid = card_case(b, t, cuda)
    xn = fp.conv_rows_ws(w, x)
    assert_close(xn, fp.conv_rows_plain(w, x), valid)
    y = fp.glu_product_ws(w, xn, valid)
    assert_close(y, fp.glu_product_plain(w, xn, valid), valid)
    assert (y[~valid] == 0).all()
    c = fp.depthwise_ws(w, y)
    assert_close(c, fp.depthwise_plain(w, y), valid)
    out = fp.conv_residual_product_ws(w, c, x)
    assert_close(out, fp.conv_residual_product_plain(w, c, x), valid, x)
    assert torch.equal(fp.depthwise_ws(w, y), c)
    assert torch.equal(fp.glu_product_ws(w, xn, valid), y)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t", CARD_SHAPES)
def test_cuda_fold_runs_the_redesign(cuda, b, t):
    w, x, valid = card_case(b, t, cuda)
    before = fp.conv_fold.launches
    got = fp.conv_fold(w, x, valid)
    assert fp.conv_fold.launches == before + 1
    ref = fp.conv_fold_plain(w, x, valid)
    assert_close(got, ref, valid, x)
    assert torch.equal(fp.conv_fold(w, x, valid), got)
    # the kept kernels count nothing and agree too
    ring = fp.conv_fold_ring(w, x, valid)
    assert fp.conv_fold.launches == before + 2
    assert_close(ring, ref, valid, x)


@pytest.mark.gpu
def test_cuda_stages_refuse_what_the_kernels_do_not_take(cuda):
    w, x, valid = card_case(2, 64, cuda)
    with pytest.raises(ValueError, match="x is torch.float32"):
        fp.glu_product_ws(w, x.float(), valid)
    with pytest.raises(ValueError, match="c has shape"):
        fp.conv_residual_product_ws(w, x[:1], x)
    with pytest.raises(ValueError, match="needs w_vg"):
        fp.conv_fold(dataclasses.replace(w, w_vg=None), x, valid)
