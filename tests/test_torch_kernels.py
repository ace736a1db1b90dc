"""The port's attention kernels (K3 ``fused_mha``, K2
``folded_rotary_attention``, K1 ``folded_rotary_attention_lnres``; K5
``fused_relpos_mha`` has its CPU tests in ``test_torch_relpos.py``).

On the CPU each wrapper runs its plain version, which is held against the
JAX package's Pallas kernel in interpret mode on valid rows, in fp32
(atol 1e-4: the same math summed in another order).  The tests marked
``gpu`` hold the CUDA kernels against their plain versions on the card in
bf16 (K3 and K5 also their log-sum-exp; K4 and K6 from the forward's saved
pair and without it; repeated runs bit-equal, but for K6's dp, whose batch
sum uses atomics); they skip without one.  The JAX package is imported
inside the CPU tests only, so that the card's host, which has no JAX, runs
the ``gpu`` tests with
``pytest --noconftest -m gpu tests/test_torch_kernels.py``.
"""

import math

import numpy as np
import pytest
import torch

from gigaam_tpu_torch.ops import fused_attention as fa
from gigaam_tpu_torch.ops.rotary import rotary_tables

ATOL = 1e-4


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, the Pallas module, the JAX layer_norm)."""
    import jax.numpy as jnp

    from gigaam_tpu.ops import pallas_attention
    from gigaam_tpu.ops.conformer_ops import layer_norm

    return jnp, pallas_attention, layer_norm


def t(a):
    return torch.from_numpy(np.array(a))


def make_case(rng, b, tt, dm, h):
    """Half-unit activations, weights at 1/sqrt(dm), a ragged valid mask."""
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    ws = 1.0 / np.sqrt(dm)
    params = {name: {"w": f32(dm, dm) * ws, "b": f32(dm) * ws}
              for name in ("linear_q", "linear_k", "linear_v", "linear_out")}
    ln = {"scale": 1.0 + 0.1 * f32(dm), "bias": 0.1 * f32(dm)}
    x = f32(b, tt, dm) * 0.5
    cos, sin = rotary_tables(tt, dm // h, 5000.0)
    valid = np.ones((b, tt), bool)
    valid[1, tt * 2 // 3:] = False
    valid[-1, 10:] = False
    return params, ln, x, cos, sin, valid


def pallas_args(jx, params, cos, sin, h):
    """The fold's argument prep, as ``tests/test_pallas_attention.py``."""
    jnp, pa, _ = jx
    dm = params["linear_q"]["w"].shape[0]
    dh = dm // h
    scale = 1.0 / np.sqrt(dh)
    return (jnp.tile(cos, (1, h)), jnp.tile(sin, (1, h)),
            jnp.asarray(pa._rope_perm_matrix(h, dh)),
            params["linear_q"]["w"] * scale, params["linear_k"]["w"],
            params["linear_v"]["w"], params["linear_out"]["w"],
            (params["linear_q"]["b"] * scale)[None, :],
            params["linear_k"]["b"][None, :],
            params["linear_v"]["b"][None, :],
            params["linear_out"]["b"][None, :])


def port_weights(params, ln, h, dtype=torch.float32):
    to_t = lambda tree: {k: t(v) for k, v in tree.items()}
    return fa.prepare_folded_weights({k: to_t(v) for k, v in params.items()},
                                     to_t(ln), h, dtype)


def assert_valid_rows_close(got, ref, valid, atol=ATOL, rtol=0.0):
    for b, n in enumerate(valid.sum(1)):
        np.testing.assert_allclose(got[b, ..., :n, :] if got.ndim == 4
                                   else got[b, :n],
                                   ref[b, ..., :n, :] if ref.ndim == 4
                                   else ref[b, :n],
                                   atol=atol, rtol=rtol, err_msg=f"row {b}")


@pytest.mark.parametrize("tt,dh", [(96, 48), (130, 16)])
def test_k3_plain_matches_pallas(jx, tt, dh):
    jnp, pa, _ = jx
    rng = np.random.default_rng(0)
    b, h = 3, 4
    q, k, v = (rng.standard_normal((b, h, tt, dh)).astype(np.float32)
               for _ in range(3))
    valid = np.ones((b, tt), bool)
    valid[1, tt // 2:] = False
    valid[2, 5:] = False
    ref = np.asarray(pa.fused_mha(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(valid),
                                  interpret=True))
    got = fa.fused_mha(t(q), t(k), t(v), t(valid)).numpy()
    assert_valid_rows_close(got, ref, valid)


@pytest.mark.parametrize("dm,h", [(64, 4), (192, 4)])
@pytest.mark.parametrize("nb", [1, 2, 4])
def test_k2_plain_matches_pallas(jx, dm, h, nb):
    jnp, pa, _ = jx
    rng = np.random.default_rng(1)
    params, ln, x, cos, sin, valid = make_case(rng, 4, 96, dm, h)
    ref = np.asarray(pa._folded_rotary_pallas(
        jnp.asarray(x), *pallas_args(jx, params, cos, sin, h), jnp.asarray(valid),
        nb, h, interpret=True))
    got = fa.folded_rotary_attention(port_weights(params, ln, h), t(x),
                                     t(cos), t(sin), t(valid), h).numpy()
    assert_valid_rows_close(got, ref, valid)


@pytest.mark.parametrize("dm,h", [(64, 4), (192, 4)])
@pytest.mark.parametrize("nb", [1, 2, 4])
def test_k1_plain_matches_pallas(jx, dm, h, nb):
    jnp, pa, _ = jx
    rng = np.random.default_rng(2)
    params, ln, x, cos, sin, valid = make_case(rng, 4, 96, dm, h)
    ref = np.asarray(pa._folded_lnres_pallas(
        jnp.asarray(x), ln["scale"][None, :], ln["bias"][None, :],
        *pallas_args(jx, params, cos, sin, h), jnp.asarray(valid), nb, h,
        interpret=True))
    got = fa.folded_rotary_attention_lnres(
        port_weights(params, ln, h), t(x), t(cos), t(sin), t(valid),
        h).numpy()
    assert_valid_rows_close(got, ref, valid)


def test_k1_plain_is_residual_plus_k2_of_layer_norm(jx):
    """K1 = x + K2(LN(x)) (the identity the encoder dispatch relies on)."""
    jnp, _, jax_layer_norm = jx
    rng = np.random.default_rng(3)
    params, ln, x, cos, sin, valid = make_case(rng, 2, 40, 64, 4)
    w = port_weights(params, ln, 4)
    xn = t(np.asarray(jax_layer_norm(ln, jnp.asarray(x))))
    k2 = fa.folded_rotary_attention(w, xn, t(cos), t(sin), t(valid), 4)
    k1 = fa.folded_rotary_attention_lnres(w, t(x), t(cos), t(sin), t(valid), 4)
    assert_valid_rows_close(k1.numpy(), (t(x) + k2).numpy(), valid)


@pytest.mark.parametrize("lnres", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_pass_plain_matches_jax(jx, lnres, dtype):
    """The row pass of K1/K2 (``ln_rope_plain``) against the Pallas body's
    math: the JAX ``layer_norm`` (K1 only), then ``xn * cos + (xn @
    _rope_perm_matrix) * sin`` in fp32, rounded to the compute dtype.  In
    bf16 the LN statistics are summed in another order, so a value may
    round one bf16 step apart; nearly all are equal."""
    jnp, pa, jax_layer_norm = jx
    rng = np.random.default_rng(7)
    params, ln, x, cos, sin, _ = make_peaked_case(rng, 2, 40, dm=192, h=4)
    jdt = getattr(jnp, dtype)
    xj = jnp.asarray(x).astype(jdt)
    xn_j = (jax_layer_norm({k: jnp.asarray(v) for k, v in ln.items()}, xj)
            if lnres else xj)
    xf = xn_j.astype(jnp.float32)
    xrot = jnp.dot(xf, jnp.asarray(pa._rope_perm_matrix(4, 48)))
    xr_j = (xf * jnp.tile(cos, (1, 4)) + xrot * jnp.tile(sin, (1, 4))
            ).astype(jdt)
    xt = t(x).to(getattr(torch, dtype))
    ln_args = (t(ln["scale"]), t(ln["bias"])) if lnres else ()
    xn, xr = fa.ln_rope_plain(xt, t(cos), t(sin), 4, *ln_args)
    assert xn.dtype == xr.dtype == xt.dtype
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    for got, ref in ((xn, xn_j), (xr, xr_j)):
        got = got.float().numpy()
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-5)
        if dtype == "bfloat16":
            assert np.mean(got == ref) >= 0.99


def test_prepared_weights_follow_the_fold():
    """wq/bq scaled by 1/sqrt(d_h) in fp32 before the cast; biases and LN
    parameters stay fp32."""
    rng = np.random.default_rng(4)
    params, ln, *_ = make_case(rng, 2, 8, 192, 4)
    w = port_weights(params, ln, 4, dtype=torch.bfloat16)
    scale = 1.0 / math.sqrt(48)
    want = (t(params["linear_q"]["w"]) * scale).to(torch.bfloat16)
    assert torch.equal(w.wq, want)
    assert w.wk.dtype == w.wv.dtype == w.wo.dtype == torch.bfloat16
    for name in ("bq", "bk", "bv", "bo", "ln_scale", "ln_bias"):
        assert getattr(w, name).dtype == torch.float32
    np.testing.assert_allclose(w.bq.numpy(), params["linear_q"]["b"] * scale,
                               rtol=1e-6)


def test_cpu_calls_do_not_count_launches():
    rng = np.random.default_rng(5)
    params, ln, x, cos, sin, valid = make_case(rng, 2, 16, 64, 4)
    before = [fn.launches for fn in fa.KERNELS]
    fa.folded_rotary_attention(port_weights(params, ln, 4), t(x), t(cos),
                               t(sin), t(valid), 4)
    assert [fn.launches for fn in fa.KERNELS] == before


def test_cuda_path_rejects_what_the_kernels_do_not_take():
    """The launch path validates before it touches the card."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((1, 2, 8, 48)).astype(np.float32))
    valid = torch.ones(1, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="bfloat16"):
        fa._check_sdpa_args(q, q, q, valid)
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="shape"):
        fa._check_sdpa_args(qb, qb, qb, torch.ones(1, 9, dtype=torch.bool))
    with pytest.raises(ValueError, match=r"\[B, H, T, 48\]"):
        fa._check_sdpa_args(qb[..., :16], qb[..., :16], qb[..., :16], valid)
    params, ln, x, cos, sin, valid = make_case(rng, 2, 8, 64, 4)
    w = port_weights(params, ln, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="D = 48"):
        fa._folded_cuda(w, t(x).to(torch.bfloat16), t(cos), t(sin), t(valid),
                        4, lnres=False)
    # the GEMMs' column tiles and K steps need D % 128 == 0, the row pass
    # D <= 1024: 576 = 48 * 12 and 1152 = 48 * 24 fail one each
    cos48, sin48 = (t(a) for a in rotary_tables(8, 48, 5000.0))
    for d, h in ((576, 12), (1152, 24)):
        xd = torch.zeros(1, 8, d, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="D % 128 == 0 and D <= 1024"):
            fa._check_row_args(xd, cos48, sin48, h, None, None)
    x768 = torch.zeros(1, 8, 768, dtype=torch.bfloat16)
    scale = torch.ones(768)
    with pytest.raises(ValueError, match="both or neither"):
        fa._check_row_args(x768, cos48, sin48, 16, scale, None)
    with pytest.raises(ValueError, match="ln_bias is torch.bfloat16"):
        fa._check_row_args(x768, cos48, sin48, 16, scale,
                           scale.to(torch.bfloat16))
    with pytest.raises(ValueError, match="cos has shape"):
        fa._check_row_args(x768, cos48[:7], sin48, 16, None, None)


def test_kernel_resources_reads_the_compilers_report():
    """``cuda_lib.kernel_resources`` on ptxas output as ``-Xptxas -v`` prints
    it: a kernel in an unnamed namespace and a template instance."""
    from gigaam_tpu_torch.ops import cuda_lib

    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__baf6e285_12_attention_cu_1bef16dc11sdpa_kernelEPK13__nv_bfloat16S2_S2_PKhPS0_Pfiif' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__baf6e285_12_attention_cu_1bef16dc11sdpa_kernelEPK13__nv_bfloat16S2_S2_PKhPS0_Pfiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 98 registers, used 1 barriers, 31232 bytes smem
ptxas info    : Compile time = 199.085 ms
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__0a1b2c3d_13_projection_cu_4e5f6a7b10qkv_kernelILb1EEEvNS_7QkvArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__0a1b2c3d_13_projection_cu_4e5f6a7b10qkv_kernelILb1EEEvNS_7QkvArgsE
    16 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""
    assert cuda_lib.kernel_resources(log) == {
        "sdpa_kernel": {"registers": 98, "spill_bytes": 0,
                        "static_smem_bytes": 31232},
        "qkv_kernel<true>": {"registers": 128, "spill_bytes": 12,
                             "static_smem_bytes": 0}}


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version, bf16
# ---------------------------------------------------------------------------

# Inputs on which a wrong kernel shows: q/k weights at 1.5 / sqrt(d) make the
# scores' standard deviation about 2.25, so each query weighs a few keys, and
# x has a per-channel mean and a per-row scale, so LayerNorm changes it.  The
# limit on valid rows is a tenth of the RMS of the attention output (K1: of
# its output less x) plus one bf16 rounding of the value, as chip_smoke.py
# holds the kernels.
GPU_REL, GPU_RTOL, QK_GAIN = 0.1, 2.0 ** -7, 1.5


def make_peaked_case(rng, b, tt, dm=768, h=16):
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    gains = {"linear_q": QK_GAIN, "linear_k": QK_GAIN, "linear_v": 1.0,
             "linear_out": 1.0}
    params = {name: {"w": f32(dm, dm) * (g / np.sqrt(dm)), "b": 0.1 * f32(dm)}
              for name, g in gains.items()}
    ln = {"scale": 1.0 + 0.1 * f32(dm), "bias": 0.1 * f32(dm)}
    x = (0.5 * f32(dm) + rng.uniform(0.5, 2.0, (b, tt, 1)) * f32(b, tt, dm)
         ).astype(np.float32)
    cos, sin = rotary_tables(tt, dm // h, 5000.0)
    return params, ln, x, cos, sin, ragged_valid(b, tt)


def ragged_valid(b, tt):
    lens = np.array([tt - 7 - (i * tt) // (2 * b) for i in range(b)])
    return np.arange(tt)[None, :] < lens[:, None]


def assert_within_output_scale(got, ref, valid, residual=None):
    """got/ref [B, T, D] or [B, H, T, d], float numpy; valid [B, T]."""
    rows = np.moveaxis(got, -2, 1)[valid], np.moveaxis(ref, -2, 1)[valid]
    attn = rows[1] if residual is None else rows[1] - residual[valid]
    rms = np.sqrt(np.mean(attn ** 2))
    np.testing.assert_array_less(
        np.abs(rows[0] - rows[1]), GPU_REL * rms + GPU_RTOL * np.abs(rows[1])
        + 1e-30)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest -m gpu tests/test_torch_kernels.py)")
    return torch.device("cuda")


def nearly_masked_valid(b, tt):
    """Ragged lengths; the last of several batch elements keeps 3 frames."""
    valid = ragged_valid(b, tt)
    if b > 1:
        valid[-1, 3:] = False
    return valid


# T' below, at, and just past one 64-row tile, the training shape, and the
# long clip; several T' are no multiple of 64 or of 8
K3_K4_SHAPES = [(3, 37), (3, 64), (3, 130), (1, 500), (16, 500), (2, 1125)]
# lse is fp32 on both sides, from the same bf16 inputs: the products
# accumulate in another order and the kernel uses exp2/log2 approximations
# (relative 2^-22), so 1e-3 on values of 4 to 12 is wide
LSE_ATOL = 1e-3
# K5's scores hold a bias rounded to bf16 from an fp32 product that the
# kernel sums in another order than the plain version: where the two round
# apart, one score moves by a bf16 step of the bias (``relpos_bias_step``),
# and the row's lse by that times the key's probability.  So every row is
# held to LSE_ATOL plus one such step, and all but a thousandth of the rows
# (those where a key that carries weight was rounded apart) to LSE_ATOL
RELPOS_LSE_SHARE = 0.999


def relpos_bias_step(q_v, p_heads):
    """The bf16 spacing at the largest positional term, in the scaled
    scores' units."""
    largest = float(fa._relpos_bias(q_v, p_heads).abs().max())
    return largest * 2.0 ** -7 / math.sqrt(48)


@pytest.mark.gpu
@pytest.mark.parametrize("b,tt", K3_K4_SHAPES)
def test_cuda_k3_matches_plain(cuda, b, tt):
    rng = np.random.default_rng(b * tt)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, 16, tt, 48))
                                .astype(np.float32) * g)
               .to(cuda, torch.bfloat16) for g in (QK_GAIN, QK_GAIN, 1.0))
    valid = nearly_masked_valid(b, tt)
    valid_d = t(valid).to(cuda)
    before = fa.fused_mha.launches
    got = fa.fused_mha(q, k, v, valid_d)
    assert fa.fused_mha.launches == before + 1
    ref, lse_ref = fa.mha_plain(q, k, v, valid_d, return_lse=True)
    assert_within_output_scale(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), valid)
    # the same launch with the log-sum-exp asked for: the same output bits,
    # and lse on every row below T (a padded query row has one too)
    out, lse = fa._mha_forward(q, k, v, valid_d, want_lse=True)
    assert torch.equal(out, got)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, 16, tt)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(),
                               atol=LSE_ATOL, rtol=0)
    # repeated runs give the same bits (a tile read before its copy landed
    # would not)
    for _ in range(3):
        again, lse2 = fa._mha_forward(q, k, v, valid_d, want_lse=True)
        assert torch.equal(again, got) and torch.equal(lse2, lse)


# The edges of the projection GEMMs' tiling: 64-row tiles (T' 64, 65 and
# 77; one 64-row tile at B 1, T' 40, where M is below one tile), 128-row
# tiles (B 16 and 32 at T' 500), T' 1024 (the longest fold) and batch 1
FOLD_SHAPES = [(1, 500), (16, 500), (3, 77), (3, 64), (3, 65), (2, 1024),
               (32, 500), (1, 40)]


def cuda_fold_case(cuda, b, tt):
    rng = np.random.default_rng(b * tt)
    params, ln, x, cos, sin, valid = make_peaked_case(rng, b, tt)
    w = fa.prepare_folded_weights(
        {n: {k: t(a).to(cuda) for k, a in p.items()}
         for n, p in params.items()},
        {k: t(a).to(cuda) for k, a in ln.items()}, 16, torch.bfloat16)
    xb = t(x).to(cuda, torch.bfloat16)
    return w, ln, xb, t(cos).to(cuda), t(sin).to(cuda), valid


@pytest.mark.gpu
@pytest.mark.parametrize("lnres", [False, True])
@pytest.mark.parametrize("b,tt", FOLD_SHAPES)
def test_cuda_folds_match_plain(cuda, lnres, b, tt):
    w, _, xb, cos, sin, valid = cuda_fold_case(cuda, b, tt)
    args = (xb, cos, sin, t(valid).to(cuda), 16)
    kernel, plain = ((fa.folded_rotary_attention_lnres,
                      fa.folded_rotary_attention_lnres_plain) if lnres else
                     (fa.folded_rotary_attention,
                      fa.folded_rotary_attention_plain))
    before = kernel.launches
    got = kernel(w, *args)
    assert kernel.launches == before + 1
    ref = plain(w, *args)
    assert_within_output_scale(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), valid,
                               xb.float().cpu().numpy() if lnres else None)
    # repeated runs give the same bits (a tile read before its copy landed
    # would not)
    for _ in range(3):
        assert torch.equal(kernel(w, *args), got)


@pytest.mark.gpu
@pytest.mark.parametrize("lnres", [False, True])
@pytest.mark.parametrize("b,tt", [(1, 40), (3, 77), (16, 500)])
def test_cuda_row_pass_matches_plain(cuda, lnres, b, tt):
    """The row pass against ``ln_rope_plain``: xn within one bf16 step (the
    LN statistics are summed in another order) and equal nearly everywhere;
    given the kernel's own xn, the same bits of xr (both round each product
    and sum once, as PyTorch's elementwise ops do)."""
    _, ln, xb, cos, sin, _ = cuda_fold_case(cuda, b, tt)
    ln_args = (tuple(t(ln[k]).to(cuda) for k in ("scale", "bias"))
               if lnres else ())
    xn, xr = fa.ln_rope(xb, cos, sin, 16, *ln_args)
    ref_xn, _ = fa.ln_rope_plain(xb, cos, sin, 16, *ln_args)
    if lnres:
        got, ref = xn.float().cpu().numpy(), ref_xn.float().cpu().numpy()
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=1e-6)
        assert np.mean(got == ref) >= 0.999
    else:
        assert xn is xb
    _, ref_xr = fa.ln_rope_plain(xn, cos, sin, 16)
    assert torch.equal(xr, ref_xr)


# T' of one tile (64), one row into the second (65) and into the third (129):
# the first and last tiles' windows reach below row 0 and past row 2T-2 of
# the position table
RELPOS_EDGE_SHAPES = [(3, 64), (3, 65), (2, 129)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,tt", [(1, 501), (16, 501), (1, 1126), (3, 77)]
                         + RELPOS_EDGE_SHAPES)
def test_cuda_k5_matches_plain(cuda, b, tt):
    """K5 on inputs where both score terms matter: q_u, k, q_v and the
    position table at QK_GAIN, so q_u.k and the positional term are of one
    size and the softmax is peaked; q_u and q_v drawn apart."""
    rng = np.random.default_rng(b * tt + 1)

    def draw(shape, gain):
        a = rng.standard_normal(shape).astype(np.float32) * gain
        return torch.from_numpy(a).to(cuda, torch.bfloat16)

    q_u, k, q_v = (draw((b, 16, tt, 48), QK_GAIN) for _ in range(3))
    v = draw((b, 16, tt, 48), 1.0)
    p_heads = draw((16, 2 * tt - 1, 48), QK_GAIN)
    valid = ragged_valid(b, tt)
    valid_d = t(valid).to(cuda)
    before = fa.fused_relpos_mha.launches
    got = fa.fused_relpos_mha(q_u, k, v, q_v, p_heads, valid_d)
    assert fa.fused_relpos_mha.launches == before + 1
    ref, lse_ref = fa.relpos_mha_plain(q_u, k, v, q_v, p_heads, valid_d,
                                       return_lse=True)
    assert_within_output_scale(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), valid)
    # the same launch with the log-sum-exp asked for: the same output bits,
    # and lse on every row below T
    args = (q_u, k, v, q_v, p_heads, valid_d)
    out, lse = fa._relpos_forward(*args, want_lse=True)
    assert torch.equal(out, got)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, 16, tt)
    lse_err = (lse - lse_ref).abs()
    step = relpos_bias_step(q_v, p_heads)
    assert float(lse_err.max()) <= LSE_ATOL + step
    assert float((lse_err <= LSE_ATOL).float().mean()) >= RELPOS_LSE_SHARE
    for _ in range(3):
        again, lse2 = fa._relpos_forward(*args, want_lse=True)
        assert torch.equal(again, got) and torch.equal(lse2, lse)


# The backward kernels (K4, K6) against their plain versions, per gradient:
# the same limit, with the RMS that of the plain gradient on its valid rows
# (query rows for dq, dq_u and dq_v; key rows for dk and dv; every row of dp).
# ``do`` is zero on padded query rows, as in a train step.

def draw_bwd_case(rng, b, tt, cuda, relpos):
    def draw(shape, gain):
        a = rng.standard_normal(shape).astype(np.float32) * gain
        return torch.from_numpy(a).to(cuda, torch.bfloat16)

    shape = (b, 16, tt, 48)
    valid = ragged_valid(b, tt) if relpos else nearly_masked_valid(b, tt)
    valid_d = t(valid).to(cuda)
    q, k = draw(shape, QK_GAIN), draw(shape, QK_GAIN)
    v = draw(shape, 1.0)
    do = draw(shape, 1.0) * valid_d[:, None, :, None]
    if not relpos:
        return (q, k, v, do, valid_d), valid
    q_v = draw(shape, QK_GAIN)
    p_heads = draw((16, 2 * tt - 1, 48), QK_GAIN)
    return (q, k, v, q_v, p_heads, do, valid_d), valid


def assert_grads_within_scale(names, got, ref, valid):
    for name, g, r in zip(names, got, ref):
        g, r = g.float().cpu().numpy(), r.float().cpu().numpy()
        if name == "dp":
            g, r = g[None], r[None]
            rows = np.ones((1, g.shape[2]), bool)
        else:
            rows = valid
        try:
            assert_within_output_scale(g, r, rows)
        except AssertionError as exc:
            raise AssertionError(f"{name}: {exc}") from None


@pytest.mark.gpu
@pytest.mark.parametrize("saved_pair", [True, False])
@pytest.mark.parametrize("b,tt", K3_K4_SHAPES + [(8, 750), (2, 1000)])
def test_cuda_k4_matches_plain(cuda, b, tt, saved_pair):
    """K4 from the forward kernel's own (out, lse), and without the pair
    (it then runs the forward kernel first), against the plain backward in
    both of its forms."""
    args, valid = draw_bwd_case(np.random.default_rng(b * tt + 2), b, tt,
                                cuda, relpos=False)
    q, k, v, do, valid_d = args
    pair = fa._mha_forward(q, k, v, valid_d, want_lse=True) if saved_pair else ()
    k3_before, before = fa.fused_mha.launches, fa.mha_bwd.launches
    got = fa.mha_bwd(*args, *pair)
    assert fa.mha_bwd.launches == before + 1
    assert fa.fused_mha.launches == k3_before
    names = ("dq", "dk", "dv")
    assert_grads_within_scale(names, got, fa.mha_bwd_plain(*args), valid)
    assert_grads_within_scale(
        names, got, fa.mha_bwd_plain(
            *args, *fa.mha_plain(q, k, v, valid_d, return_lse=True)), valid)
    # no atomics: the same bits every run
    for _ in range(3):
        again = fa.mha_bwd(*args, *pair)
        assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.gpu
@pytest.mark.parametrize("saved_pair", [True, False])
@pytest.mark.parametrize("b,tt", [(16, 501), (8, 750), (2, 1000), (3, 77)]
                         + RELPOS_EDGE_SHAPES)
def test_cuda_k6_matches_plain(cuda, b, tt, saved_pair):
    """K6 from the forward kernel's own (out, lse), and without the pair
    (it then runs the forward kernel first), against the plain backward in
    both of its forms."""
    args, valid = draw_bwd_case(np.random.default_rng(b * tt + 3), b, tt,
                                cuda, relpos=True)
    q_u, k, v, q_v, p_heads, do, valid_d = args
    fwd_args = (q_u, k, v, q_v, p_heads, valid_d)
    pair = fa._relpos_forward(*fwd_args, want_lse=True) if saved_pair else ()
    k5_before, before = fa.fused_relpos_mha.launches, fa.relpos_mha_bwd.launches
    got = fa.relpos_mha_bwd(*args, *pair)
    assert fa.relpos_mha_bwd.launches == before + 1
    assert fa.fused_relpos_mha.launches == k5_before
    names = ("dq_u", "dk", "dv", "dq_v", "dp")
    assert_grads_within_scale(names, got, fa.relpos_mha_bwd_plain(*args),
                              valid)
    assert_grads_within_scale(
        names, got, fa.relpos_mha_bwd_plain(
            *args, *fa.relpos_mha_plain(*fwd_args, return_lse=True)), valid)
    # dp's batch sum uses fp32 atomics; the other four give the same bits
    # every run
    for _ in range(3):
        again = fa.relpos_mha_bwd(*args, *pair)
        assert all(torch.equal(a, g) for a, g in zip(again[:4], got[:4]))


@pytest.mark.gpu
def test_cuda_autograd_reaches_the_backward_kernels(cuda):
    """``fused_mha`` / ``fused_relpos_mha`` on CUDA tensors that require a
    gradient launch K4 / K6 from ``backward``, also for a ``do`` that is not
    contiguous."""
    (q, k, v, do, valid_d), valid = draw_bwd_case(
        np.random.default_rng(7), 2, 130, cuda, relpos=False)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = fa.mha_bwd.launches
    out = fa.fused_mha(*leaves, valid_d)
    strided = do.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    got = torch.autograd.grad(out, leaves, strided)
    assert fa.mha_bwd.launches == before + 1
    assert_grads_within_scale(("dq", "dk", "dv"), got,
                              fa.mha_bwd_plain(q, k, v, do, valid_d), valid)

    (q_u, k, v, q_v, p, do, valid_d), valid = draw_bwd_case(
        np.random.default_rng(8), 2, 130, cuda, relpos=True)
    leaves = [x.clone().requires_grad_() for x in (q_u, k, v, q_v, p)]
    before = fa.relpos_mha_bwd.launches
    out = fa.fused_relpos_mha(*leaves, valid_d)
    got = torch.autograd.grad(out, leaves, do)
    assert fa.relpos_mha_bwd.launches == before + 1
    assert_grads_within_scale(
        ("dq_u", "dk", "dv", "dq_v", "dp"), got,
        fa.relpos_mha_bwd_plain(q_u, k, v, q_v, p, do, valid_d), valid)
