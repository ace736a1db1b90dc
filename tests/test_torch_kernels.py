"""The port's attention kernels (K3 ``fused_mha``, K2
``folded_rotary_attention``, K1 ``folded_rotary_attention_lnres``; K5
``fused_relpos_mha`` has its CPU tests in ``test_torch_relpos.py``).

On the CPU each wrapper runs its plain version, which is held against the
JAX package's Pallas kernel in interpret mode on valid rows, in fp32
(atol 1e-4: the same math summed in another order).  The tests marked
``gpu`` hold the CUDA kernels against their plain versions on the card in
bf16; they skip without one.  The JAX package is imported inside the CPU
tests only, so that the card's host, which has no JAX, runs the ``gpu``
tests with ``pytest --noconftest -m gpu tests/test_torch_kernels.py``.
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


@pytest.mark.gpu
@pytest.mark.parametrize("b,tt", [(1, 500), (16, 500), (2, 1125)])
def test_cuda_k3_matches_plain(cuda, b, tt):
    rng = np.random.default_rng(b * tt)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, 16, tt, 48))
                                .astype(np.float32) * g)
               .to(cuda, torch.bfloat16) for g in (QK_GAIN, QK_GAIN, 1.0))
    valid = ragged_valid(b, tt)
    valid_d = t(valid).to(cuda)
    before = fa.fused_mha.launches
    got = fa.fused_mha(q, k, v, valid_d)
    assert fa.fused_mha.launches == before + 1
    ref = fa.mha_plain(q, k, v, valid_d)
    assert_within_output_scale(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), valid)


@pytest.mark.gpu
@pytest.mark.parametrize("lnres", [False, True])
@pytest.mark.parametrize("b,tt", [(1, 500), (16, 500), (3, 77)])
def test_cuda_folds_match_plain(cuda, lnres, b, tt):
    rng = np.random.default_rng(b * tt)
    params, ln, x, cos, sin, valid = make_peaked_case(rng, b, tt)
    w = fa.prepare_folded_weights(
        {n: {k: t(a).to(cuda) for k, a in p.items()}
         for n, p in params.items()},
        {k: t(a).to(cuda) for k, a in ln.items()}, 16, torch.bfloat16)
    xb = t(x).to(cuda, torch.bfloat16)
    args = (xb, t(cos).to(cuda), t(sin).to(cuda), t(valid).to(cuda), 16)
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


@pytest.mark.gpu
@pytest.mark.parametrize("b,tt", [(1, 501), (16, 501), (1, 1126), (3, 77)])
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
    ref = fa.relpos_mha_plain(q_u, k, v, q_v, p_heads, valid_d)
    assert_within_output_scale(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), valid)


# The backward kernels (K4, K6) against their plain versions, per gradient:
# the same limit, with the RMS that of the plain gradient on its valid rows
# (query rows for dq, dq_u and dq_v; key rows for dk and dv; every row of dp).
# ``do`` is zero on padded query rows, as in a train step.

def draw_bwd_case(rng, b, tt, cuda, relpos):
    def draw(shape, gain):
        a = rng.standard_normal(shape).astype(np.float32) * gain
        return torch.from_numpy(a).to(cuda, torch.bfloat16)

    shape = (b, 16, tt, 48)
    valid = ragged_valid(b, tt)
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
@pytest.mark.parametrize("b,tt", [(16, 500), (8, 750), (2, 1000), (3, 77)])
def test_cuda_k4_matches_plain(cuda, b, tt):
    args, valid = draw_bwd_case(np.random.default_rng(b * tt + 2), b, tt,
                                cuda, relpos=False)
    before = fa.mha_bwd.launches
    got = fa.mha_bwd(*args)
    assert fa.mha_bwd.launches == before + 1
    assert_grads_within_scale(("dq", "dk", "dv"), got,
                              fa.mha_bwd_plain(*args), valid)


@pytest.mark.gpu
@pytest.mark.parametrize("b,tt", [(16, 501), (8, 750), (2, 1000), (3, 77)])
def test_cuda_k6_matches_plain(cuda, b, tt):
    args, valid = draw_bwd_case(np.random.default_rng(b * tt + 3), b, tt,
                                cuda, relpos=True)
    before = fa.relpos_mha_bwd.launches
    got = fa.relpos_mha_bwd(*args)
    assert fa.relpos_mha_bwd.launches == before + 1
    assert_grads_within_scale(("dq_u", "dk", "dv", "dq_v", "dp"), got,
                              fa.relpos_mha_bwd_plain(*args), valid)


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
