"""The attention-fold probe P8 on its redesign: K1's function with the
residual added to the fp32 accumulator, on P6's stages (K1's row pass with
the LayerNorm, ``csrc/attn_fold_ws.cu``'s Q/K/V product and packed walk,
and the output product with the fp32-residual epilogue of
``csrc/attn_lnres_ws.cu``), driven by
``gigaam_tpu_torch/probes/attn_fold_probes.py``.

On the CPU: the staged plain version (the row pass with the LayerNorm, the
Q/K/V stage with V on xn, the SDPA with o packed, the output stage with the
fp32 residual) equals ``lnres_plain`` bit for bit in bf16 and fp32 at B 1-3
with ragged lengths, T 1, T under 31 and T no multiple of 64; in fp32 it
agrees with the JAX package's ``x + folded_rotary_attention(
layer_norm(x))`` at width 96 (2 heads of 48); the output stage rounds once
(it differs from rounding the module output first); P8's plans are P6's
(``fold_plans``) at each nb, covering every tile once; the wrappers and
stages take their plain versions for CPU tensors and count no launch; the
card path's checks refuse what the kernels do not take; the library's
entry points match their declared signatures.

The tests marked ``gpu`` hold the output stage at each of P8's schedules
and the whole at each nb against the plain versions on the card in bf16
within a tenth of the module term's RMS plus one bf16 rounding of the value
(``chip_smoke.py``'s limit), two calls bit-equal, and the kept kernels
(``lnres_ring``) too; they skip without a card (on the card: ``pytest
--noconftest -m gpu tests/test_torch_lnres_ws.py``).
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from gigaam_tpu_torch.ops import fused_attention as fa
from gigaam_tpu_torch.ops.rotary import rotary_tables
from gigaam_tpu_torch.probes import attn_fold_probes as afp
from gigaam_tpu_torch.probes.ws_plan import WS_BK
from gigaam_tpu_torch.weights import sub_block_from_jax

D, H, DH = afp.D, afp.H, afp.DH
# (B, T): T 1, under 31, no multiple of 64
SHAPES = [(1, 1), (2, 17), (3, 70), (2, 64)]
ROWS = [1, 7, 500, 8000, 98304]


def draw(seed, b, t, d):
    """(ln_p, params, x, valid) at width d: JAX-layout numpy trees, x with a
    per-channel mean and a per-row scale (LayerNorm changes it), every row
    but the first ending early."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = {n: {"w": f32(d, d) * np.float32(g / np.sqrt(d)),
                  "b": 0.1 * f32(d)}
              for n, g in (("linear_q", 1.5), ("linear_k", 1.5),
                           ("linear_v", 1.0), ("linear_out", 1.0))}
    ln_p = {"scale": 1.0 + 0.1 * f32(d), "bias": 0.1 * f32(d)}
    x = (0.5 * f32(d) + rng.uniform(0.5, 2.0, (b, t, 1))
         * f32(b, t, d)).astype(np.float32)
    lens = np.array([t] + [max(1, t - 3 - 5 * i) for i in range(1, b)])
    return ln_p, params, x, np.arange(t)[None, :] < lens[:, None]


def port(tree):
    return afp.tree_to(sub_block_from_jax(tree), "cpu")


def weights(ln_np, params_np, t, dtype):
    cos, sin = rotary_tables(t, DH, afp.ROPE_BASE)
    cos_w, sin_w, r = afp.rope_tables_wide(cos, sin)
    return afp.prepare_fold(port(params_np), torch.from_numpy(cos_w),
                            torch.from_numpy(sin_w),
                            torch.from_numpy(r).to(torch.bfloat16), dtype,
                            ln_params=port(ln_np))


def case(b, t, dtype, seed=0):
    ln_np, params_np, x, valid = draw(seed, b, t, D)
    return (weights(ln_np, params_np, t, dtype),
            torch.from_numpy(x).to(dtype), torch.from_numpy(valid))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t", SHAPES)
def test_staged_plain_equals_the_lnres_plain_bit_for_bit(b, t, dtype):
    w, x, valid = case(b, t, dtype, seed=b * 100 + t)
    got = afp.lnres_staged_plain(w, x, valid)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, afp.lnres_plain(w, x, valid))


@pytest.fixture
def narrow(monkeypatch):
    """The probe module at width 96: 2 heads of 48."""
    for name, value in (("D", 96), ("H", 2), ("DH", 48)):
        monkeypatch.setattr(afp, name, value)


def test_staged_plain_matches_the_jax_module_fp32(narrow):
    """``x + folded_rotary_attention(layer_norm(x))`` of the JAX package
    (its K2 in interpret mode), fp32, on the valid rows, within 1e-5 of the
    largest value."""
    import jax.numpy as jnp
    from gigaam_tpu.ops import conformer_ops as jops
    from gigaam_tpu.ops import pallas_attention as jpa

    b, t = 3, 29
    ln_np, params_np, x, valid = draw(7, b, t, 96)
    cos, sin = rotary_tables(t, 48, afp.ROPE_BASE)
    jt = lambda tree: {k: jt(v) if isinstance(v, dict) else jnp.asarray(v)
                       for k, v in tree.items()}
    xj = jnp.asarray(x)
    ref = np.asarray(xj + jpa.folded_rotary_attention(
        jt(params_np), jops.layer_norm(jt(ln_np), xj), jnp.asarray(cos),
        jnp.asarray(sin), jnp.asarray(valid), 2, interpret=True))
    w = weights(ln_np, params_np, t, torch.float32)
    got = afp.lnres_staged_plain(w, torch.from_numpy(x),
                                 torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got[valid], ref[valid], rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_the_output_stage_rounds_once():
    """bf16(o Wo + bo + x) against bf16(bf16(o Wo + bo) + x) (K1's order):
    within one bf16 step of the larger of the outputs and the module term,
    and not everywhere the same."""
    w, x, valid = case(2, 40, torch.bfloat16, seed=3)
    gen = torch.Generator().manual_seed(4)
    o = torch.randn(2, 40, D, generator=gen).to(torch.bfloat16)
    once = afp.out_residual_plain(w, o, x).float()
    term = afp.out_plain(w, o)
    twice = (term + x).float()
    larger = torch.maximum(torch.maximum(once.abs(), twice.abs()),
                           term.float().abs())
    step = 2.0 ** (torch.floor(torch.log2(larger)) - 7)
    assert bool(((once - twice).abs() <= step).all())
    assert not torch.equal(once, twice)


@pytest.mark.parametrize("m", ROWS)
def test_p8_plans_are_p6s_and_cover_every_tile_once(m):
    for nb in afp.NB_TILES:
        schedule = afp.NB_SCHEDULE[nb]
        assert schedule in afp.LNRES_SCHEDULES
        bm, bn, cluster = afp.SCHEDULE_TILES[schedule]
        row_tiles = -(-m // bm)
        units, grid = afp.fold_plans(m, schedule, 132)[1]
        counts = np.zeros((row_tiles + 1, D // bn), dtype=np.int64)
        for r, c, first, count in units:
            assert first == 0 and count == D // WS_BK
            counts[min(r, row_tiles), c] += 1
        assert (counts[:row_tiles] == 1).all()
        assert (counts[row_tiles] == -row_tiles % cluster).all()
        assert grid % cluster == 0
    assert afp.HEAD_TILES not in afp.LNRES_SCHEDULES


def test_cpu_wrappers_and_stages_take_the_plain_versions():
    b, t = 2, 9
    w, x, valid = case(b, t, torch.bfloat16, seed=5)
    afp.reset_launch_counts()
    ref = afp.lnres_plain(w, x, valid)
    for nb in afp.NB_TILES:
        assert torch.equal(afp.fold_lnres(w, x, valid, nb), ref)
    o = torch.zeros(b, t, D, dtype=x.dtype)
    assert torch.equal(afp.out_residual_ws(w, o, x, afp.COOP),
                       afp.out_residual_plain(w, o, x))
    assert afp.fold_lnres.launches == 0


def full_width_weights(t=16):
    """Zero weights of the kernels' width, as the card path takes them."""
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)
    fold = fa.FoldedWeights(*(z(D, D, dt=torch.bfloat16) for _ in range(4)),
                            *(z(D) for _ in range(6)))
    return afp.AttnFoldWeights(fold, z(t, DH), z(t, DH))


def test_card_path_checks_refuse_what_the_kernels_do_not_take():
    w = full_width_weights()
    x = torch.zeros(2, 16, D, dtype=torch.bfloat16)
    valid = torch.ones(2, 16, dtype=torch.bool)
    o = torch.zeros_like(x)
    for schedule in (afp.HEAD_TILES, 7):
        with pytest.raises(ValueError, match="P8's schedule must be one of"):
            afp.out_residual_ws(w, o.to("meta"), x, schedule)
    with pytest.raises(ValueError, match="ln_scale and ln_bias come"):
        afp._check_args(afp.AttnFoldWeights(
            dataclasses.replace(w.fold, ln_scale=None), w.cos, w.sin), x,
            valid, 2, False, True)
    with pytest.raises(ValueError, match="got nb 3"):
        afp._check_args(w, x, valid, 3, False, True)
    with pytest.raises(ValueError, match="runs on the card only"):
        afp.lnres_ring(w, x, valid, 2)


def test_the_output_library_is_registered_for_its_launches():
    """The entry points are in P8's source with the argument counts that
    ``cuda_lib`` declares; its kernels are the ones ``dynamic_resources``
    names; P6/P7's source holds no P8 kernel."""
    from gigaam_tpu_torch.ops import cuda_lib

    with open(os.path.join(cuda_lib.CSRC_DIR, "attn_lnres_ws.cu")) as f:
        text = f.read()
    for fn, argtypes in cuda_lib.SIGNATURES["attn_lnres_ws"].items():
        m = re.search(rf"int {fn}\(([^)]*)\)", text)
        assert m, fn
        assert len(m.group(1).split(",")) == len(argtypes), fn
    for kernel in cuda_lib.ATTN_LNRES_WS_KERNELS:
        assert kernel in text, kernel
    assert len(cuda_lib.ATTN_LNRES_WS_KERNELS) == len(afp.LNRES_SCHEDULES)
    with open(os.path.join(cuda_lib.CSRC_DIR, "attn_fold_ws.cu")) as f:
        assert "lnres_out" not in f.read()


# ---------------------------------------------------------------------------
# On the card: the output stage and the whole against the plain versions
# ---------------------------------------------------------------------------

GPU_REL, GPU_RTOL = 0.1, 2.0 ** -7
CARD_SHAPES = [(1, 1), (2, 17), (4, 77), (8, 500)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest "
                    "--noconftest -m gpu tests/test_torch_lnres_ws.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_case(b, t, dev):
    w, x, valid = case(b, t, torch.bfloat16, seed=b * 10 + t)
    fold = dataclasses.replace(w.fold, **{
        f.name: getattr(w.fold, f.name).to(dev)
        for f in dataclasses.fields(w.fold)})
    return (afp.AttnFoldWeights(fold, w.cos.to(dev), w.sin.to(dev)),
            x.to(dev), valid.to(dev))


def assert_close(got, ref, x, valid):
    got, ref, x = got.float()[valid], ref.float()[valid], x.float()[valid]
    rms = float((ref - x).pow(2).mean().sqrt())
    err = (got - ref).abs()
    assert float((err - GPU_RTOL * ref.abs()).max()) <= GPU_REL * rms


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", afp.LNRES_SCHEDULES)
@pytest.mark.parametrize("b,t", CARD_SHAPES)
def test_cuda_output_stage_matches_plain(cuda, b, t, schedule):
    w, x, valid = card_case(b, t, cuda)
    gen = torch.Generator(device=cuda).manual_seed(b + t)
    o = torch.randn(b, t, D, generator=gen, device=cuda).to(torch.bfloat16)
    got = afp.out_residual_ws(w, o, x, schedule)
    assert_close(got, afp.out_residual_plain(w, o, x), x,
                 torch.ones_like(valid))
    assert torch.equal(afp.out_residual_ws(w, o, x, schedule), got)


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [1, 2, 4])
@pytest.mark.parametrize("b,t", [(4, 77), (8, 500), (4, 64)])
def test_cuda_fold_lnres_runs_the_redesign(cuda, b, t, nb):
    w, x, valid = card_case(b, t, cuda)
    before = afp.fold_lnres.launches
    got = afp.fold_lnres(w, x, valid, nb)
    assert afp.fold_lnres.launches == before + 1
    ref = afp.lnres_plain(w, x, valid)
    assert_close(got, ref, x, valid)
    assert torch.equal(afp.fold_lnres(w, x, valid, nb), got)
    ring = afp.lnres_ring(w, x, valid, nb)
    assert afp.fold_lnres.launches == before + 2
    assert_close(ring, ref, x, valid)
