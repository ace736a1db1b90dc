"""The attention-fold probes (P6, P7, P8:
``gigaam_tpu_torch/probes/attn_fold_probes.py``).

On the CPU each kernel wrapper runs its plain version, which is held
against the Pallas bodies of the scripts it replaces
(``benchmarks/pallas_attn_fold_probe.py``, ``benchmarks/pallas_attn_lnres_
probe.py``, imported from their files), at a small width set on both sides
(the scripts' module constants ``D``, ``H``, ``DH`` and the port's: 96, 2,
48, which keeps the kernels' 48-wide heads), B 2-4, T 24-40 (33 is no
multiple of 8) and nb 1, 2 and 4 where nb divides B.  P6 and P7 run with
the script's ``interpret=True``; P8's function takes no ``interpret``, so
its ``pl.pallas_call`` is patched to build interpret-mode calls (the TPU's
compiler parameters dropped).  Both sides take the same bf16 inputs, with
q/k weights at 1.5 / sqrt(D), so that each query weighs a few keys.

The tolerance is one bf16 step of the output, taken at the larger of
|got|, |ref| and the module term (|ref - x| for P8; P6/P7's output is the
term), plus the step of the softmax's bf16 P.  Both sides round the same
math to bf16 at the same points (LN, xr, q, k, v, P, oh / denom, the
output), but their fp32 sums run in other orders and their exponentials
differ in the last bit.  So a rounding may land on the other neighbour of a
value.  For the output that is one step.  For q, k, v or oh a flipped
rounding moves the next product by 2^-8 of one of its terms, far below a
step of its sum.  A probability is different: with peaked scores one P
entry carries most of a row, so a flipped P (one step, at most 2^-7 of its
value) moves oh by up to 2^-7 P v, and the output by that through |Wo|.
``p_step`` bounds it by the largest such move over the row's heads and
keys.  The one-step part is taken at no less than 2^-16 x the output's RMS,
where fp32's own rounding of the sums would exceed the step of a value that
cancelled to near zero.

Each plain version in fp32 is also held against the JAX baseline its
script times, on valid rows, within 1e-5 of the output's largest value:
P6/P7 against ``gigaam_tpu.ops.attention.rotary_mha`` with
``use_fused=False`` (its composed SDPA: no Pallas), P8 against ``x +
gigaam_tpu.ops.pallas_attention.folded_rotary_attention(layer_norm(x))``
with ``interpret=True``, as ``tests/test_pallas_attention.py`` runs it.

P8's plain version differs from K1's (``folded_rotary_attention_lnres_
plain``) only in where the residual is rounded: in bf16 by at most one
step of the larger of the output and the module term, and not at all in
fp32.

The tests marked ``gpu`` hold each CUDA variant against its plain version
on the card in bf16, within a tenth of the module term's RMS plus one bf16
rounding of the value, as ``chip_smoke.py`` holds them; they skip without
one (on the card: ``pytest --noconftest -m gpu
tests/test_torch_attn_fold_probes.py``).
"""

import dataclasses
import functools
import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

from gigaam_tpu_torch.ops import fused_attention as fa
from gigaam_tpu_torch.ops.rotary import rotary_tables
from gigaam_tpu_torch.probes import attn_fold_probes as afp
from gigaam_tpu_torch.weights import sub_block_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, H, DH = 96, 2, 48
QK_GAIN = 1.5
SCRIPTS = {"fold": "pallas_attn_fold_probe", "lnres": "pallas_attn_lnres_probe"}


def load_script(name):
    path = os.path.join(REPO, "benchmarks", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{name}_script", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    """Both scripts, imported from their files, at the test width; P8's
    with ``pl.pallas_call`` building interpret-mode calls."""
    from jax.experimental import pallas as pl

    def interpret_call(*args, compiler_params=None, **kwargs):
        return pl.pallas_call(*args, interpret=True, **kwargs)

    mods = {key: load_script(name) for key, name in SCRIPTS.items()}
    for mod in mods.values():
        mod.D, mod.H, mod.DH = D, H, DH
    mods["lnres"].pl = types.SimpleNamespace(pallas_call=interpret_call,
                                             BlockSpec=pl.BlockSpec)
    return mods


@pytest.fixture
def width(monkeypatch):
    """The port's probe module at the test width."""
    for name, value in (("D", D), ("H", H), ("DH", DH)):
        monkeypatch.setattr(afp, name, value)


def bf16_values(a):
    """float32 numpy values that bf16 represents."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def draw_case(seed, b, t):
    """(ln_p, params, x, valid) at the test width: JAX-layout numpy trees,
    q/k weights at QK_GAIN / sqrt(D); x [B, T, D] bf16 values with a
    per-channel mean and a per-row scale, so that LayerNorm changes it;
    every row but the first ends early."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    gains = {"linear_q": QK_GAIN, "linear_k": QK_GAIN, "linear_v": 1.0,
             "linear_out": 1.0}
    params = {n: {"w": f32(D, D) * np.float32(g / np.sqrt(D)),
                  "b": 0.1 * f32(D)} for n, g in gains.items()}
    ln_p = {"scale": 1.0 + 0.1 * f32(D), "bias": 0.1 * f32(D)}
    x = bf16_values(0.5 * f32(D) + rng.uniform(0.5, 2.0, (b, t, 1))
                    * f32(b, t, D))
    lens = np.array([t] + [t - 5 - 3 * i for i in range(1, b)])
    return ln_p, params, x, np.arange(t)[None, :] < lens[:, None]


def tables(t):
    """(cos, sin) [T, 48] and the scripts' (cos_w, sin_w, r), numpy."""
    cos, sin = rotary_tables(t, DH, 5000.0)
    return (cos, sin) + afp.rope_tables_wide(cos, sin)


def port_tree(tree):
    return {k: port_tree(v) if isinstance(v, dict) else v
            for k, v in sub_block_from_jax(tree).items()}


def jax_tree(tree):
    import jax.numpy as jnp
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def torch_tables(cos_w, sin_w, r):
    return (torch.from_numpy(cos_w), torch.from_numpy(sin_w),
            torch.from_numpy(r).to(torch.bfloat16))


def one_step(got, ref, term):
    """One bf16 step at the larger of |got|, |ref| and |term|, and no less
    than 2^-16 x RMS(ref)."""
    rms = np.sqrt(np.mean(ref ** 2))
    larger = np.maximum.reduce([np.abs(got), np.abs(ref), np.abs(term),
                                np.full(ref.shape, 2.0 ** -16 * rms)])
    return 2.0 ** (np.floor(np.log2(larger)) - 7)


def p_step(w, x, valid, lnres):
    """[B, T, D]: the largest move of an output element that one flipped
    bf16 rounding of a probability makes, 2^-7 P[h, i, j] |v[h, j]| . |Wo_h|,
    over heads h and keys j, from the plain version's own P and v."""
    xt = torch.from_numpy(x).to(torch.bfloat16)
    f = w.fold
    ln = (f.ln_scale, f.ln_bias) if lnres else ()
    xn, xr = fa.ln_rope_plain(xt, w.cos, w.sin, H, *ln)
    proj = lambda a, wm, bias: fa._split_heads(
        (a.float() @ wm.float() + bias).to(torch.bfloat16), H).float()
    q, k, v = proj(xr, f.wq, f.bq), proj(xr, f.wk, f.bk), proj(xn, f.wv, f.bv)
    s = q @ k.transpose(-1, -2) + fa._key_mask(torch.from_numpy(valid), q)
    prob = torch.softmax(s, dim=-1)                              # [B, H, T, T]
    wo = f.wo.float().abs().reshape(H, DH, D)
    carried = torch.einsum("bhjd,hdc->bhjc", v.abs(), wo)        # [B, H, T, D]
    move = (prob[..., None] * carried[:, :, None]).amax(dim=(1, 3))
    return 2.0 ** -7 * move.numpy()


def assert_within_tolerance(got, ref, x, valid, w, lnres, what):
    term = ref - x if lnres else ref
    tol = one_step(got, ref, term) + p_step(w, x, valid, lnres)
    err = np.abs(got - ref)[valid]
    assert np.all(err <= tol[valid]), \
        f"{what}: {np.max(err / tol[valid])} x the tolerance"


# ---------------------------------------------------------------------------
# The plain versions against the Pallas bodies, bf16
# ---------------------------------------------------------------------------

# (variant, B, T): foldA/foldB are P7, nb<n> P6's rows a cell
FOLD_CASES = [("foldA", 2, 24), ("foldA", 3, 33), ("foldB", 2, 24),
              ("foldB", 3, 33), ("nb1", 3, 33), ("nb2", 4, 40),
              ("nb4", 4, 40), ("nb2", 2, 33)]


@pytest.mark.parametrize("variant,b,t", FOLD_CASES)
def test_fold_plain_matches_pallas_body(scripts, width, variant, b, t):
    import jax.numpy as jnp

    _, params, x, valid = draw_case(seed=b * t, b=b, t=t)
    _, _, cos_w, sin_w, r = tables(t)
    script = scripts["fold"]
    args_j = (jnp.asarray(x, jnp.bfloat16), jax_tree(params),
              jnp.asarray(cos_w), jnp.asarray(sin_w),
              jnp.asarray(r, jnp.bfloat16), jnp.asarray(valid))
    args_t = (torch.from_numpy(x).to(torch.bfloat16), port_tree(params),
              *torch_tables(cos_w, sin_w, r), torch.from_numpy(valid))
    if variant.startswith("nb"):
        nb = int(variant[2:])
        ref = script.folded_attention_nb(*args_j, nb=nb, interpret=True)
        got = afp.folded_attention_nb(*args_t, nb)
        w = afp.prepare_fold(args_t[1], *args_t[2:5], torch.bfloat16)
    else:
        heads = variant == "foldA"
        ref = script.folded_attention(*args_j, per_head_weights=heads,
                                      interpret=True)
        got = afp.folded_attention(*args_t, per_head_weights=heads)
        w = afp.prepare_fold(args_t[1], *args_t[2:5], torch.bfloat16,
                             per_head_weights=heads, divide=True)
    assert got.dtype == torch.bfloat16
    assert_within_tolerance(got.float().numpy(),
                            np.asarray(ref.astype(jnp.float32)), x, valid, w,
                            False, variant)


@pytest.mark.parametrize("nb,b,t", [(1, 2, 24), (2, 4, 40), (4, 4, 33)])
def test_lnres_plain_matches_pallas_body(scripts, width, nb, b, t):
    import jax.numpy as jnp

    ln_p, params, x, valid = draw_case(seed=7 * b * t, b=b, t=t)
    _, _, cos_w, sin_w, r = tables(t)
    ref = scripts["lnres"].lnres_folded(
        jax_tree(ln_p), jax_tree(params), jnp.asarray(x, jnp.bfloat16),
        jnp.asarray(cos_w), jnp.asarray(sin_w), jnp.asarray(r, jnp.bfloat16),
        jnp.asarray(valid), nb)
    tabs = torch_tables(cos_w, sin_w, r)
    got = afp.lnres_folded(port_tree(ln_p), port_tree(params),
                           torch.from_numpy(x).to(torch.bfloat16), *tabs,
                           torch.from_numpy(valid), nb)
    w = afp.prepare_fold(port_tree(params), *tabs, torch.bfloat16,
                         ln_params=port_tree(ln_p))
    assert got.dtype == torch.bfloat16
    assert_within_tolerance(got.float().numpy(),
                            np.asarray(ref.astype(jnp.float32)), x, valid, w,
                            True, f"P8 nb {nb}")


# ---------------------------------------------------------------------------
# The plain versions against the JAX baselines, fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,t", [("foldA", 24), ("foldB", 33),
                                       ("nb2", 40)])
def test_fold_plain_matches_jax_rotary_mha_fp32(width, variant, t):
    """P6/P7's plain version in fp32 against the composed JAX path
    (``rotary_mha(use_fused=False)``: no Pallas) on valid rows."""
    import jax.numpy as jnp
    from gigaam_tpu.ops import attention as jatt

    _, params, x, valid = draw_case(seed=100 + t, b=4, t=t)
    cos, sin, cos_w, sin_w, r = tables(t)
    ref = np.asarray(jatt.rotary_mha(jax_tree(params), jnp.asarray(x),
                                     jnp.asarray(cos), jnp.asarray(sin),
                                     jnp.asarray(valid), H, use_fused=False))
    heads = variant == "foldA"
    w = afp.prepare_fold(port_tree(params), *torch_tables(cos_w, sin_w, r),
                         torch.float32, per_head_weights=heads,
                         divide=variant != "nb2")
    got = afp.fold_plain(w, torch.from_numpy(x), torch.from_numpy(valid),
                         heads=heads).numpy()
    np.testing.assert_allclose(got[valid], ref[valid], rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("t", [24, 33])
def test_lnres_plain_matches_jax_folded_attention_fp32(width, t):
    """P8's plain version in fp32 against ``x + folded_rotary_attention(
    layer_norm(x))``, the JAX K2 in interpret mode, on valid rows."""
    import jax.numpy as jnp
    from gigaam_tpu.ops import conformer_ops as jops
    from gigaam_tpu.ops import pallas_attention as jpa

    ln_p, params, x, valid = draw_case(seed=200 + t, b=3, t=t)
    cos, sin, cos_w, sin_w, r = tables(t)
    xj = jnp.asarray(x)
    ref = np.asarray(xj + jpa.folded_rotary_attention(
        jax_tree(params), jops.layer_norm(jax_tree(ln_p), xj),
        jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(valid), H,
        interpret=True))
    w = afp.prepare_fold(port_tree(params), *torch_tables(cos_w, sin_w, r),
                         torch.float32, ln_params=port_tree(ln_p))
    got = afp.lnres_plain(w, torch.from_numpy(x),
                          torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got[valid], ref[valid], rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lnres_plain_differs_from_k1_only_by_the_residual_rounding(width,
                                                                   dtype):
    """P8 adds x to the fp32 accumulator, K1 to the rounded output: one
    bf16 step apart at most, equal in fp32."""
    ln_p, params, x, valid = draw_case(seed=5, b=3, t=40)
    cos, sin, cos_w, sin_w, r = tables(40)
    w = afp.prepare_fold(port_tree(params), *torch_tables(cos_w, sin_w, r),
                         dtype, ln_params=port_tree(ln_p))
    xt, vt = torch.from_numpy(x).to(dtype), torch.from_numpy(valid)
    p8 = afp.lnres_plain(w, xt, vt)
    k1 = fa.folded_rotary_attention_lnres_plain(w.fold, xt, w.cos, w.sin, vt,
                                                H)
    if dtype == torch.float32:
        assert torch.equal(p8, k1)
        return
    p8, k1 = p8.float().numpy(), k1.float().numpy()
    assert not np.array_equal(p8, k1)
    err = np.abs(p8 - k1)[valid]
    assert np.all(err <= one_step(p8, k1, p8 - x)[valid])


@pytest.mark.parametrize("lnres", [False, True])
def test_lean_path_computes_the_plain_function_in_fp32(width, lnres):
    """The lean stock path (one F.linear for Q/K, one for V, elementwise
    RoPE, SDPA with a boolean key mask, F.linear out; F.layer_norm and the
    add for P8) against the plain version in fp32, on valid rows."""
    ln_p, params, x, valid = draw_case(seed=9, b=3, t=30)
    cos, sin, cos_w, sin_w, r = tables(30)
    lnp = port_tree(ln_p) if lnres else None
    w = afp.prepare_fold(port_tree(params), *torch_tables(cos_w, sin_w, r),
                         torch.float32, ln_params=lnp)
    xt, vt = torch.from_numpy(x), torch.from_numpy(valid)
    lw = afp.lean_weights(port_tree(params), torch.float32, lnp)
    lcos, lsin = afp.lean_tables(w.cos, w.sin, torch.float32)
    lean = afp.lnres_lean if lnres else afp.fold_lean
    got = lean(lw, xt, lcos, lsin, vt[:, None, None, :])
    want = (afp.lnres_plain if lnres else afp.fold_plain)(w, xt, vt)
    torch.testing.assert_close(got[vt], want[vt], rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_prepare_fold_folds_the_scale_and_lays_out_the_heads(width):
    _, params, x, valid = draw_case(seed=11, b=2, t=16)
    _, _, cos_w, sin_w, r = tables(16)
    p = port_tree(params)
    w = afp.prepare_fold(p, *torch_tables(cos_w, sin_w, r), torch.float32,
                         per_head_weights=True)
    scale = 1.0 / np.sqrt(DH)
    np.testing.assert_array_equal(w.fold.wq.numpy(),
                                  params["linear_q"]["w"] * np.float32(scale))
    np.testing.assert_array_equal(w.fold.bq.numpy(),
                                  params["linear_q"]["b"] * np.float32(scale))
    # the script's per-head blocks [H, D, 48], transposed: [H, 48, D]
    blocks = (params["linear_k"]["w"].reshape(D, H, DH).transpose(1, 0, 2))
    np.testing.assert_array_equal(w.wk_heads.numpy(),
                                  blocks.transpose(0, 2, 1))
    assert w.wq_heads.shape == (H, DH, D) and w.wq_heads.is_contiguous()
    np.testing.assert_array_equal(w.cos.numpy(), cos_w[:, :DH])
    div = afp.prepare_fold(p, *torch_tables(cos_w, sin_w, r), torch.float32,
                           divide=True)
    np.testing.assert_array_equal(div.fold.bq.numpy(),
                                  params["linear_q"]["b"] / np.sqrt(DH)
                                  .astype(np.float32))
    with pytest.raises(ValueError, match="rotate-half permutation"):
        afp.prepare_fold(p, *torch_tables(cos_w, sin_w, r.T), torch.float32)
    other_heads = cos_w.copy()
    other_heads[:, DH:] *= 0.5
    with pytest.raises(ValueError, match="tile one head"):
        afp.prepare_fold(p, *torch_tables(other_heads, sin_w, r),
                         torch.float32)


# ---------------------------------------------------------------------------
# The wrappers' CPU path, the card path's checks, the runners
# ---------------------------------------------------------------------------

def test_wrappers_on_the_cpu_take_the_plain_version_and_count_no_launches(
        width):
    ln_p, params, x, valid = draw_case(seed=3, b=2, t=16)
    _, _, cos_w, sin_w, r = tables(16)
    tabs = torch_tables(cos_w, sin_w, r)
    xt, vt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(valid)
    afp.reset_launch_counts()
    w = afp.prepare_fold(port_tree(params), *tabs, torch.bfloat16,
                         ln_params=port_tree(ln_p), per_head_weights=True)
    assert torch.equal(afp.fold_lane_slices(w, xt, vt),
                       afp.fold_plain(w, xt, vt))
    assert torch.equal(afp.fold_heads(w, xt, vt),
                       afp.fold_plain(w, xt, vt, heads=True))
    assert torch.equal(afp.fold_nb(w, xt, vt, 2), afp.fold_plain(w, xt, vt))
    assert torch.equal(afp.fold_lnres(w, xt, vt, 2),
                       afp.lnres_plain(w, xt, vt))
    assert [fn.launches for fn in afp.KERNELS] == [0, 0, 0, 0]


def full_width_weights(dtype=torch.bfloat16, t=16):
    """Zero weights of the kernels' width (768, 16 heads), as the card path
    takes them, with foldA's blocks and tables for T = t."""
    d, h = afp.D, afp.H
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)
    fold = fa.FoldedWeights(*(z(d, d, dt=dtype) for _ in range(4)),
                            *(z(d) for _ in range(6)))
    return afp.AttnFoldWeights(fold, z(t, afp.DH), z(t, afp.DH),
                               z(h, afp.DH, d, dt=dtype),
                               z(h, afp.DH, d, dt=dtype))


def test_card_path_checks_reject_what_the_kernels_do_not_take():
    """The launch path validates before it touches the card."""
    w = full_width_weights()
    x = torch.zeros(4, 16, afp.D, dtype=torch.bfloat16)
    valid = torch.ones(4, 16, dtype=torch.bool)
    for nb in afp.NB_TILES:
        for heads in (False, True):
            afp._check_args(w, x, valid, nb, heads, lnres=not heads)
    with pytest.raises(ValueError, match="x is torch.float32"):
        afp._check_args(w, x.float(), valid, 1, False, False)
    with pytest.raises(ValueError, match=r"x must be \[B, T, 768\]"):
        afp._check_args(w, x[..., :384], valid, 1, False, False)
    with pytest.raises(ValueError, match="x must be contiguous"):
        afp._check_args(w, x.transpose(0, 1), valid.t(), 1, False, False)
    with pytest.raises(ValueError, match="got nb 3"):
        afp._check_args(w, x[:3], valid[:3], 3, False, False)
    with pytest.raises(ValueError, match="nb 4 does not divide B 2"):
        afp._check_args(w, x[:2], valid[:2], 4, False, False)
    with pytest.raises(ValueError, match="valid has shape"):
        afp._check_args(w, x, valid[:, :8], 1, False, False)
    with pytest.raises(ValueError, match="valid is torch.int8"):
        afp._check_args(w, x, valid.to(torch.int8), 1, False, False)
    with pytest.raises(ValueError, match="cos has shape"):
        afp._check_args(full_width_weights(t=8), x, valid, 1, False, False)
    with pytest.raises(ValueError, match="wq_heads has shape"):
        afp._check_args(afp.AttnFoldWeights(w.fold, w.cos, w.sin,
                                            w.wq_heads.transpose(1, 2)
                                            .contiguous(), w.wk_heads),
                        x, valid, 1, True, False)
    with pytest.raises(ValueError, match="foldA needs wk_heads"):
        afp._check_args(afp.AttnFoldWeights(w.fold, w.cos, w.sin,
                                            w.wq_heads), x, valid, 1, True,
                        False)
    with pytest.raises(ValueError, match="bo is torch.bfloat16"):
        afp._check_args(afp.AttnFoldWeights(
            dataclasses.replace(w.fold, bo=w.fold.bo.bfloat16()), w.cos,
            w.sin), x, valid, 1, False, False)
    with pytest.raises(ValueError, match="does not divide"):
        afp.folded_attention_nb(x[:3], {}, None, None, None, valid[:3], 2)
    with pytest.raises(ValueError, match="does not divide"):
        afp.lnres_folded({}, {}, x[:3], None, None, None, valid[:3], 4)


def test_wrappers_refuse_inputs_that_require_a_gradient(width):
    _, params, x, valid = draw_case(seed=4, b=2, t=16)
    _, _, cos_w, sin_w, r = tables(16)
    w = afp.prepare_fold(port_tree(params), *torch_tables(cos_w, sin_w, r),
                         torch.float32)
    xt = torch.from_numpy(x).requires_grad_()
    for call in (lambda: afp.fold_lane_slices(w, xt, torch.from_numpy(valid)),
                 lambda: afp.fold_lnres(w, xt, torch.from_numpy(valid), 1)):
        with pytest.raises(RuntimeError, match="has no backward"):
            call()
    with torch.no_grad():
        afp.fold_nb(w, xt, torch.from_numpy(valid), 2)


def test_kernel_resources_names_a_template_that_two_libraries_instantiate():
    """``build`` writes each library's report after ``[nvcc <name>]``; a
    template instance of ``projection.cuh`` (in an unnamed namespace, one
    per source) that K1/K2's library and the probe's both compile keeps its
    plain name for the first and takes the probe's after it."""
    from gigaam_tpu_torch.ops import cuda_lib

    def report(mangled, regs, spill):
        return (f"ptxas info    : Compiling entry function '{mangled}' for "
                f"'sm_90a'\nptxas info    : Function properties for "
                f"{mangled}\n    0 bytes stack frame, {spill} bytes spill "
                f"stores, 0 bytes spill loads\nptxas info    : Used {regs} "
                f"registers, used 1 barriers\n")
    def mangled(source, kernel, args, params):
        return (f"_ZN{len(source) + 31}_GLOBAL__N__0a1b2c3d_{len(source)}_"
                f"{source}_4e5f6a7b{len(kernel)}{kernel}I{args}EEvNS_{params}E")
    qkv = "qkv_kernel", "Li2ELi128E", "7QkvMapsENS_7QkvArgs"
    out = "out_proj_kernel", "Li4ELi128ELi2E", "7OutMapsENS_7OutArgs"
    log = "\n".join([
        "[nvcc projection]\n" + report(mangled("projection_cu", *qkv), 90, 0),
        "[nvcc attn_fold_probe]\n"
        + report(mangled("attn_fold_probe_cu", *qkv), 91, 0)
        + report(mangled("attn_fold_probe_cu", *out), 128, 4)])
    got = cuda_lib.kernel_resources(log)
    assert got == {
        "qkv_kernel<2, 128>": {"registers": 90, "spill_bytes": 0,
                               "static_smem_bytes": 0},
        "qkv_kernel<2, 128> (attn_fold_probe)": {
            "registers": 91, "spill_bytes": 0, "static_smem_bytes": 0},
        "out_proj_kernel<4, 128, 2>": {"registers": 128, "spill_bytes": 4,
                                       "static_smem_bytes": 0}}


def test_the_probe_library_is_registered_for_its_launches():
    from gigaam_tpu_torch.ops import cuda_lib

    sig = cuda_lib.SIGNATURES["attn_fold_probe"]
    assert set(sig) == {"gigaam_probe_qkv", "gigaam_probe_qkv_heads",
                        "gigaam_probe_out_proj",
                        "gigaam_attn_fold_probe_occupancy"}
    # K1/K2's library builds (and reports) first
    names = list(cuda_lib.SIGNATURES)
    assert names.index("projection") < names.index("attn_fold_probe")
    src = os.path.join(cuda_lib.CSRC_DIR, "attn_fold_probe.cu")
    with open(src) as f:
        text = f.read()
    for fn in sig:
        assert f"int {fn}(" in text


@pytest.mark.parametrize("which", ["fold", "lnres"])
def test_run_draws_the_scripts_inputs_and_reports_their_keys(
        scripts, width, monkeypatch, which):
    """Both runners at the test width on the CPU, the scripts' with their
    timers stubbed and their kernels in interpret mode (the fold script's
    baseline through the JAX ``fused_mha`` in interpret mode, the lnres
    script's through ``folded_rotary_attention`` in interpret mode): the
    port draws the same inputs, reports every key of the script's result,
    and its folds agree with its baseline as closely as the script's do."""
    import gigaam_tpu.ops.pallas_attention as jpa

    from jax.experimental import pallas as pl

    script = scripts[which]
    monkeypatch.setattr(afp, "CALLS", 1)
    monkeypatch.setattr(script, "pl", types.SimpleNamespace(
        pallas_call=lambda *a, compiler_params=None, interpret=None, **k:
        pl.pallas_call(*a, interpret=True, **k), BlockSpec=pl.BlockSpec))
    flat = lambda tree: json.loads(json.dumps(
        tree, default=lambda a: np.asarray(a).tolist()))
    seen = {}

    def timer(fn, args, **kwargs):
        seen["x"] = args[0]
        return 1e-6

    monkeypatch.setattr(script, "device_timeit", timer)
    b, t = 4, 80
    if which == "fold":
        monkeypatch.setattr(jpa, "fused_mha",
                            functools.partial(jpa.fused_mha, interpret=True))
        real = script.folded_attention

        def spy(x, params, *rest, **kwargs):
            seen["params"] = params
            return real(x, params, *rest, **kwargs)

        monkeypatch.setattr(script, "folded_attention", spy)
        want = script.run(b, t)
        got = afp.run(b, t, device="cpu")
        drawn = afp.fold_inputs(b, t)
        assert set(want) <= set(got)
        assert {"foldA_us", "foldA_maxrel", "K2_us", "lean_us"} <= set(got)
        for key in want:
            if key.endswith("_maxrel"):
                assert got[key] <= 2 * want[key] + 2.0 ** -8, key
        params_drawn, x_drawn, valid = drawn
    else:
        monkeypatch.setattr(script, "folded_rotary_attention",
                            functools.partial(jpa.folded_rotary_attention,
                                              interpret=True))
        real = script.lnres_folded

        def spy(ln_p, params, x, *rest):
            seen.update(ln_p=ln_p, params=params)
            return real(ln_p, params, x, *rest)

        monkeypatch.setattr(script, "lnres_folded", spy)
        nb = 2
        want = script.run(b, t, nb)
        got = afp.run_lnres(b, t, nb, device="cpu")
        drawn = afp.lnres_inputs(b, t)
        assert set(want) <= set(got)
        assert {"K1_us", "lean_us", "k1_residual_diff"} <= set(got)
        assert got["maxrel"] <= 2 * want["maxrel"] + 2.0 ** -8
        # one bf16 step at most, of outputs below 4 (x = 0.5 N(0, 1) plus a
        # module term far smaller at these weights)
        diff = got["k1_residual_diff"]
        assert 0 < diff["max_abs"] <= 2.0 ** -6 and diff["in_rms"] > 0
        ln_drawn, params_drawn, x_drawn, valid = drawn
        assert flat(ln_drawn) == flat(seen["ln_p"])
    assert flat(params_drawn) == flat(seen["params"])
    assert np.array_equal(bf16_values(x_drawn),
                          np.asarray(seen["x"], np.float32))
    assert np.array_equal(valid, afp.ragged_valid(b, t))


def test_main_runs_the_scripts_shapes_and_keys(scripts, monkeypatch, capsys):
    """Both scripts' mains and the port's, their runners replaced by stubs
    that record the call: the same shapes in the same order, under the same
    keys, in the port's one JSON line under "fold" and "lnres"."""
    def calls_of(mod, runner, *args):
        calls = []

        def stub(*shape, check=True, device=None):
            calls.append(shape)
            return {}

        monkeypatch.setattr(mod, runner, stub)
        capsys.readouterr()
        mod.main(*args)
        return calls, json.loads(capsys.readouterr().out.strip()
                                 .splitlines()[-1])

    fold_calls, fold_printed = calls_of(scripts["fold"], "run")
    lnres_calls, lnres_printed = calls_of(scripts["lnres"], "run")
    monkeypatch.setattr(afp, "run_lnres", lambda b, t, nb, device=None: (
        port_calls.append(("lnres", b, t, nb)) or {}))
    port_calls = []
    monkeypatch.setattr(afp, "run", lambda b, t, check=True, device=None: (
        port_calls.append(("fold", b, t)) or {}))
    capsys.readouterr()
    afp.main("cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(printed) == ["fold", "lnres"]
    assert [c[1:] for c in port_calls if c[0] == "fold"] == fold_calls
    assert [c[1:] for c in port_calls if c[0] == "lnres"] == lnres_calls
    assert list(printed["fold"]) == list(fold_printed)
    assert list(printed["lnres"]) == list(lnres_printed)


# ---------------------------------------------------------------------------
# On the card: each variant against its plain version, bf16
# ---------------------------------------------------------------------------

GPU_REL, GPU_RTOL = 0.1, 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest "
                    "--noconftest -m gpu tests/test_torch_attn_fold_probes.py)")
    return torch.device("cuda")


def card_case(dev, b, t, seed, lnres=False):
    """Full-width weights with peaked scores (chip_smoke.py's draw), x
    [B, T, 768] bf16 and the scripts' ragged lengths, on ``dev``."""
    rng = np.random.default_rng(seed)
    d = afp.D
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    gains = {"linear_q": QK_GAIN, "linear_k": QK_GAIN, "linear_v": 1.0,
             "linear_out": 1.0}
    params = {n: {"w": torch.from_numpy(f32(d, d) * np.float32(g / d ** 0.5))
                  .to(dev), "b": torch.from_numpy(0.1 * f32(d)).to(dev)}
              for n, g in gains.items()}
    ln_p = ({"scale": torch.from_numpy(1.0 + 0.1 * f32(d)).to(dev),
             "bias": torch.from_numpy(0.1 * f32(d)).to(dev)} if lnres else None)
    x = torch.from_numpy(0.5 * f32(d) + rng.uniform(0.5, 2.0, (b, t, 1))
                         * f32(b, t, d)).to(dev, torch.bfloat16)
    valid = torch.from_numpy(afp.ragged_valid(b, t)).to(dev)
    cos, sin = rotary_tables(t, afp.DH, 5000.0)
    cos_w, sin_w, r = afp.rope_tables_wide(cos, sin)
    tabs = (torch.from_numpy(cos_w).to(dev), torch.from_numpy(sin_w).to(dev),
            torch.from_numpy(r).to(dev, torch.bfloat16))
    w = afp.prepare_fold(params, *tabs, torch.bfloat16, ln_params=ln_p,
                         per_head_weights=True)
    return w, x, valid


def assert_kernel_close(got, ref, x, valid, lnres):
    got, ref, x = got.float()[valid], ref.float()[valid], x.float()[valid]
    term = ref - x if lnres else ref
    rms = float(term.pow(2).mean().sqrt())
    err = (got - ref).abs()
    assert float((err - GPU_RTOL * ref.abs()).max()) <= GPU_REL * rms


CARD_CASES = [("lane_slices", 1), ("heads", 1), ("nb", 2), ("nb", 4),
              ("lnres", 1), ("lnres", 2), ("lnres", 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,t", [(4, 64), (4, 77), (8, 500)])
@pytest.mark.parametrize("variant,nb", CARD_CASES)
def test_cuda_variant_matches_plain(cuda, variant, nb, b, t):
    lnres = variant == "lnres"
    w, x, valid = card_case(cuda, b, t, seed=b * t + nb, lnres=lnres)
    kernel = {"lane_slices": afp.fold_lane_slices, "heads": afp.fold_heads,
              "nb": afp.fold_nb, "lnres": afp.fold_lnres}[variant]
    args = (w, x, valid) + ((nb,) if variant in ("nb", "lnres") else ())
    before = kernel.launches
    got = kernel(*args)
    assert kernel.launches == before + 1
    ref = (afp.lnres_plain(w, x, valid) if lnres
           else afp.fold_plain(w, x, valid, heads=variant == "heads"))
    assert_kernel_close(got, ref, x, valid, lnres)
    for _ in range(3):
        assert torch.equal(kernel(*args), got)


@pytest.mark.gpu
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    w, x, valid = card_case(cuda, 2, 64, seed=1)
    with pytest.raises(ValueError, match="valid has shape"):
        afp.fold_lane_slices(w, x, valid[:, :32])
    with pytest.raises(ValueError, match="got nb 8"):
        afp.fold_nb(w, x, valid, 8)
    with pytest.raises(ValueError, match="x is torch.float32"):
        afp.fold_heads(w, x.float(), valid)


@pytest.mark.gpu
def test_cuda_probe_and_k1_k2_share_the_templates_not_their_launch_state(cuda):
    """P6's kept kernels at nb 2 (``fold_ring``: the design P6 ran on
    before its redesign) are K2's own pair of GEMM instances at a shape
    where K2 takes 128-row tiles (B 8, T 512), compiled again into the
    probe's library: the two give the same bits, whichever launches first
    in the process; P8 at nb 2 is K1 but for where the residual is
    rounded, at most one bf16 step of the larger of the output and the
    module term apart."""
    w, x, valid = card_case(cuda, 8, 512, seed=3, lnres=True)
    k2 = lambda: fa.folded_rotary_attention(w.fold, x, w.cos, w.sin, valid,
                                            afp.H)
    p6 = lambda: afp.fold_ring(w, x, valid, 2)
    first = k2()
    assert torch.equal(p6(), first) and torch.equal(k2(), first)
    k1 = fa.folded_rotary_attention_lnres(w.fold, x, w.cos, w.sin, valid,
                                          afp.H).float()[valid]
    p8 = afp.fold_lnres(w, x, valid, 2).float()[valid]
    larger = torch.maximum(torch.maximum(p8.abs(), k1.abs()),
                           (p8 - x.float()[valid]).abs())
    step = 2.0 ** (torch.floor(torch.log2(larger)) - 7)
    assert bool(((p8 - k1).abs() <= step).all())
