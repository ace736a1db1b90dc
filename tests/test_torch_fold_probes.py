"""The FFN and conv-module fold probes (P4, P5:
``gigaam_tpu_torch/probes/fold_probes.py``).

On the CPU each kernel wrapper runs its plain version, which is held
against the script it replaces (``benchmarks/pallas_ffn_fold_probe.py``,
``benchmarks/pallas_conv_fold_probe.py``, imported from their files): the
script's own wrapper, with its BlockSpecs, casts and BatchNorm fold, and its
kernel body run in interpret mode inside a ``pallas_call`` that this file
builds (``interpret=True``, without the TPU's compiler parameters), at a
small width (d 64, d_ff 256, the script's 31 taps), B 2-4, T 24-40 and nb 1
and 2.  Both sides take the same bf16 inputs.

The tolerance is one bf16 step of the output, taken at the larger of the
output and the sub-block's own term (``out - x``).  Both sides round the
same math to bf16 at the same points (LN, h or the GLU, the conv's SiLU,
the sub-block's term, the sum with x), but their fp32 sums run in other
orders and their exponentials differ in the last bit.  So a rounding to
bf16 may land on the other neighbour of a value: for the sub-block's term
that moves the sum with x by one step of the term, which the rounding of
the sum keeps within one step of the larger of the two; a flipped h, y or
c moves the next product by 2^-8 of one of its terms, far below a step of
its sum.  The step is taken at no less than 2^-16 x the output's RMS,
where fp32's own rounding of the sums would exceed the step of a value that
cancelled to near zero.

Each plain version in fp32 is also held against the JAX baseline the script
times (``x + 0.5 * ffn(LN(x))``, ``x + conformer_conv(LN(x))``), on each
row's valid frames, within 1e-5 of the output's largest value: the same
math in fp32, the rounding points then no-ops, in another order.

The tests marked ``gpu`` hold each CUDA kernel against its plain version on
the card in bf16, within a tenth of the sub-block term's RMS plus one bf16
rounding of the value, as ``chip_smoke.py`` holds the kernels; they skip
without one (on the card: ``pytest --noconftest -m gpu
tests/test_torch_fold_probes.py``).
"""

import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

from gigaam_tpu_torch.probes import fold_probes as fp
from gigaam_tpu_torch.weights import sub_block_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, DFF = 64, 256
SCRIPTS = {"ffn": "pallas_ffn_fold_probe", "conv": "pallas_conv_fold_probe"}
# (nb, B, T): nb divides B; T not a multiple of 8 in the last
SHAPES = [(1, 2, 24), (2, 4, 40), (2, 2, 33)]


def load_script(name):
    path = os.path.join(REPO, "benchmarks", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{name}_script", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    """Both scripts, imported from their files, with ``pl.pallas_call``
    building interpret-mode calls (the TPU's compiler parameters dropped)."""
    from jax.experimental import pallas as pl

    def interpret_call(*args, compiler_params=None, **kwargs):
        return pl.pallas_call(*args, interpret=True, **kwargs)

    mods = {probe: load_script(name) for probe, name in SCRIPTS.items()}
    for mod in mods.values():
        mod.pl = types.SimpleNamespace(pallas_call=interpret_call,
                                       BlockSpec=pl.BlockSpec)
    return mods


def bf16_values(a):
    """float32 numpy values that bf16 represents."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def ffn_tree(seed):
    """(ln_p, p, x) at the test width: JAX-layout numpy trees, x [B, T, D]
    float64 to be cast; weights at 1/sqrt(fan-in), so h and y are O(1)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    p = {"linear1": {"w": f32(rng.standard_normal((D, DFF)) / D ** 0.5),
                     "b": f32(0.1 * rng.standard_normal(DFF))},
         "linear2": {"w": f32(rng.standard_normal((DFF, D)) / DFF ** 0.5),
                     "b": f32(0.1 * rng.standard_normal(D))}}
    ln_p = {"scale": f32(1.0 + 0.1 * rng.standard_normal(D)),
            "bias": f32(0.1 * rng.standard_normal(D))}
    return ln_p, p, rng


def conv_tree(seed):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    mat = lambda: f32(rng.standard_normal((D, D)) / D ** 0.5)
    vec = lambda g=0.1: f32(g * rng.standard_normal(D))
    p = {"pointwise_conv1": {"w_value": mat(), "b_value": vec(),
                            "w_gate": mat(), "b_gate": vec()},
         "depthwise_conv": {"w": f32(rng.standard_normal((fp.K, 1, D))
                                     / fp.K ** 0.5), "b": vec()},
         "batch_norm": {"scale": 1.0 + vec(), "bias": vec(), "mean": vec(),
                        "var": 1.0 + np.abs(vec())},
         "pointwise_conv2": {"w": mat(), "b": vec()}}
    ln_p = {"scale": 1.0 + vec(), "bias": vec()}
    return ln_p, p, rng


def draw_x(rng, b, t):
    """x [B, T, D] with a per-channel mean and a per-row scale, so that
    LayerNorm changes it; bf16 values."""
    mean = 0.5 * rng.standard_normal(D)
    scale = 0.5 + 1.5 * rng.random((b, t, 1))
    return bf16_values(mean + scale * rng.standard_normal((b, t, D)))


def ragged_valid(b, t):
    """Every row but the first ends early; one padded frame sits inside the
    depthwise window of the last valid ones."""
    lens = np.array([t] + [t - 5 - 3 * i for i in range(1, b)])
    return np.arange(t)[None, :] < lens[:, None]


def port_tree(tree, dtype=torch.float32):
    return {k: port_tree(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in sub_block_from_jax(tree).items()}


def jax_tree(tree):
    import jax.numpy as jnp
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def one_step(got, ref, x):
    """One bf16 step at the larger of |got|, |ref| and |ref - x| (the
    sub-block's term), and no less than 2^-16 x RMS(ref)."""
    rms = np.sqrt(np.mean(ref ** 2))
    larger = np.maximum.reduce([np.abs(got), np.abs(ref), np.abs(ref - x),
                                np.full(ref.shape, 2.0 ** -16 * rms)])
    return 2.0 ** (np.floor(np.log2(larger)) - 7)


def assert_within_one_step(got, ref, x, what):
    err = np.abs(got - ref)
    step = one_step(got, ref, x)
    assert np.all(err <= step), f"{what}: {np.max(err / step)} bf16 steps"


# ---------------------------------------------------------------------------
# The plain versions against the Pallas bodies, bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb,b,t", SHAPES)
def test_ffn_plain_matches_pallas_body(scripts, nb, b, t):
    import jax.numpy as jnp

    ln_np, p_np, rng = ffn_tree(seed=t)
    x = draw_x(rng, b, t)
    ref = np.asarray(scripts["ffn"].ffn_lnres_folded(
        jax_tree(ln_np), jax_tree(p_np), jnp.asarray(x, jnp.bfloat16), nb)
        .astype(jnp.float32))
    got = fp.ffn_lnres_folded(port_tree(ln_np), port_tree(p_np),
                              torch.from_numpy(x).to(torch.bfloat16), nb)
    assert got.dtype == torch.bfloat16
    assert_within_one_step(got.float().numpy(), ref, x, f"P4 nb {nb}")


@pytest.mark.parametrize("nb,b,t", SHAPES)
def test_conv_plain_matches_pallas_body(scripts, nb, b, t):
    import jax.numpy as jnp

    ln_np, p_np, rng = conv_tree(seed=t)
    x = draw_x(rng, b, t)
    valid = ragged_valid(b, t)
    ref = np.asarray(scripts["conv"].conv_lnres_folded(
        jax_tree(ln_np), jax_tree(p_np), jnp.asarray(x, jnp.bfloat16),
        jnp.asarray(valid), nb).astype(jnp.float32))
    got = fp.conv_lnres_folded(port_tree(ln_np), port_tree(p_np),
                               torch.from_numpy(x).to(torch.bfloat16),
                               torch.from_numpy(valid), nb)
    assert got.dtype == torch.bfloat16
    assert_within_one_step(got.float().numpy(), ref, x, f"P5 nb {nb}")


# ---------------------------------------------------------------------------
# The plain versions against the JAX baselines, fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [24, 40])
def test_ffn_plain_matches_jax_baseline_fp32(t):
    import jax.numpy as jnp
    from gigaam_tpu.ops import conformer_ops as jops

    ln_np, p_np, rng = ffn_tree(seed=100 + t)
    x = draw_x(rng, 3, t)
    ref = np.asarray(jnp.asarray(x) + 0.5 * jops.ffn(
        jax_tree(p_np), jops.layer_norm(jax_tree(ln_np), jnp.asarray(x))))
    w = fp.prepare_ffn(port_tree(ln_np), port_tree(p_np), torch.float32)
    got = fp.ffn_fold_plain(w, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("t", [24, 40])
def test_conv_plain_matches_jax_baseline_fp32(t):
    import jax.numpy as jnp
    from gigaam_tpu.ops import conformer_ops as jops

    ln_np, p_np, rng = conv_tree(seed=100 + t)
    x = draw_x(rng, 3, t)
    valid = ragged_valid(3, t)
    ref = np.asarray(jnp.asarray(x) + jops.conformer_conv(
        jax_tree(p_np), jops.layer_norm(jax_tree(ln_np), jnp.asarray(x)),
        jnp.asarray(valid), "batch_norm")[0])
    w = fp.prepare_conv(port_tree(ln_np), port_tree(p_np), torch.float32)
    got = fp.conv_fold_plain(w, torch.from_numpy(x),
                             torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got[valid], ref[valid], rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("probe", fp.PROBES)
def test_stock_paths_compute_the_plain_function_in_fp32(probe):
    """Both stock compositions the fold is timed against compute the same
    function as the plain version (fp32: no rounding points)."""
    if probe == "ffn":
        ln_np, p_np, rng = ffn_tree(seed=7)
    else:
        ln_np, p_np, rng = conv_tree(seed=7)
    x = torch.from_numpy(draw_x(rng, 2, 30))
    valid = torch.from_numpy(ragged_valid(2, 30))
    ln_p, p = port_tree(ln_np), port_tree(p_np)
    if probe == "ffn":
        want = fp.ffn_fold_plain(fp.prepare_ffn(ln_p, p, x.dtype), x)
        stock = (fp.ffn_baseline(ln_p, p, x),
                 fp.ffn_lean(fp.lean_ffn_weights(ln_p, p, x.dtype), x))
    else:
        want = fp.conv_fold_plain(fp.prepare_conv(ln_p, p, x.dtype), x, valid)
        stock = (fp.conv_baseline(ln_p, p, x, valid),
                 fp.conv_lean(fp.lean_conv_weights(ln_p, p, x.dtype), x,
                              valid[..., None].to(x.dtype)))
    for got in stock:
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def test_sub_block_from_jax_turns_the_depthwise_layout():
    _, p_np, _ = conv_tree(seed=1)
    p = sub_block_from_jax(p_np)
    w = p_np["depthwise_conv"]["w"]                     # [K, 1, C]
    assert p["depthwise_conv"]["w"].shape == (D, 1, fp.K)
    assert np.array_equal(p["depthwise_conv"]["w"].numpy(),
                          w.transpose(2, 1, 0))
    assert np.array_equal(p["pointwise_conv1"]["w_value"].numpy(),
                          p_np["pointwise_conv1"]["w_value"])
    # the fold's taps come back to the script's [K, C]
    taps = fp.prepare_conv({"scale": torch.ones(D), "bias": torch.zeros(D)},
                           p, torch.bfloat16).dw
    assert np.array_equal(taps.numpy(), w.reshape(fp.K, D))


# ---------------------------------------------------------------------------
# The wrappers' CPU path, the card path's checks, the runners
# ---------------------------------------------------------------------------

def test_wrappers_on_the_cpu_take_the_plain_version_and_count_no_launches():
    ln_np, p_np, rng = ffn_tree(seed=3)
    x = torch.from_numpy(draw_x(rng, 2, 16)).to(torch.bfloat16)
    fp.reset_launch_counts()
    w = fp.prepare_ffn(port_tree(ln_np), port_tree(p_np), x.dtype)
    assert torch.equal(fp.ffn_fold(w, x), fp.ffn_fold_plain(w, x))
    ln_np, p_np, rng = conv_tree(seed=3)
    valid = torch.from_numpy(ragged_valid(2, 16))
    w = fp.prepare_conv(port_tree(ln_np), port_tree(p_np), x.dtype)
    assert torch.equal(fp.conv_fold(w, x, valid),
                       fp.conv_fold_plain(w, x, valid))
    assert [fn.launches for fn in fp.KERNELS] == [0, 0]


def full_width_weights(probe, dtype=torch.bfloat16):
    """Zero weights of the kernels' width (768), as the card path takes."""
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)
    if probe == "ffn":
        return fp.FfnFoldWeights(z(fp.D), z(fp.D), z(fp.D, fp.DFF, dt=dtype),
                                 z(fp.DFF), z(fp.DFF, fp.D, dt=dtype),
                                 z(fp.D))
    return fp.ConvFoldWeights(
        z(fp.D), z(fp.D), z(fp.D, fp.D, dt=dtype), z(fp.D),
        z(fp.D, fp.D, dt=dtype), z(fp.D), z(fp.K, fp.D), z(fp.D), z(fp.D),
        z(fp.D, fp.D, dt=dtype), z(fp.D))


def test_card_path_checks_reject_what_the_kernels_do_not_take():
    """The launch path validates before it touches the card."""
    x = torch.zeros(2, 16, fp.D, dtype=torch.bfloat16)
    valid = torch.ones(2, 16, dtype=torch.bool)
    wf, wc = full_width_weights("ffn"), full_width_weights("conv")
    fp._check_ffn_args(wf, x)
    fp._check_conv_args(wc, x, valid)
    with pytest.raises(ValueError, match="x is torch.float32"):
        fp._check_ffn_args(wf, x.float())
    with pytest.raises(ValueError, match=r"x must be \[B, T, 768\]"):
        fp._check_ffn_args(wf, x[..., :64])
    with pytest.raises(ValueError, match="x must be contiguous"):
        fp._check_ffn_args(wf, x.transpose(0, 1))
    with pytest.raises(ValueError, match="w1 has shape"):
        fp._check_ffn_args(fp.FfnFoldWeights(
            wf.ln_g, wf.ln_b, wf.w2, wf.b1, wf.w2, wf.b2), x)
    with pytest.raises(ValueError, match="b1 is torch.bfloat16"):
        fp._check_ffn_args(fp.FfnFoldWeights(
            wf.ln_g, wf.ln_b, wf.w1, wf.b1.bfloat16(), wf.w2, wf.b2), x)
    with pytest.raises(ValueError, match="w2 must be contiguous"):
        fp._check_conv_args(fp.ConvFoldWeights(
            **{**vars(wc), "w2": wc.w2.t()}), x, valid)
    with pytest.raises(ValueError, match="dw has shape"):
        fp._check_conv_args(fp.ConvFoldWeights(
            **{**vars(wc), "dw": wc.dw.t().contiguous()}), x, valid)
    with pytest.raises(ValueError, match="valid has shape"):
        fp._check_conv_args(wc, x, valid[:, :8])
    with pytest.raises(ValueError, match="valid has shape"):
        fp._check_conv_args(wc, x, valid[:1])
    with pytest.raises(ValueError, match="valid is torch.int8"):
        fp._check_conv_args(wc, x, valid.to(torch.int8))
    with pytest.raises(ValueError, match="does not divide"):
        fp.ffn_lnres_folded({}, {}, x, 3)


@pytest.mark.parametrize("probe", fp.PROBES)
def test_run_draws_the_scripts_inputs_and_reports_their_keys(
        scripts, monkeypatch, probe):
    """Both runners at the test width on the CPU, the script's with its
    timer stubbed and its kernel in interpret mode: the port draws the same
    inputs, reports every key of the script's result, and its fold agrees
    with its baseline as closely as the script's does."""
    script = scripts[probe]
    monkeypatch.setattr(script, "D", D)
    monkeypatch.setattr(fp, "D", D)
    if probe == "ffn":
        monkeypatch.setattr(script, "DFF", DFF)
        monkeypatch.setattr(fp, "DFF", DFF)
    seen = {}
    folded = {"ffn": "ffn_lnres_folded", "conv": "conv_lnres_folded"}[probe]
    real = getattr(script, folded)

    def spy(ln_p, p, x, *rest):
        seen.update(ln_p=ln_p, p=p, rest=rest)
        return real(ln_p, p, x, *rest)

    def timer(fn, args, **kwargs):
        seen["x"] = args[0]
        return 1e-6

    monkeypatch.setattr(script, folded, spy)
    monkeypatch.setattr(script, "device_timeit", timer)
    b, t, nb = 2, 80, 2
    want = script.run(b, t, nb)
    got = fp.run(b, t, nb, probe, device="cpu")
    assert set(want) <= set(got)
    assert got["nb"] == nb and got[fp.FOLD_KEY[probe]] > 0
    assert got["maxrel"] <= 2 * want["maxrel"] + 2.0 ** -8

    drawn = (fp.ffn_inputs if probe == "ffn" else fp.conv_inputs)(b, t)
    flat = lambda tree: json.loads(json.dumps(
        tree, default=lambda a: np.asarray(a).tolist()))
    assert flat(drawn[0]) == flat(seen["ln_p"])
    assert flat(drawn[1]) == flat(seen["p"])
    assert np.array_equal(bf16_values(drawn[2]),
                          np.asarray(seen["x"], np.float32))
    if probe == "conv":
        assert np.array_equal(drawn[3], np.asarray(seen["rest"][0]))


def test_main_runs_the_scripts_shapes_and_keys(scripts, monkeypatch, capsys):
    """Both scripts' mains and the port's, their runners replaced by stubs
    that record the call: the same shapes in the same order, under the same
    keys, one probe after the other in the port's one JSON line."""
    def calls_of(mod, *args):
        calls = []

        def stub(b, t, nb, probe=None, device=None):
            calls.append((b, t, nb) if probe is None else (probe, b, t, nb))
            return {"nb": nb}

        monkeypatch.setattr(mod, "run", stub)
        capsys.readouterr()
        mod.main(*args)
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        return calls, printed

    port_calls, port_printed = calls_of(fp, "cpu")
    assert list(port_printed) == list(fp.PROBES)
    for probe in fp.PROBES:
        calls, printed = calls_of(scripts[probe])
        assert [c[1:] for c in port_calls if c[0] == probe] == calls
        assert list(port_printed[probe]) == list(printed)


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version, bf16
# ---------------------------------------------------------------------------

GPU_REL, GPU_RTOL = 0.1, 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest --noconftest -m gpu tests/test_torch_fold_probes.py)")
    return torch.device("cuda")


def card_inputs(probe, b, t, dev):
    """The script's weights at full width on ``dev`` and a bf16 x."""
    if probe == "ffn":
        ln_np, p_np, x_np = fp.ffn_inputs(b, t)
        valid = None
    else:
        ln_np, p_np, x_np, valid_np = fp.conv_inputs(b, t)
        valid = torch.from_numpy(valid_np).to(dev)
    ln_p = fp.tree_to(sub_block_from_jax(ln_np), dev)
    p = fp.tree_to(sub_block_from_jax(p_np), dev)
    x = torch.from_numpy(x_np).to(dev, torch.bfloat16)
    w = (fp.prepare_ffn if probe == "ffn" else fp.prepare_conv)(
        ln_p, p, torch.bfloat16)
    return w, x, valid


def assert_kernel_close(got, ref, x, valid=None):
    rows = (torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
            if valid is None else valid)
    got, ref, x = got.float()[rows], ref.float()[rows], x.float()[rows]
    rms = float((ref - x).pow(2).mean().sqrt())
    err = (got - ref).abs()
    assert float((err - GPU_RTOL * ref.abs()).max()) <= GPU_REL * rms


@pytest.mark.gpu
@pytest.mark.parametrize("b,t", [(1, 64), (2, 100), (3, 130), (16, 500)])
@pytest.mark.parametrize("probe", fp.PROBES)
def test_cuda_kernel_matches_plain(cuda, probe, b, t):
    w, x, valid = card_inputs(probe, b, t, cuda)
    kernel, plain = ((fp.ffn_fold, fp.ffn_fold_plain) if probe == "ffn"
                     else (fp.conv_fold, fp.conv_fold_plain))
    args = (w, x) if valid is None else (w, x, valid)
    before = kernel.launches
    got = kernel(*args)
    assert kernel.launches == before + 1
    assert_kernel_close(got, plain(*args), x, valid)
    assert torch.equal(kernel(*args), got)


@pytest.mark.gpu
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    w, x, valid = card_inputs("conv", 2, 64, cuda)
    with pytest.raises(ValueError, match="valid has shape"):
        fp.conv_fold(w, x, valid[:, :32])
    with pytest.raises(ValueError, match="x must be contiguous"):
        fp.conv_fold(w, x.transpose(0, 1), valid.t())
    w, x, _ = card_inputs("ffn", 2, 64, cuda)
    with pytest.raises(ValueError, match="x is torch.float32"):
        fp.ffn_fold(w, x.float())
