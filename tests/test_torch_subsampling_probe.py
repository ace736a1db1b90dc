"""The conv2d-subsampling probes (P1-P3:
``gigaam_tpu_torch/probes/subsampling_probe.py``).

On the CPU each kernel wrapper runs its plain version, which is held
against the Pallas bodies of the script it replaces
(``benchmarks/pallas_subsampling_probe.py``, imported from its file): the
script's own probes run with ``pl.pallas_call`` building interpret-mode
calls (the TPU's compiler parameters dropped) that record each call's
arguments and output, at a small width (``D`` 64 in both modules), T 2-4,
and with the script's timer replaced by one call.  Both sides take the same
bf16 inputs: the script's own draws.

The tolerance is one bf16 step of the output, taken at the larger of |got|
and |ref|.  Both sides sum the same bf16 products in fp32 and round to bf16
at the same points (P1 and P2 without the linear: the sum; P2 with it:
relu(s2), then the linear's sum), but the fp32 sums run in other orders.
So a rounding to bf16 may land on the other neighbour of a value: one step
of the output; a flipped relu(s2) moves the linear's sum by 2^-8 of one of
its 12288 terms, far below a step of the sum.  The step is taken at no less
than 2^-16 x the output's RMS, where fp32's own rounding of the sums would
exceed the step of a value that cancelled to near zero.  P3 copies and
doubles bf16 values, which is exact: it is held to equality.

P1 with copies and P2 are the stage-2 conv: in fp32 each plain version is
held against ``jax.lax.conv_general_dilated`` (stride 2, NHWC/HWIO, as
``gigaam_tpu/ops/conformer_ops.py`` runs it) on the interleaved X, with the
tap-to-kernel-position mapping ``TAP_POSITIONS``, and P2 with the linear
against the conv, ReLU, the f-major flatten and the matmul, within 1e-5 of
the output's largest value: the same math, in another order.  The stock
calls the kernels are timed against are held to the plain versions the
same way, in PyTorch.

The tests marked ``gpu`` hold each CUDA kernel against its plain version on
the card in bf16, within a tenth of the output's RMS plus one bf16 rounding
of the value, as ``chip_smoke.py`` holds them; they skip without one (on
the card: ``pytest --noconftest -m gpu
tests/test_torch_subsampling_probe.py``).
"""

import importlib.util
import inspect
import json
import os
import types

import numpy as np
import pytest
import torch

from gigaam_tpu_torch.probes import subsampling_probe as sp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 64


@pytest.fixture(scope="module")
def script():
    """The script, imported from its file, with ``pl.pallas_call`` building
    interpret-mode calls that record ``(args, out)`` of each concrete call
    in ``mod.calls`` and each built call in ``mod.built``."""
    from jax.experimental import pallas as pl

    path = os.path.join(REPO, "benchmarks", "pallas_subsampling_probe.py")
    spec = importlib.util.spec_from_file_location("subsampling_script", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.calls, mod.built = [], []

    def interpret_call(kernel, compiler_params=None, interpret=None, **kw):
        f = pl.pallas_call(kernel, interpret=True, **kw)

        def recorded(*args):
            out = f(*args)
            mod.calls.append((args, out))
            return out

        mod.built.append((f, kw))
        return recorded

    mod.pl = types.SimpleNamespace(pallas_call=interpret_call,
                                   BlockSpec=pl.BlockSpec)
    return mod


@pytest.fixture
def narrow(script, monkeypatch):
    """Both modules at the test width, the script's timer one call."""
    monkeypatch.setattr(script, "D", D)
    monkeypatch.setattr(sp, "D", D)

    def one_call(fn, args, **kwargs):
        fn(*args)
        return 1e-6

    monkeypatch.setattr(script, "device_timeit", one_call)
    script.calls.clear()
    script.built.clear()
    return script


def np32(a):
    return np.asarray(a, np.float32)


def to_port(arrays, batched=4):
    """bf16 tensors of the script's arrays; the blocks get a batch of 1."""
    out = [torch.from_numpy(np32(a)).to(torch.bfloat16) for a in arrays]
    return [a[None] if i < batched else a for i, a in enumerate(out)]


def bf16_values(a):
    """float32 numpy values that bf16 represents."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def assert_within_one_step(got, ref, what):
    rms = np.sqrt(np.mean(ref ** 2))
    larger = np.maximum.reduce([np.abs(got), np.abs(ref),
                                np.full(ref.shape, 2.0 ** -16 * rms)])
    step = 2.0 ** (np.floor(np.log2(larger)) - 7)
    err = np.abs(got - ref)
    assert np.all(err <= step), f"{what}: {np.max(err / step)} bf16 steps"


# ---------------------------------------------------------------------------
# The plain versions against the Pallas bodies, bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tb", [2, 3, 4])
@pytest.mark.parametrize("with_copies", [True, False])
def test_taps_plain_matches_pallas_body(narrow, tb, with_copies):
    assert narrow.probe_taps(tb, with_copies, interpret=True) == {"ok": True}
    (args, out), = narrow.calls
    ee, eo, oe, oo, w = to_port(args)
    assert eo.shape[2] == (17 if with_copies else 16)
    got = sp.taps_product(ee, eo, oe, oo, w, sp.TAPS[with_copies])
    assert got.dtype == torch.bfloat16 and got.shape == (1, tb, 16, D)
    assert_within_one_step(got[0].float().numpy(), np32(out),
                           f"P1 tb {tb} with_copies {with_copies}")


@pytest.mark.parametrize("tb", [2, 4])
@pytest.mark.parametrize("fuse_linear", [False, True])
def test_im2col_plain_matches_pallas_body(narrow, tb, fuse_linear):
    narrow.probe_im2col(tb, fuse_linear)
    (args, out), = narrow.calls
    ee, eo, oe, oo, w, wl = to_port(args)
    got = sp.im2col_product(ee, eo, oe, oo, w, wl if fuse_linear else None)
    assert got.dtype == torch.bfloat16 and got.shape == (1, tb, D)
    assert_within_one_step(got[0].float().numpy(), np32(out),
                           f"P2 tb {tb} fuse_linear {fuse_linear}")


@pytest.fixture(scope="module")
def vmem_ladder(script):
    """The script's probe_vmem run once: its result and each rung's built
    call with its scratch size in bytes."""
    script.built.clear()
    result = script.probe_vmem()
    rungs = [(f, int(np.prod(kw["scratch_shapes"][0].shape)) * 2)
             for f, kw in script.built]
    return result, rungs


@pytest.mark.parametrize("rung", [0, 3, 7])
def test_vmem_plain_matches_pallas_body(vmem_ladder, rung):
    import jax.numpy as jnp

    result, rungs = vmem_ladder
    assert result == {"max_scratch_mb": 120} and len(rungs) == 8
    f, n_bytes = rungs[rung]
    x = bf16_values(np.random.default_rng(rung).standard_normal((8, 1024)))
    want = np32(f(jnp.asarray(x, jnp.bfloat16)))
    got, blocks = sp.smem_copy(torch.from_numpy(x).to(torch.bfloat16),
                               n_bytes)
    assert blocks is None
    assert np.array_equal(got.float().numpy(), want)
    assert np.array_equal(want, 2 * x)


# ---------------------------------------------------------------------------
# The probes are the stage-2 conv, fp32
# ---------------------------------------------------------------------------

def fp32_blocks(rng, b, tb, c=D):
    shapes = ((b, tb, 16, c), (b, tb, 17, c), (b, tb + 1, 16, c),
              (b, tb + 1, 17, c))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def jax_stage2(blocks, w, padding="VALID", x=None):
    """``jax.lax.conv_general_dilated`` with stride 2 (NHWC, HWIO) on the
    interleaved X of the blocks (or on x), w [9, C, N] placed by
    ``TAP_POSITIONS``: [B, T, 16, N]."""
    import jax
    import jax.numpy as jnp

    if x is None:
        x = sp.interleave(*map(torch.from_numpy, blocks)).permute(
            0, 2, 3, 1).numpy()
    hwio = np.zeros((3, 3) + w.shape[1:], np.float32)
    for i, (kh, kw) in enumerate(sp.TAP_POSITIONS):
        hwio[kh, kw] = w[i]
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(hwio), window_strides=(2, 2),
        padding=padding, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST))


@pytest.mark.parametrize("b,tb", [(1, 2), (2, 5)])
def test_taps_with_copies_is_the_stride2_conv(b, tb):
    rng = np.random.default_rng(tb)
    blocks = fp32_blocks(rng, b, tb)
    w = rng.standard_normal((9, D, D)).astype(np.float32) / 24
    ref = jax_stage2(blocks, w)
    got = sp.taps_plain(*map(torch.from_numpy, blocks), torch.from_numpy(w),
                        sp.TAPS_WITH_COPIES).numpy()
    assert got.shape == ref.shape == (b, tb, 16, D)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_stage2_blocks_are_the_padded_stage2_conv():
    """The blocks of a stage-1 output x1, behind one zero row and column,
    give the conv with padding 1 that the subsampling's stage 2 runs."""
    rng = np.random.default_rng(3)
    x1 = rng.standard_normal((2, 10, 32, D)).astype(np.float32)   # NHWC
    w = rng.standard_normal((9, D, D)).astype(np.float32) / 24
    ref = jax_stage2(None, w, padding=((1, 1), (1, 1)), x=x1)
    blocks = sp.stage2_blocks(torch.from_numpy(x1).permute(0, 3, 1, 2))
    assert [tuple(x.shape) for x in blocks] == [
        (2, 5, 16, D), (2, 5, 17, D), (2, 6, 16, D), (2, 6, 17, D)]
    assert float(blocks[1][:, :, 0].abs().max()) == 0.0   # the pad column
    assert float(blocks[2][:, 0].abs().max()) == 0.0      # the pad row
    got = sp.taps_plain(*blocks, torch.from_numpy(w),
                        sp.TAPS_WITH_COPIES).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("fuse_linear", [False, True])
def test_im2col_is_the_stride2_conv(fuse_linear):
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    b, tb = 2, 3
    blocks = fp32_blocks(rng, b, tb)
    w = rng.standard_normal((9, D, D)).astype(np.float32) / 24
    wl = rng.standard_normal((16 * D, D)).astype(np.float32) / 32
    conv = jax_stage2(blocks, w)
    tblocks = list(map(torch.from_numpy, blocks))
    got = sp.im2col_plain(*tblocks, torch.from_numpy(w.reshape(9 * D, D)),
                          torch.from_numpy(wl) if fuse_linear else None)
    if fuse_linear:
        flat = np.maximum(conv, 0).reshape(b, tb, 16 * D)   # f-major
        ref = np.asarray(jnp.matmul(jnp.asarray(flat), jnp.asarray(wl),
                                    precision="highest"))
    else:
        ref = conv[:, :, 0]
        # the whole product is the conv: every frequency row
        patch = sp.patch_plain(*tblocks).numpy()
        np.testing.assert_allclose(
            patch @ w.reshape(9 * D, D), conv, rtol=0,
            atol=1e-5 * np.abs(conv).max())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("probe", ["taps_aligned", "taps_with_copies",
                                   "conv_channels_last", "im2col",
                                   "im2col_lin"])
def test_library_calls_compute_the_plain_function(probe):
    """Each stock call a kernel is timed against computes its function
    (fp32, CPU), in its own layout."""
    rng = np.random.default_rng(5)
    blocks = [torch.from_numpy(x) for x in fp32_blocks(rng, 2, 3)]
    w = torch.from_numpy(rng.standard_normal((9, D, D)).astype(np.float32))
    wl = torch.from_numpy(rng.standard_normal((16 * D, D)).astype(np.float32))
    if probe == "conv_channels_last":
        want = sp.taps_plain(*blocks, w, sp.TAPS_WITH_COPIES)
        fn, args = sp.conv_cl_library(*blocks, w)
        assert all(a.is_contiguous(memory_format=torch.channels_last)
                   for a in args)
        got = fn(*args).permute(0, 2, 3, 1)
    elif probe.startswith("taps"):
        with_copies = probe == "taps_with_copies"
        if not with_copies:
            blocks[1], blocks[3] = blocks[1][:, :, :16], blocks[3][:, :, :16]
        want = sp.taps_plain(*blocks, w, sp.TAPS[with_copies])
        fn, args = sp.taps_library(*blocks, w, with_copies)
        got = fn(*args)
        got = (got.permute(0, 2, 3, 1) if with_copies
               else got.reshape(want.shape))
    else:
        lin = wl if probe == "im2col_lin" else None
        want = sp.im2col_plain(*blocks, w.reshape(9 * D, D), lin)
        fn, args = sp.im2col_library(*blocks, w.reshape(9 * D, D), lin)
        got = fn(*args)
        if lin is None:
            got = got.permute(0, 2, 3, 1)[:, :, 0]
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_interleave_and_parity_blocks_are_inverse():
    rng = np.random.default_rng(2)
    blocks = [torch.from_numpy(x) for x in fp32_blocks(rng, 2, 4)]
    x = sp.interleave(*blocks)
    assert x.shape == (2, D, 9, 33)
    assert x.is_contiguous(memory_format=torch.channels_last)
    for got, want in zip(sp.parity_blocks(x), blocks):
        assert torch.equal(got, want)
    w = torch.from_numpy(rng.standard_normal((9, D, 32)).astype(np.float32))
    w4 = sp.conv_weight(w)
    assert w4.shape == (32, D, 3, 3)
    assert torch.equal(w4[:, :, 1, 2], w[2].t())


# ---------------------------------------------------------------------------
# The runner against the script
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("probe", ["taps_aligned", "taps_with_copies",
                                   "im2col"])
def test_runner_draws_the_scripts_inputs(narrow, probe):
    if probe == "im2col":
        narrow.probe_im2col(3, True)
        drawn = sp.im2col_inputs(3)
    else:
        with_copies = probe == "taps_with_copies"
        narrow.probe_taps(3, with_copies, interpret=True)
        drawn = sp.taps_inputs(3, with_copies)
    (args, _), = narrow.calls
    assert len(drawn) == len(args)
    for mine, theirs in zip(drawn, args):
        assert np.array_equal(bf16_values(mine), np32(theirs))


def test_main_runs_the_scripts_probes_and_keys(script, monkeypatch, capsys):
    """Both mains, their probes replaced by stubs that record the call: the
    same probes in the same order, under the same keys."""
    def calls_of(mod, *args):
        calls = []

        def stub(name):
            sig = inspect.signature(getattr(mod, name))

            def probe(*a, **kw):
                bound = sig.bind(*a, **kw)
                bound.apply_defaults()
                calls.append((name, tuple(
                    v for k, v in bound.arguments.items()
                    if k in ("tb", "with_copies", "fuse_linear"))))
                return {"us": 1.0}
            return probe

        for name in ("probe_taps", "probe_im2col", "probe_vmem"):
            monkeypatch.setattr(mod, name, stub(name))
        capsys.readouterr()
        mod.main(*args)
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        return calls, printed

    port_calls, port_printed = calls_of(sp, "cpu")
    calls, printed = calls_of(script)
    assert list(port_printed) == list(printed)
    assert port_calls == calls and len(calls) == 11


def test_probes_report_the_scripts_keys(narrow, monkeypatch):
    """The port's probes at the test width on the CPU, the timer stubbed:
    every key the script reports, and the library call beside it."""
    monkeypatch.setattr(sp, "device_timeit",
                        lambda fn, args, **kw: (fn(*args), 2e-6)[1])
    want = narrow.probe_im2col(2, True)
    got = sp.probe_im2col(2, True, device="cpu")
    assert set(want) <= set(got)
    assert set(got) == {"us", "tflops", "library_us", "delta_pct"}
    assert got["us"] == 2.0 and got["delta_pct"] == 0.0
    got = sp.probe_taps(2, False, device="cpu")
    assert got["tflops"] == round(9 * 2 * 32 * D * D / 2e-6 / 1e12, 1)


def test_vmem_ladder_records_only_the_refusal(monkeypatch):
    ceiling = 200 * 1024

    def refusing(x, n_bytes):
        if n_bytes > ceiling:
            raise sp.SharedMemoryRefused(n_bytes, 1)
        return x * 2, 1 + n_bytes // (64 * 1024)

    monkeypatch.setattr(sp, "smem_copy", refusing)
    res = sp.probe_vmem(device="cpu")
    assert res["max_scratch_bytes"] == 192 * 1024
    assert res["max_scratch_mb"] == 192 * 1024 / 2 ** 20
    assert res["fail_at_mb"] == 224 * 1024 / 2 ** 20
    assert "refused" in res["err"]
    assert list(res["blocks_per_sm"]) == ["16", "32", "64", "96", "128",
                                          "160", "192"]
    assert res["blocks_per_sm"]["128"] == 3


def test_vmem_ladder_raises_on_any_other_error(monkeypatch):
    def failing(x, n_bytes):
        if n_bytes >= 64 * 1024:
            raise RuntimeError("gigaam_smem_probe: CUDA launch failed")
        return x * 2, 1

    monkeypatch.setattr(sp, "smem_copy", failing)
    with pytest.raises(RuntimeError, match="launch failed"):
        sp.probe_vmem(device="cpu")


# ---------------------------------------------------------------------------
# The wrappers' CPU path, the card path's checks, the grid plans
# ---------------------------------------------------------------------------

def full_width_blocks(b=2, tb=5, fe=17, dtype=torch.bfloat16):
    z = lambda t, f: torch.zeros(b, t, f, sp.D, dtype=dtype)
    return [z(tb, 16), z(tb, fe), z(tb + 1, 16), z(tb + 1, fe)]


def test_wrappers_on_the_cpu_take_the_plain_version_and_count_no_launches():
    rng = np.random.default_rng(4)
    sp.reset_launch_counts()
    blocks = [torch.from_numpy(x).to(torch.bfloat16)
              for x in fp32_blocks(rng, 1, 2, c=sp.D)]
    w = torch.from_numpy(0.02 * rng.standard_normal((9, sp.D, sp.D))).to(
        torch.bfloat16)
    assert torch.equal(sp.taps_product(*blocks, w, sp.TAPS_WITH_COPIES),
                       sp.taps_plain(*blocks, w, sp.TAPS_WITH_COPIES))
    w2 = w.reshape(9 * sp.D, sp.D)
    assert torch.equal(sp.im2col_product(*blocks, w2),
                       sp.im2col_plain(*blocks, w2))
    x = torch.ones(8, 1024, dtype=torch.bfloat16)
    assert torch.equal(sp.smem_copy(x, 32768)[0], x * 2)
    assert [fn.launches for fn in sp.KERNELS] == [0, 0, 0]


def test_card_path_checks_reject_what_the_kernels_do_not_take():
    """The launch path validates before it touches the card."""
    ee, eo, oe, oo = full_width_blocks()
    sp._check_blocks(ee, eo, oe, oo, sp.TAPS_WITH_COPIES)
    sp._check_blocks(ee, eo[:, :, :16].contiguous(), oe,
                     oo[:, :, :16].contiguous(), sp.TAPS_ALIGNED)
    with pytest.raises(ValueError, match="ee is torch.float32"):
        sp._check_blocks(ee.float(), eo, oe, oo, sp.TAPS_WITH_COPIES)
    with pytest.raises(ValueError, match=r"ee must be \[B, T, 16, 768\]"):
        sp._check_blocks(ee[..., :64], eo, oe, oo, sp.TAPS_WITH_COPIES)
    with pytest.raises(ValueError, match="oe has shape"):
        sp._check_blocks(ee, eo, oe[:, :5], oo, sp.TAPS_WITH_COPIES)
    with pytest.raises(ValueError, match="eo must be"):
        sp._check_blocks(ee, eo[:, :, :15], oe, oo, sp.TAPS_WITH_COPIES)
    with pytest.raises(ValueError, match="oo must be contiguous"):
        sp._check_blocks(ee, eo, oe, oo.transpose(0, 1).contiguous()
                         .transpose(0, 1), sp.TAPS_WITH_COPIES)
    # the misaligned taps need 17 frequency rows in eo and oo
    with pytest.raises(ValueError, match="reads past its block"):
        sp._check_blocks(ee, eo[:, :, :16].contiguous(), oe,
                         oo[:, :, :16].contiguous(), sp.TAPS_WITH_COPIES)
    # ee has T rows: no tap reads it at t + 1
    with pytest.raises(ValueError, match="tap 0 .* reads past"):
        sp._check_blocks(ee, eo, oe, oo, ((0, 1, 0),) + sp.TAPS_ALIGNED[1:])
    with pytest.raises(ValueError, match="nine taps"):
        sp._check_blocks(ee, eo, oe, oo, sp.TAPS_ALIGNED[:8])


def test_split_plan_fills_the_card():
    """At the script's shapes (24-96 tiles of 128 x 128) and for the
    linear's few rows, K splits until every SM has a block; the main path's
    stage 2 (6048 tiles) and its linear (378) do not split."""
    sms, taps_k, lin_k = 132, 9 * 768 // 64, 16 * 768 // 64
    assert [sp.split_plan(6 * tb // 8, taps_k, sms)
            for tb in (32, 64, 128)] == [6, 3, 2]
    assert sp.split_plan(6, lin_k, sms) == 22          # T 64 and 128
    assert sp.split_plan(6 * 16 * 63, taps_k, sms) == 1
    assert sp.split_plan(6 * 63, lin_k, sms) == 1
    assert sp.split_plan(1, 2, sms) == 2               # one K tile a block


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version, bf16
# ---------------------------------------------------------------------------

GPU_REL, GPU_RTOL = 0.1, 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest "
                    "--noconftest -m gpu tests/test_torch_subsampling_probe.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_blocks(b, tb, fe, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(b, t, f, sp.D, generator=gen, device=dev,
                        dtype=torch.bfloat16)
            for t, f in ((tb, 16), (tb, fe), (tb + 1, 16), (tb + 1, fe))]


def assert_kernel_close(got, ref):
    got, ref = got.float(), ref.float()
    rms = float(ref.pow(2).mean().sqrt())
    err = (got - ref).abs()
    assert float((err - GPU_RTOL * ref.abs()).max()) <= GPU_REL * rms


@pytest.mark.gpu
@pytest.mark.parametrize("b,tb", [(1, 32), (3, 13), (16, 500)])
@pytest.mark.parametrize("with_copies", [True, False])
def test_cuda_taps_matches_plain(cuda, b, tb, with_copies):
    blocks = card_blocks(b, tb, 17 if with_copies else 16, cuda)
    w = 0.02 * torch.randn(9, sp.D, sp.D, device=cuda).to(torch.bfloat16)
    taps = sp.TAPS[with_copies]
    before = sp.taps_product.launches
    got = sp.taps_product(*blocks, w, taps)
    assert sp.taps_product.launches == before + 1
    assert_kernel_close(got, sp.taps_plain(*blocks, w, taps))
    assert torch.equal(sp.taps_product(*blocks, w, taps), got)


@pytest.mark.gpu
@pytest.mark.parametrize("b,tb", [(1, 64), (2, 13), (16, 500)])
@pytest.mark.parametrize("fuse_linear", [False, True])
def test_cuda_im2col_matches_plain(cuda, b, tb, fuse_linear):
    blocks = card_blocks(b, tb, 17, cuda, seed=1)
    w = 0.02 * torch.randn(9 * sp.D, sp.D, device=cuda).to(torch.bfloat16)
    wl = (0.02 * torch.randn(16 * sp.D, sp.D, device=cuda).to(torch.bfloat16)
          if fuse_linear else None)
    got = sp.im2col_product(*blocks, w, wl)
    assert got.shape == (b, tb, sp.D)
    assert_kernel_close(got, sp.im2col_plain(*blocks, w, wl))


@pytest.mark.gpu
def test_cuda_smem_ceiling_is_the_optin_limit(cuda):
    res = sp.probe_vmem()
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    assert res["max_scratch_bytes"] == limit
    assert res["fail_at_mb"] * 2 ** 20 > limit
    x = torch.randn(8, 1024, device=cuda).to(torch.bfloat16)
    out, blocks = sp.smem_copy(x, limit)
    assert torch.equal(out, x * 2) and blocks == 1


@pytest.mark.gpu
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    ee, eo, oe, oo = card_blocks(2, 8, 17, cuda)
    w = torch.zeros(9, sp.D, sp.D, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="w has shape"):
        sp.taps_product(ee, eo, oe, oo, w[:8], sp.TAPS_WITH_COPIES)
    with pytest.raises(ValueError, match="eo is torch.float32"):
        sp.im2col_product(ee, eo.float(), oe, oo, w.reshape(-1, sp.D))
    with pytest.raises(ValueError, match="multiple of 16"):
        sp.smem_copy(ee.reshape(-1)[:8192].reshape(8, 1024), 20008)
