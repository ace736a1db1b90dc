"""The SDPA ablation probes (``gigaam_tpu_torch/probes/sdpa_ablation.py``)
and the port's ``device_timeit`` (``gigaam_tpu_torch/profiling.py``).

On the CPU each kernel wrapper runs its plain version, which is held against
the Pallas body of ``benchmarks/sdpa_ablation.py`` that it replaces, run in
interpret mode inside a ``pallas_call`` that this file builds with the
script's index maps and one query block covering T (the script's runners
time at its own fixed shape).  Both sides take the same bf16 inputs.  On
the valid query rows the outputs agree within one bf16 step, but for rare
values (1% at most) that are off by one bf16 step of a term of the sum over
keys.  Both round the same math to bf16 at the same points, but their
exponentials and fp32 sums differ in the last bit.  That moves a rounded
output by at most one step, and now and then rounds a value of P (of S for
``B_two_matmuls``) to its other bf16 neighbour, which moves the output by
up to 2^-8 of that key's term P v (S v).  The output's step is taken at the
larger of the two values, and at no less than 2^-16 x the output's RMS,
where fp32's own rounding of the sums would exceed the step of a value that
cancelled to near zero.

The tests marked ``gpu`` hold each CUDA kernel against its plain version on
the card in bf16, within a tenth of the output's RMS plus one bf16 rounding
of the value, as ``chip_smoke.py`` holds the kernels; they skip without one
(on the card: ``pytest --noconftest -m gpu tests/test_torch_probes.py``).
"""

import functools
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from gigaam_tpu_torch.ops import fused_attention as fa
from gigaam_tpu_torch.probes import sdpa_ablation as sa
from gigaam_tpu_torch.profiling import device_timeit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 48

# label -> (Pallas body, grid layout, the mask as an fp32 madd row); the
# layouts are those of the script's runners: "run", "allheads" (with the
# heads a cell), "identity" (the mask per cell), "packed"
LABELS = {
    "A_full": ("k_full", "run", False),
    "F_copy_only": ("k_copy", "run", False),
    "B_two_matmuls": ("k_scores_only", "run", False),
    "D_no_max_pass": ("k_no_max", "run", False),
    "E_prescaled_q": ("k_prescaled", "run", False),
    "E2_madd_row": ("k_maddrow", "run", True),
    "G_bf16_softmax": ("k_bf16_softmax", "run", True),
    "I_allheads_cell": ("k_allheads", "allheads", False),
    "J_4heads_cell": ("k_allheads", "allheads", False),
    "K_identity_maps": ("k_full", "identity", False),
    "H_packed_lane_slice": ("k_full_packed", "packed", False),
}
WRAPPERS = {
    "A_full": sa.full_sdpa, "F_copy_only": sa.copy_sdpa,
    "B_two_matmuls": sa.scores_only_sdpa, "D_no_max_pass": sa.no_max_sdpa,
    "E_prescaled_q": sa.prescaled_sdpa, "E2_madd_row": sa.maddrow_sdpa,
    "G_bf16_softmax": sa.bf16_softmax_sdpa,
}


def heads_per_cell(label, h):
    """I: every head in one cell; J: a group of fewer heads than H (4 of
    the script's 16; half of the tests' H)."""
    return h if label == "I_allheads_cell" else h // 2


@pytest.fixture(scope="module")
def script():
    """``benchmarks/sdpa_ablation.py``, imported from its file."""
    path = os.path.join(REPO, "benchmarks", "sdpa_ablation.py")
    spec = importlib.util.spec_from_file_location("sdpa_ablation_script", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(b, h, tt, seed, qk_gain=1.0):
    """q, k, v [B*H, T, 48] float32 (bf16-representable), valid [B, T] with
    the second batch element ragged, mask [B, 1, T] int8, madd fp32."""
    rng = np.random.default_rng(seed)
    q, k, v = (np.asarray(torch.from_numpy(
        rng.standard_normal((b * h, tt, D)).astype(np.float32) * g)
        .to(torch.bfloat16).float()) for g in (qk_gain, qk_gain, 1.0))
    valid = np.ones((b, tt), bool)
    valid[1, 2 * tt // 3:] = False
    mask = valid.astype(np.int8)[:, None]
    madd = (mask.astype(np.float32) - 1.0) * 1e9
    return q, k, v, valid, mask, madd


def pallas_out(script, label, q, k, v, mask, madd, b, h, tt):
    """The label's Pallas body on the script's grid, in interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    body, layout, use_madd = LABELS[label]
    kw = {"scale": 1.0 / math.sqrt(D)}
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    m = jnp.asarray(madd) if use_madd else jnp.asarray(mask)
    qkv = (bf(q), bf(k), bf(v))
    spec_q = pl.BlockSpec((1, tt, D), lambda i, j: (i, j, 0))
    spec_kv = pl.BlockSpec((1, tt, D), lambda i, j: (i, 0, 0))
    out_shape = (b * h, tt, D)
    if layout == "run":
        grid = (b * h, 1)
        specs = [spec_q, spec_kv, spec_kv,
                 pl.BlockSpec((1, 1, tt), lambda i, j: (i // h, 0, 0))]
    elif layout == "identity":
        grid = (b * h, 1)
        m = jnp.broadcast_to(m[:, None], (b, h, 1, tt)).reshape(b * h, 1, tt)
        specs = [spec_q, spec_kv, spec_kv,
                 pl.BlockSpec((1, 1, tt), lambda i, j: (i, 0, 0))]
    elif layout == "allheads":
        hc = heads_per_cell(label, h)
        kw["n_heads"] = hc
        grid = (b, h // hc)
        spec = pl.BlockSpec((1, hc, tt, D), lambda i, j: (i, j, 0, 0))
        specs = [spec] * 3 + [pl.BlockSpec((1, 1, tt), lambda i, j: (i, 0, 0))]
        spec_q = spec
        qkv = tuple(x.reshape(b, h, tt, D) for x in qkv)
        out_shape = (b, h, tt, D)
    else:   # packed: head h of cell i is the lane block i % H of [B, T, H*48]
        grid = (b * h, 1)
        spec_q = pl.BlockSpec((1, tt, D), lambda i, j: (i // h, j, i % h))
        spec_kv = pl.BlockSpec((1, tt, D), lambda i, j: (i // h, 0, i % h))
        specs = [spec_q, spec_kv, spec_kv,
                 pl.BlockSpec((1, 1, tt), lambda i, j: (i // h, 0, 0))]
        qkv = tuple(x.reshape(b, h, tt, D).transpose(0, 2, 1, 3)
                    .reshape(b, tt, h * D) for x in qkv)
        out_shape = (b, tt, h * D)
    fn = pl.pallas_call(
        functools.partial(getattr(script, body), **kw),
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.bfloat16), grid=grid,
        in_specs=specs, out_specs=spec_q, interpret=True)
    return np.asarray(fn(*qkv, m).astype(jnp.float32))


def port_out(label, q, k, v, mask, madd, b, h, tt, dev="cpu"):
    """The label's wrapper on the label's layout (its plain version on CPU
    tensors, its kernel on CUDA ones), as float32 numpy."""
    bf = lambda a: torch.from_numpy(a).to(dev, torch.bfloat16)
    tq, tk, tv = bf(q), bf(k), bf(v)
    tmask = torch.from_numpy(mask).to(dev)
    layout = LABELS[label][1]
    if layout == "run":
        m = torch.from_numpy(madd).to(dev) if LABELS[label][2] else tmask
        out = WRAPPERS[label](tq, tk, tv, m)
    elif layout == "identity":
        out = sa.identity_maps_sdpa(tq, tk, tv,
                                    tmask.repeat_interleave(h, dim=0))
    elif layout == "allheads":
        out = sa.allheads_sdpa(*(x.reshape(b, h, tt, D) for x in (tq, tk, tv)),
                               tmask, heads_per_cell(label, h))
    else:
        out = sa.packed_sdpa(*(x.reshape(b, h, tt, D).transpose(1, 2)
                               .reshape(b, tt, h * D) for x in (tq, tk, tv)),
                             tmask)
    return out.float().cpu().numpy()


def valid_rows(x, label, valid, b, h, tt):
    """The rows of valid queries, [n, 48]."""
    if LABELS[label][1] == "packed":
        x = x.reshape(b, tt, h, D).transpose(0, 2, 1, 3)
    x = x.reshape(b, h, tt, D)
    return np.moveaxis(x, 2, 1)[valid]


def term_step(label, q, k, v):
    """One bf16 step (2^-8) of the largest term of an output's sum over
    keys: P v with P <= 1, or S v for the unscaled, unnormalised S of
    ``B_two_matmuls``; none for the copy."""
    if label == "F_copy_only":
        return 0.0
    largest = np.abs(v).max()
    if label == "B_two_matmuls":
        largest *= np.abs(q @ k.swapaxes(-1, -2)).max()
    return 2.0 ** -8 * largest


@pytest.mark.parametrize("tt", [64, 70])
@pytest.mark.parametrize("label", list(LABELS))
def test_plain_matches_pallas_body(script, label, tt):
    b, h = 2, 4
    q, k, v, valid, mask, madd = inputs(b, h, tt, seed=tt)
    ref = valid_rows(pallas_out(script, label, q, k, v, mask, madd, b, h, tt),
                     label, valid, b, h, tt)
    got = valid_rows(port_out(label, q, k, v, mask, madd, b, h, tt),
                     label, valid, b, h, tt)
    rms = np.sqrt(np.mean(ref ** 2))
    larger = np.maximum(np.maximum(np.abs(got), np.abs(ref)), 2.0 ** -16 * rms)
    step = 2.0 ** (np.floor(np.log2(larger)) - 7)
    err = np.abs(got - ref)
    assert np.all(err <= step + term_step(label, q, k, v)), (
        f"{label}: {np.max(err / step)} bf16 steps")
    assert np.mean(err > step) <= 0.01, (
        f"{label}: {np.mean(err > step)} of the values over one bf16 step")


def test_wrappers_on_the_cpu_count_no_launches():
    q, k, v, valid, mask, madd = inputs(2, 4, 16, seed=1)
    sa.reset_launch_counts()
    for label in LABELS:
        port_out(label, q, k, v, mask, madd, 2, 4, 16)
    assert [fn.launches for fn in sa.KERNELS] == [0] * len(sa.KERNELS)


def test_cuda_path_checks_reject_what_the_kernels_do_not_take():
    """The launch path validates before it touches the card."""
    cpu = torch.device("cpu")
    q = torch.zeros(8, 16, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mask is torch.float32"):
        sa._check_mask(torch.zeros(2, 1, 16), cpu, False, (2, 1, 16))
    with pytest.raises(ValueError, match="mask is torch.bool"):
        sa._check_mask(torch.ones(2, 1, 16, dtype=torch.bool), cpu, False,
                       (2, 1, 16))
    with pytest.raises(ValueError, match="madd is torch.int8"):
        sa._check_mask(torch.zeros(2, 1, 16, dtype=torch.int8), cpu, True,
                       (2, 1, 16))
    with pytest.raises(ValueError, match="mask has shape"):
        sa._check_mask(torch.zeros(2, 16, dtype=torch.int8), cpu, False,
                       (2, 1, 16))
    with pytest.raises(ValueError, match="k is torch.float32"):
        sa._check_qkv(q, q.float(), q, (8, 16, D))
    with pytest.raises(ValueError, match="v has shape"):
        sa._check_qkv(q, q, q[:, :8], (8, 16, D))


def test_device_timeit_chains_outputs_into_the_next_call():
    seen = []

    def fn(x, step):
        seen.append(float(x[0]))
        return x + step, "ignored"

    x0 = torch.zeros(3, dtype=torch.float64)
    secs = device_timeit(fn, [x0, torch.ones(3, dtype=torch.float64)],
                         k=4, windows=2, reps=3, chain=True)
    assert secs > 0
    # one untimed run, then windows x reps runs, each of k calls starting
    # again from args[perturb_arg] and taking the last output in between
    assert seen == [0.0, 1.0, 2.0, 3.0] * (1 + 2 * 3)


def test_device_timeit_without_chain_repeats_the_same_call():
    seen = []

    def fn(scale, x):
        seen.append(float(x.sum()))
        return (x * scale).to(torch.float16)

    secs = device_timeit(fn, [2.0, torch.ones(4)], perturb_arg=1, k=3,
                         windows=1, reps=2)
    assert secs > 0 and seen == [4.0] * (3 * 3)


def test_device_timeit_casts_a_chained_output_to_the_inputs_dtype():
    dtypes = []

    def fn(x):
        dtypes.append(x.dtype)
        return x.to(torch.float64) * 2

    device_timeit(fn, [torch.ones(2, dtype=torch.bfloat16)], k=2, windows=1,
                  reps=1, chain=True)
    assert dtypes == [torch.bfloat16] * 4


@pytest.mark.parametrize("fullset,packed", [(False, False), (True, True),
                                            (True, False), (False, True)])
def test_main_prints_the_scripts_labels(script, monkeypatch, capsys, fullset,
                                        packed):
    """Both mains, with their runners replaced by stubs that record the
    label, under each setting of the two switches: the same labels in the
    same order, the port's from the same runner as the script's."""
    for name, on in (("SDPA_ABLATION_FULLSET", fullset),
                     ("SDPA_ABLATION_PACKED", packed)):
        if on:
            monkeypatch.setenv(name, "1")
        else:
            monkeypatch.delenv(name, raising=False)

    def labels_of(mod, device=None):
        calls = []
        for runner in ("run", "run_allheads", "run_identity_maps",
                       "run_packed"):
            def stub(*args, _runner=runner, **kwargs):
                label, results = args[-2:] if _runner != "run" else args[5:7]
                calls.append((_runner, label))
                results[label] = 0.0
            monkeypatch.setattr(mod, runner, stub)
        capsys.readouterr()
        mod.main() if device is None else mod.main(device)
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert list(printed) == [label for _, label in calls]
        return calls

    want = labels_of(script)
    assert labels_of(sa, "cpu") == want
    assert len(want) == 5 + 5 * fullset + packed


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version, bf16
# ---------------------------------------------------------------------------

GPU_REL, GPU_RTOL, QK_GAIN = 0.1, 2.0 ** -7, 1.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest --noconftest -m gpu tests/test_torch_probes.py)")
    return torch.device("cuda")


def plain_out(label, q, k, v, mask, madd, b, h, tt, dev):
    """The plain version of the label's body on the card's inputs."""
    bf = lambda a: torch.from_numpy(a).to(dev, torch.bfloat16)
    tq, tk, tv = bf(q), bf(k), bf(v)
    tmask = torch.from_numpy(mask).to(dev)
    body, layout, use_madd = LABELS[label]
    plain = {"k_full": sa.full_plain, "k_copy": sa.copy_plain,
             "k_scores_only": sa.scores_only_plain,
             "k_no_max": sa.no_max_plain, "k_prescaled": sa.prescaled_plain,
             "k_maddrow": sa.maddrow_plain,
             "k_bf16_softmax": sa.bf16_softmax_plain}
    if layout in ("run", "identity"):
        m = torch.from_numpy(madd).to(dev) if use_madd else tmask
        out = plain[body](tq, tk, tv, m.repeat_interleave(h, dim=0))
    elif layout == "allheads":
        out = sa.allheads_plain(*(x.reshape(b, h, tt, D) for x in (tq, tk, tv)),
                                tmask)
    else:
        out = sa.full_packed_plain(*(x.reshape(b, h, tt, D).transpose(1, 2)
                                     .reshape(b, tt, h * D)
                                     for x in (tq, tk, tv)), tmask)
    return out.float().cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("tt", [64, 65, 129, 501])
@pytest.mark.parametrize("label", list(LABELS))
def test_cuda_kernel_matches_plain(cuda, label, tt):
    b, h = 2, 16
    q, k, v, valid, mask, madd = inputs(b, h, tt, seed=tt, qk_gain=QK_GAIN)
    launches = [fn.launches for fn in sa.KERNELS]
    got = port_out(label, q, k, v, mask, madd, b, h, tt, cuda)
    assert sum(fn.launches for fn in sa.KERNELS) == sum(launches) + 1
    ref = plain_out(label, q, k, v, mask, madd, b, h, tt, cuda)
    got, ref = (valid_rows(x, label, valid, b, h, tt) for x in (got, ref))
    rms = np.sqrt(np.mean(ref ** 2))
    np.testing.assert_array_less(np.abs(got - ref),
                                 GPU_REL * rms + GPU_RTOL * np.abs(ref) + 1e-30)
    again = port_out(label, q, k, v, mask, madd, b, h, tt, cuda)
    assert np.array_equal(valid_rows(again, label, valid, b, h, tt), got)


@pytest.mark.gpu
@pytest.mark.parametrize("tt", [64, 501])
def test_cuda_full_variant_is_k3(cuda, tt):
    """A_full runs K3's body: the same bits as ``fused_mha``."""
    b, h = 2, 16
    q, k, v, valid, mask, madd = inputs(b, h, tt, seed=tt, qk_gain=QK_GAIN)
    got = port_out("A_full", q, k, v, mask, madd, b, h, tt, cuda)
    bf = lambda a: torch.from_numpy(a).to(cuda, torch.bfloat16).reshape(
        b, h, tt, D)
    k3 = fa.fused_mha(bf(q), bf(k), bf(v), torch.from_numpy(valid).to(cuda))
    assert np.array_equal(got.reshape(b, h, tt, D), k3.float().cpu().numpy())


@pytest.mark.gpu
def test_cuda_entry_refuses_a_group_that_does_not_divide_the_heads(cuda):
    x = torch.zeros(1, 16, 64, D, dtype=torch.bfloat16, device=cuda)
    mask = torch.ones(1, 1, 64, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="does not divide"):
        sa.allheads_sdpa(x, x, x, mask, heads_per_block=3)
    with pytest.raises(RuntimeError, match="gigaam_sdpa_ablation"):
        sa._launch(sa._COPY, sa._PACKED, x, x, x, mask, 1, 16, 64)


@pytest.mark.gpu
def test_cuda_device_timeit_replays_a_captured_chain(cuda):
    """On the card the k calls are made twice, eagerly and into a CUDA
    graph, whose replays are then timed without calling ``fn`` again."""
    calls = []

    def fn(x):
        calls.append(x.device.type)
        return x * 0.5 + 1.0

    secs = device_timeit(fn, [torch.zeros(1024, device=cuda)], k=5,
                         windows=2, reps=3, chain=True)
    assert secs > 0 and calls == ["cuda"] * (2 * 5)
