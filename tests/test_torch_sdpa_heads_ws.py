"""The per-head walk of the SDPA ablation (P12's six computing bodies and
P10) on its warp-specialised redesign (``csrc/sdpa_heads_ws.cu``, driven by
``gigaam_tpu_torch/probes/sdpa_ablation.py``); P12's copy keeps its kernel.

On the CPU the plan that the wrappers hand the kernel (``heads_plan``, a
pure function) is held to what the kernel reads of it, decoded as the kernel
decodes it: every (head, query tile) in exactly one unit's consumer, the
units of a head side by side, one block an SM or one a unit, runs of
lengths that differ by one at most, over B 1-16, T 1-800 and cards of 132
and 114 SMs.  The eight wrappers take their plain versions for CPU
tensors (bit for bit, no launch counted), and those match the Pallas bodies of
``benchmarks/sdpa_ablation.py`` in interpret mode at B 2, H 4, T 64 and 70,
within ``tests/test_torch_probes.py``'s limit (one bf16 step of the value
plus one of a term of the sum over keys; that file says why).

The tests marked ``gpu`` hold each redesigned body and P10 against its
plain version on the card in bf16 with ragged masks, within a tenth of the
output's RMS plus one bf16 rounding of the value (``chip_smoke.py``'s
limit), bit for bit against its kept kernel (``A_full`` also against K3's
``fused_mha``) and against itself under other plans, and check that the C
entry refuses what it does not take without a launch; they skip without a
card (on the card: ``pytest --noconftest -m gpu
tests/test_torch_sdpa_heads_ws.py``).
"""

import ctypes
import math
import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from gigaam_tpu_torch.ops import cuda_lib
from gigaam_tpu_torch.ops import fused_attention as fa
from gigaam_tpu_torch.probes import sdpa_ablation as sa
from test_torch_probes import (inputs, pallas_out, port_out, script,  # noqa: F401
                               term_step, valid_rows)

H = sa.H
D = sa.D
CARDS = [132, 114]
# label -> its wrapper
WRAPPERS = {
    "A_full": sa.full_sdpa, "F_copy_only": sa.copy_sdpa,
    "B_two_matmuls": sa.scores_only_sdpa,
    "D_no_max_pass": sa.no_max_sdpa, "E_prescaled_q": sa.prescaled_sdpa,
    "E2_madd_row": sa.maddrow_sdpa, "G_bf16_softmax": sa.bf16_softmax_sdpa,
    "K_identity_maps": sa.identity_maps_sdpa,
}
# those on the walk on the card: all but the copy
REDESIGNED = {label: fn for label, fn in WRAPPERS.items()
              if label != "F_copy_only"}
# label -> its plain version, the mask given per head
PLAIN = {"A_full": sa.full_plain, "F_copy_only": sa.copy_plain,
         "B_two_matmuls": sa.scores_only_plain,
         "D_no_max_pass": sa.no_max_plain, "E_prescaled_q": sa.prescaled_plain,
         "E2_madd_row": sa.maddrow_plain,
         "G_bf16_softmax": sa.bf16_softmax_plain,
         "K_identity_maps": sa.full_plain}


def walked_tiles(plan, n_bh, t):
    """The (head, query tile) each consumer of each unit walks, in the
    blocks' order, decoded as ``sdpa_heads_ws_kernel`` decodes the plan:
    unit u is head u // pairs and query tiles 2 (u % pairs) + c, c = 0, 1,
    of which a tile past T is walked by no one."""
    q_tiles = math.ceil(t / 64)
    pairs = math.ceil(q_tiles / 2)
    out = []
    for first, count in plan:
        for u in range(first, first + count):
            bh, pair = divmod(int(u), pairs)
            assert bh < n_bh
            out += [(bh, 2 * pair + c) for c in (0, 1)
                    if 2 * pair + c < q_tiles]
    return out


def check_plan(b, t, sms):
    n_bh = b * H
    plan = sa.heads_plan(n_bh, t, sms)
    pairs = math.ceil(math.ceil(t / 64) / 2)
    assert plan.dtype == np.int32 and plan.shape == (min(n_bh * pairs, sms),
                                                     2)
    first, count = plan[:, 0], plan[:, 1]
    assert count.min() >= 1 and count.max() - count.min() <= 1
    # the runs follow one another: unit u is walked once, and a head's
    # units are neighbours in the blocks' order
    assert (first == np.concatenate([[0], np.cumsum(count)[:-1]])).all()
    assert count.sum() == n_bh * pairs
    tiles = walked_tiles(plan, n_bh, t)
    assert sorted(tiles) == [(bh, qt) for bh in range(n_bh)
                             for qt in range(math.ceil(t / 64))]
    assert all(a[0] <= b[0] for a, b in zip(tiles, tiles[1:]))


@pytest.mark.parametrize("sms", CARDS)
@pytest.mark.parametrize("t", [1, 7, 63, 64, 65, 127, 128, 129, 500, 501,
                               800])
@pytest.mark.parametrize("b", [1, 3, 8, 16])
def test_plan_covers_every_head_and_query_tile_once(b, t, sms):
    check_plan(b, t, sms)


@settings(max_examples=60, deadline=None)
@given(b=st.integers(1, 16), t=st.integers(1, 800),
       sms=st.sampled_from(CARDS))
def test_plan_covers_every_head_and_query_tile_once_drawn(b, t, sms):
    check_plan(b, t, sms)


def test_plan_of_the_ablation_shapes():
    """4 units a head at T' 500-501 (8 query tiles): 512 units at B 8, 1024
    at B 16, over every SM of a 132-SM card, no run longer than the
    average rounded up."""
    for b, t, runs in ((8, 501, 4), (16, 500, 8)):
        plan = sa.heads_plan(b * H, t, 132)
        assert len(plan) == 132 and plan[:, 1].sum() == 4 * b * H
        assert plan[:, 1].max() == runs


def test_cpu_wrappers_take_the_plain_versions():
    q, k, v, valid, mask, madd = inputs(2, 4, 70, seed=5)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    tq, tk, tv = bf(q), bf(k), bf(v)
    tmask, tmadd = torch.from_numpy(mask), torch.from_numpy(madd)
    sa.reset_launch_counts()
    for label, wrapper in WRAPPERS.items():
        m = tmadd if label in ("E2_madd_row", "G_bf16_softmax") else tmask
        per_head = m.repeat_interleave(4, dim=0)
        got = wrapper(tq, tk, tv, per_head if label == "K_identity_maps"
                      else m)
        assert torch.equal(got, PLAIN[label](tq, tk, tv, per_head)), label
    assert [fn.launches for fn in sa.KERNELS] == [0] * len(sa.KERNELS)


@pytest.mark.parametrize("tt", [64, 70])
@pytest.mark.parametrize("label", list(WRAPPERS))
def test_cpu_wrapper_matches_the_pallas_body(script, label, tt):  # noqa: F811
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
    assert np.mean(err > step) <= 0.01


def test_the_library_is_registered_for_its_launches():
    """Each entry point is in its source with the argument count that
    ``cuda_lib`` declares, the kernels that ``dynamic_resources`` names are
    the source's instances, and every redesigned wrapper has its variant."""
    with open(os.path.join(cuda_lib.CSRC_DIR, "sdpa_heads_ws.cu")) as f:
        text = f.read()
    for fn, argtypes in cuda_lib.SIGNATURES["sdpa_heads_ws"].items():
        m = re.search(rf"int {fn}\(([^)]*)\)", text)
        assert m, fn
        assert len(m.group(1).split(",")) == len(argtypes), fn
    assert len(cuda_lib.HEADS_WS_KERNELS) == 6
    assert set(sa._HEADS_WS) == {fn.__name__ for fn in REDESIGNED.values()}
    variants = {v for v, _ in sa._HEADS_WS.values()}
    assert variants == {int(k[len("sdpa_heads_ws_kernel<"):-1])
                        for k in cuda_lib.HEADS_WS_KERNELS}


# ---------------------------------------------------------------------------
# On the card: the redesign against the plain version and the kept kernels
# ---------------------------------------------------------------------------

GPU_REL, GPU_RTOL = 0.1, 2.0 ** -7
QK_GAIN = 1.5
MADD = ("E2_madd_row", "G_bf16_softmax")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest "
                    "--noconftest -m gpu tests/test_torch_sdpa_heads_ws.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_case(label, b, t, dev, seed=0):
    """(q, k, v [B*H, T, 48] bf16 (q, k at QK_GAIN: peaked scores), the
    label's mask argument, the plain version's mask [B*H, 1, T], valid [B,
    T]): a ragged mask, every row at least one valid key."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b * H, t, D, generator=gen, device=dev) * gain
               for gain in (QK_GAIN, QK_GAIN, 1.0))
    lens = torch.tensor([max(1, t - (i * t) // (2 * b) - 3) for i in range(b)],
                        device=dev)
    valid = torch.arange(t, device=dev)[None, :] < lens[:, None]
    mask = valid[:, None].to(torch.int8).contiguous()
    if label in MADD:
        mask = ((mask.float() - 1.0) * 1e9).contiguous()
    per_head = mask.repeat_interleave(H, dim=0)
    arg = per_head if label == "K_identity_maps" else mask
    return [x.to(torch.bfloat16) for x in (q, k, v)], arg, per_head, valid


def assert_kernel_close(got, ref, valid):
    """Within the limit on the valid query rows of every head."""
    b, t = valid.shape
    rows = valid.repeat_interleave(got.shape[0] // b, dim=0)
    got, ref = got.float()[rows], ref.float()[rows]
    rms = float(ref.pow(2).mean().sqrt())
    err = (got - ref).abs()
    assert float((err - GPU_RTOL * ref.abs()).max()) <= GPU_REL * rms


@pytest.mark.gpu
@pytest.mark.parametrize("t", [7, 64, 65, 129, 501, 800])
@pytest.mark.parametrize("label", list(REDESIGNED))
def test_cuda_walk_matches_plain_and_the_kept_kernel(cuda, label, t):
    (q, k, v), mask, per_head, valid = card_case(label, 3, t, cuda, seed=t)
    wrapper = REDESIGNED[label]
    before = wrapper.launches
    got = wrapper(q, k, v, mask)
    assert wrapper.launches == before + 1
    assert_kernel_close(got, PLAIN[label](q, k, v, per_head), valid)
    assert torch.equal(wrapper(q, k, v, mask), got)
    kept = sa.heads_sdpa_kept(wrapper, q, k, v, mask)
    assert wrapper.launches == before + 2
    assert torch.equal(kept, got)
    if label == "A_full":
        k3 = fa.fused_mha(*(x.view(3, H, t, D) for x in (q, k, v)), valid)
        assert torch.equal(got.view(3, H, t, D), k3)


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["A_full", "B_two_matmuls",
                                   "G_bf16_softmax", "K_identity_maps"])
@pytest.mark.parametrize("slots", [1, 5, 1000])
def test_cuda_walk_keeps_its_bits_under_any_plan(cuda, label, slots):
    """One block walking every unit (the ring and the Q slots wrapping
    many times), a few, or one a unit."""
    b, t = 2, 129
    (q, k, v), mask, _, _ = card_case(label, b, t, cuda, seed=1)
    got = REDESIGNED[label](q, k, v, mask)
    variant, layout = sa._HEADS_WS[REDESIGNED[label].__name__]
    batch, n_heads = (1, b * H) if label == "K_identity_maps" else (b, H)
    plan = torch.from_numpy(sa.heads_plan(b * H, t, slots)).to(cuda)
    out = sa._walk(variant, layout, q, k, v, mask, batch, n_heads, t, plan,
                   torch.full_like(q, float("nan")))
    assert torch.equal(out, got)


@pytest.mark.gpu
def test_cuda_entry_refuses_what_it_does_not_take(cuda):
    """A bad variant (the copy's among them) or layout, or an unaligned
    pointer: error 1 (cudaErrorInvalidValue) and nothing written."""
    (q, k, v), mask, _, _ = card_case("A_full", 1, 64, cuda)
    madd = ((mask.float() - 1.0) * 1e9).contiguous()
    plan = torch.from_numpy(sa.heads_plan(H, 64, 132)).to(cuda)
    lib = cuda_lib.library("sdpa_heads_ws")
    out = torch.zeros_like(q)
    wide = torch.zeros(q.numel() + 8, dtype=torch.bfloat16, device=cuda)

    def entry(variant=sa._FULL, layout=sa._HEADS, q_ptr=None, m_ptr=None,
              o_ptr=None):
        return lib.gigaam_sdpa_heads_ws(
            q.data_ptr() if q_ptr is None else q_ptr, k.data_ptr(),
            v.data_ptr(), mask.data_ptr() if m_ptr is None else m_ptr,
            out.data_ptr() if o_ptr is None else o_ptr, plan.data_ptr(),
            len(plan), variant, layout, 1, H, 64, sa.SCALE,
            torch.cuda.current_stream().cuda_stream)

    for kw in (dict(variant=-1), dict(variant=7), dict(variant=sa._COPY),
               dict(variant=sa._COPY, layout=sa._MASK_PER_HEAD),
               dict(layout=sa._HEAD_GROUPS), dict(layout=sa._PACKED),
               dict(variant=sa._NO_MAX, layout=sa._MASK_PER_HEAD),
               dict(q_ptr=wide.data_ptr() + 2),
               dict(o_ptr=wide.data_ptr() + 8),
               dict(variant=sa._MADD_ROW, m_ptr=madd.data_ptr() + 2)):
        assert entry(**kw) == 1, kw
    torch.cuda.synchronize()
    assert not out.any() and not wide.any()
    assert entry() == 0
    torch.cuda.synchronize()
    assert out.any()


@pytest.mark.gpu
def test_cuda_occupancy_one_block_an_sm(cuda):
    pairs = (ctypes.c_int * 12)()
    cuda_lib.check(cuda_lib.library("sdpa_heads_ws")
                   .gigaam_sdpa_heads_ws_occupancy(pairs),
                   "gigaam_sdpa_heads_ws_occupancy")
    assert list(pairs)[1::2] == [1] * 6
    assert len(set(list(pairs)[0::2])) == 1 and pairs[0] <= 232448
