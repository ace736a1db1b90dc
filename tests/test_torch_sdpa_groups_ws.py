"""The head-group walk of the SDPA ablation (P9) on its warp-specialised
redesign (``csrc/sdpa_groups_ws.cu``, driven by
``gigaam_tpu_torch/probes/sdpa_ablation.py``).

On the CPU the plan that the wrapper hands the kernel (``groups_plan``, a
pure function) is held to what the kernel needs of it: every (batch
element, head, query tile) in exactly one unit, each unit a run of heads
inside one cell (a query tile, a group of ``heads_per_block`` heads and a
batch element), at least as many blocks as the head-group kernel's grid,
and at least 128 for the probe's ``I`` at B 8, T' 501, over B 1-16, T 1-800,
groups of 1, 2, 4, 8 and 16 heads and cards of 132 and 114 SMs; the wrapper
takes ``allheads_plain`` for CPU tensors.

The tests marked ``gpu`` hold the kernel against ``allheads_plain`` on the
card in bf16 with ragged masks, within a tenth of the output's RMS plus one
bf16 rounding of the value (``chip_smoke.py``'s limit), against the kept
head-group kernel, and two calls bit-equal; they skip without a card (on
the card: ``pytest --noconftest -m gpu tests/test_torch_sdpa_groups_ws.py``).
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from gigaam_tpu_torch.probes import sdpa_ablation as sa

H = sa.H
GROUPS = [1, 2, 4, 8, 16]
CARDS = [132, 114]


def check_plan(b, t, hpb, sms):
    units = sa.groups_plan(b, H, t, hpb, sms)
    q_tiles = math.ceil(t / 64)
    assert units.dtype == np.int32 and units.shape[1] == 4
    seen = np.zeros((b, H, q_tiles), dtype=np.int64)
    for bb, qt, h0, n in units:
        assert 0 <= bb < b and 0 <= qt < q_tiles and n >= 1
        # a run stays inside one cell's group of heads
        assert h0 // hpb == (h0 + n - 1) // hpb
        seen[bb, h0:h0 + n, qt] += 1
    assert (seen == 1).all()
    # runs of one length, a divisor of the group
    assert len(set(units[:, 3].tolist())) == 1 and hpb % units[0, 3] == 0
    # never fewer blocks than the head-group kernel's grid
    assert len(units) >= q_tiles * (H // hpb) * b
    return units


@pytest.mark.parametrize("sms", CARDS)
@pytest.mark.parametrize("hpb", GROUPS)
@pytest.mark.parametrize("t", [1, 7, 63, 64, 65, 500, 501, 800])
@pytest.mark.parametrize("b", [1, 3, 8, 16])
def test_plan_covers_every_head_and_query_tile_once(b, t, hpb, sms):
    check_plan(b, t, hpb, sms)


@settings(max_examples=60, deadline=None)
@given(b=st.integers(1, 16), t=st.integers(1, 800),
       hpb=st.sampled_from(GROUPS), sms=st.sampled_from(CARDS))
def test_plan_covers_every_head_and_query_tile_once_drawn(b, t, hpb, sms):
    check_plan(b, t, hpb, sms)


@pytest.mark.parametrize("sms", CARDS)
def test_the_16_head_cell_fills_at_least_128_blocks(sms):
    """``I`` at the ablation's B 8, T' 501: the head-group kernel's 64
    blocks become at least 128."""
    assert len(sa.groups_plan(8, H, 501, H, sms)) >= 128


def test_plan_takes_the_cheapest_cut_and_the_fewest_runs_on_a_tie():
    for b, t, hpb, sms in [(8, 501, 16, 132), (8, 501, 4, 132),
                           (16, 500, 16, 132), (1, 7, 16, 132),
                           (8, 501, 16, 114)]:
        cells = b * math.ceil(t / 64) * (H // hpb)
        costs = {d: sa.groups_cost(cells, d, hpb, t, sms)
                 for d in GROUPS if hpb % d == 0}
        best = min(costs.values())
        parts = len(sa.groups_plan(b, H, t, hpb, sms)) // cells
        assert costs[parts] == best
        assert parts == min(d for d, c in costs.items() if c == best)


def test_units_of_a_batch_element_and_run_sit_side_by_side():
    """The query tiles of one (batch element, head run) are neighbours:
    they read the same keys."""
    units = sa.groups_plan(2, H, 300, 16, 132)
    q_tiles = math.ceil(300 / 64)
    for i in range(0, len(units), q_tiles):
        block = units[i:i + q_tiles]
        assert (block[:, 1] == np.arange(q_tiles)).all()
        assert len({(int(u[0]), int(u[2])) for u in block}) == 1


def test_cpu_wrapper_takes_the_plain_version():
    rng = np.random.default_rng(3)
    b, t = 2, 70
    q, k, v = (torch.from_numpy(rng.standard_normal((b, H, t, sa.D)))
               .to(torch.bfloat16) for _ in range(3))
    mask = torch.from_numpy(
        (np.arange(t)[None, :] < np.array([t, 41])[:, None])[:, None]
        .astype(np.int8))
    sa.reset_launch_counts()
    for hpb in (16, 4):
        assert torch.equal(sa.allheads_sdpa(q, k, v, mask, hpb),
                           sa.allheads_plain(q, k, v, mask))
    assert sa.allheads_sdpa.launches == 0


# ---------------------------------------------------------------------------
# On the card: the redesign against the plain version and the kept kernel
# ---------------------------------------------------------------------------

GPU_REL, GPU_RTOL = 0.1, 2.0 ** -7
QK_GAIN = 1.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest "
                    "--noconftest -m gpu tests/test_torch_sdpa_groups_ws.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_inputs(b, t, dev, seed=0):
    """q, k, v [B, H, T, 48] bf16 (q, k at QK_GAIN: peaked scores) and a
    ragged mask [B, 1, T] int8, every row at least one valid key."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, H, t, sa.D, generator=gen, device=dev) * gain
               for gain in (QK_GAIN, QK_GAIN, 1.0))
    lens = torch.tensor([max(1, t - (i * t) // (2 * b) - 3) for i in range(b)],
                        device=dev)
    valid = torch.arange(t, device=dev)[None, :] < lens[:, None]
    return ([x.to(torch.bfloat16) for x in (q, k, v)],
            valid[:, None].to(torch.int8).contiguous(), valid)


def assert_kernel_close(got, ref, valid):
    """Within the limit on the valid query rows of every head."""
    rows = valid[:, None, :, None].expand_as(got)
    got, ref = got.float()[rows], ref.float()[rows]
    rms = float(ref.pow(2).mean().sqrt())
    err = (got - ref).abs()
    assert float((err - GPU_RTOL * ref.abs()).max()) <= GPU_REL * rms


@pytest.mark.gpu
@pytest.mark.parametrize("hpb", [16, 4, 1])
@pytest.mark.parametrize("t", [7, 64, 65, 501, 800])
def test_cuda_redesign_matches_plain(cuda, t, hpb):
    (q, k, v), mask, valid = card_inputs(3, t, cuda, seed=t)
    before = sa.allheads_sdpa.launches
    got = sa.allheads_sdpa(q, k, v, mask, hpb)
    assert sa.allheads_sdpa.launches == before + 1
    assert_kernel_close(got, sa.allheads_plain(q, k, v, mask), valid)
    assert torch.equal(sa.allheads_sdpa(q, k, v, mask, hpb), got)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,hpb", [(8, 501, 16), (8, 501, 4),
                                     (16, 500, 16), (2, 65, 2), (1, 7, 8)])
def test_cuda_redesign_against_the_kept_head_group_kernel(cuda, b, t, hpb):
    (q, k, v), mask, valid = card_inputs(b, t, cuda, seed=b + t)
    got = sa.allheads_sdpa(q, k, v, mask, hpb)
    before = sa.allheads_sdpa.launches
    old = sa.allheads_sdpa_serial(q, k, v, mask, hpb)
    assert sa.allheads_sdpa.launches == before
    assert_kernel_close(old, sa.allheads_plain(q, k, v, mask), valid)
    assert_kernel_close(got, old, valid)


@pytest.mark.gpu
def test_cuda_redesign_refuses_what_it_does_not_take(cuda):
    (q, k, v), mask, _ = card_inputs(1, 64, cuda)
    with pytest.raises(ValueError, match="does not divide"):
        sa.allheads_sdpa(q, k, v, mask, heads_per_block=3)
    with pytest.raises(ValueError, match="mask is torch.bool"):
        sa.allheads_sdpa(q, k, v, mask.bool(), 16)
    with pytest.raises(ValueError, match="k must be contiguous"):
        sa.allheads_sdpa(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                         v, mask, 16)
