"""The SDPA ablation's packed layout (P11) on the per-head walk
(``csrc/sdpa_packed_heads_ws.cu``: ``csrc/sdpa_heads_walk.cuh``'s device code,
each head of q, k, v [B, T, H*48] read through a 4-D tensor map of [B, T,
H, 48], o stored packed), driven by ``packed_sdpa`` of
``gigaam_tpu_torch/probes/sdpa_ablation.py``.

On the CPU a numpy mirror of a tensor map's box read (TMA's tiled mode:
the box at the given coordinates, elements past any dimension zero) holds
the packed map against the head-major walk's: at B 2, H 4 and 16, T 64, 70
and 130, every (b, h, row0) box of the 4-D map equals the tile that
``head_map`` gives the per-head walk, the head's 48 columns and 16 columns
of zeros.  A 3-D map over the flat H*48 columns puts the next head's first
16 columns where those zeros are, which the walk's products never read
(``chip_smoke.py`` plants it and finds the same bits); shifted by 16
columns it moves them into the read ones.  The map's geometry is read from
the source.  ``packed_sdpa`` takes ``full_packed_plain`` for CPU tensors
(bit for bit, no launch counted), which matches the Pallas
``k_full_packed`` of ``benchmarks/sdpa_ablation.py`` in interpret mode at
B 2, H 4, T 64 and 70 within ``tests/test_torch_probes.py``'s limit.

The tests marked ``gpu`` hold the kernel against its plain version on the
card in bf16 with ragged masks (a tenth of the output's RMS plus one bf16
rounding of the value, ``chip_smoke.py``'s limit), bit for bit against K3's
``fused_mha`` on the same heads, against the kept kernel and against itself
under other plans; the planted maps; the entry's refusals without a launch;
one block an SM.  They skip without a card (on the card: ``pytest
--noconftest -m gpu tests/test_torch_sdpa_packed_ws.py``).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from gigaam_tpu_torch.ops import cuda_lib
from gigaam_tpu_torch.ops import fused_attention as fa
from gigaam_tpu_torch.probes import sdpa_ablation as sa
from test_torch_probes import (inputs, pallas_out, port_out, script,  # noqa: F401
                               term_step, valid_rows)

D = sa.D
SOURCE = os.path.join(cuda_lib.CSRC_DIR, "sdpa_packed_heads_ws.cu")
LABEL = "H_packed_lane_slice"


def box_read(flat, dims, strides, box, coords):
    """TMA's tiled box read: the elements of ``flat`` (1-D) at ``coords`` +
    every index of ``box``, dimension 0 innermost, element ``i`` at sum(i_d
    strides_d) (strides in elements, strides[0] = 1); an index past its
    dimension reads zero.  Returns the box with dimension 0 last."""
    idx = np.indices(box[::-1]).reshape(len(box), -1)[::-1]
    pos = idx + np.asarray(coords)[:, None]
    inside = np.all((pos >= 0) & (pos < np.asarray(dims)[:, None]), axis=0)
    at = (pos * np.asarray(strides)[:, None]).sum(axis=0)
    out = np.where(inside, flat[np.where(inside, at, 0)], 0)
    return out.reshape(box[::-1])


def packed_geometry(b, h, t):
    """(dims, element strides, box) of the 4-D map, as the source states
    them."""
    return ((D, h, t, b), (1, D, h * D, t * h * D), (64, 1, 64, 1))


def head_tile(x4, bh, row0):
    """What ``head_map``'s box (dims {48, T, B H}, box {64, 64, 1}) gives
    the per-head walk: rows row0 .. row0 + 63 of head bh of [B H, T, 48],
    rows past T and columns 48 .. 63 zero."""
    n, t, _ = x4.shape
    return box_read(x4.reshape(-1), (D, t, n), (1, D, t * D), (64, 64, 1),
                    (0, row0, bh))


@pytest.mark.parametrize("t", [64, 70, 130])
@pytest.mark.parametrize("h", [4, 16])
def test_packed_box_is_the_head_major_tile(h, t):
    b = 2
    rng = np.random.default_rng(h * 1000 + t)
    x3 = rng.standard_normal((b, t, h * D)).astype(np.float32)
    heads = x3.reshape(b, t, h, D).transpose(0, 2, 1, 3).reshape(b * h, t, D)
    dims, strides, box = packed_geometry(b, h, t)
    for bb in range(b):
        for hh in range(h):
            for row0 in range(0, t, 64):
                got = box_read(x3.reshape(-1), dims, strides, box,
                               (0, hh, row0, bb))[0, :, 0]
                want = head_tile(heads, bb * h + hh, row0)[0]
                assert np.array_equal(got, want), (bb, hh, row0)
                assert not got[:, D:].any()
                assert not got[t - row0:].any()


@pytest.mark.parametrize("h", [4, 16])
def test_flat_map_reaches_into_the_next_head(h):
    """The planted 3-D map over the flat H*48 columns: at column 48 h its
    box agrees with the head's tile in the columns the products read (0 ..
    47) and holds the next head's first 16 in columns 48 .. 63 (zeros past
    the last head); at 48 h + 16 columns 32 .. 47 are the next head's."""
    b, t = 2, 70
    rng = np.random.default_rng(h)
    x3 = rng.standard_normal((b, t, h * D)).astype(np.float32)
    heads = x3.reshape(b, t, h, D).transpose(0, 2, 1, 3).reshape(b * h, t, D)
    dims, strides = (h * D, t, b), (1, h * D, t * h * D)
    for bb in range(b):
        for hh in range(h):
            want = head_tile(heads, bb * h + hh, 0)[0]
            at0 = box_read(x3.reshape(-1), dims, strides, (64, 64, 1),
                           (D * hh, 0, bb))[0]
            at16 = box_read(x3.reshape(-1), dims, strides, (64, 64, 1),
                            (D * hh + 16, 0, bb))[0]
            assert np.array_equal(at0[:, :D], want[:, :D])
            nxt = (x3[bb, :64, D * (hh + 1):D * (hh + 1) + 16]
                   if hh + 1 < h else np.zeros((64, 16), np.float32))
            assert np.array_equal(at0[:, D:], nxt)
            assert np.array_equal(at16[:, 32:D], nxt)
            assert np.array_equal(at16[:, :32], want[:, 16:D])


def test_source_states_the_geometry_the_mirror_reads():
    """``packed_map``'s 4-D dims, byte strides and box are those of
    ``packed_geometry`` (bf16: two bytes an element), the 3-D map's those
    of ``test_flat_map_reaches_into_the_next_head``."""
    text = re.sub(r"\s+", " ", "".join(
        open(os.path.join(cuda_lib.CSRC_DIR, f)).read()
        for f in ("sdpa_packed_heads_ws.cu", "sdpa_heads_walk.cuh")))
    for line in (
            "dims[4] = {(cuuint64_t)kD, (cuuint64_t)kPackedHeads, "
            "(cuuint64_t)t, (cuuint64_t)batch};",
            "strides[3] = {kD * 2, row * 2, (cuuint64_t)t * row * 2};",
            "box[4] = {64, 1, kTile, 1};",
            "const cuuint64_t row = kPackedHeads * kD;",
            "dims[3] = {row, (cuuint64_t)t, (cuuint64_t)batch};",
            "strides[2] = {row * 2, (cuuint64_t)t * row * 2};",
            "box[3] = {64, kTile, 1};",
            "tma_load_4d(dst, map, 0, h, row0, b, bar);",
            "tma_load_3d(dst, map, h * kD + flat, row0, b, bar);"):
        assert line in text, line


def packed(x, b, h, t):
    """[B*H, T, 48] -> [B, T, H*48]"""
    return x.reshape(b, h, t, D).transpose(1, 2).reshape(b, t, h * D)


def test_cpu_wrapper_takes_the_plain_version():
    b, h, t = 2, 4, 70
    q, k, v, valid, mask, madd = inputs(b, h, t, seed=9)
    q3, k3, v3 = (packed(torch.from_numpy(a).to(torch.bfloat16), b, h, t)
                  for a in (q, k, v))
    tmask = torch.from_numpy(mask)
    sa.reset_launch_counts()
    got = sa.packed_sdpa(q3, k3, v3, tmask)
    assert torch.equal(got, sa.full_packed_plain(q3, k3, v3, tmask))
    assert got.shape == (b, t, h * D)
    assert [fn.launches for fn in sa.KERNELS] == [0] * len(sa.KERNELS)


@pytest.mark.parametrize("tt", [64, 70])
def test_cpu_wrapper_matches_the_pallas_body(script, tt):  # noqa: F811
    b, h = 2, 4
    q, k, v, valid, mask, madd = inputs(b, h, tt, seed=tt)
    ref = valid_rows(pallas_out(script, LABEL, q, k, v, mask, madd, b, h, tt),
                     LABEL, valid, b, h, tt)
    got = valid_rows(port_out(LABEL, q, k, v, mask, madd, b, h, tt),
                     LABEL, valid, b, h, tt)
    rms = np.sqrt(np.mean(ref ** 2))
    larger = np.maximum(np.maximum(np.abs(got), np.abs(ref)), 2.0 ** -16 * rms)
    step = 2.0 ** (np.floor(np.log2(larger)) - 7)
    err = np.abs(got - ref)
    assert np.all(err <= step + term_step(LABEL, q, k, v)), (
        f"{np.max(err / step)} bf16 steps")
    assert np.mean(err > step) <= 0.01


def test_packed_checks_reject_what_the_kernel_does_not_take():
    q3 = torch.zeros(2, 16, 4 * D, dtype=torch.bfloat16)
    mask = torch.ones(2, 1, 16, dtype=torch.int8)
    assert sa._check_packed(q3, q3, q3, mask) == (2, 4, 16)
    with pytest.raises(ValueError, match="must be"):
        sa._check_packed(q3[..., :50], q3, q3, mask)
    with pytest.raises(ValueError, match="v has shape"):
        sa._check_packed(q3, q3, q3[:, :8], mask)
    with pytest.raises(ValueError, match="mask has shape"):
        sa._check_packed(q3, q3, q3, mask[:, :, :8])


def test_the_library_is_registered_for_its_launches():
    """Each entry point is in its source with the argument count that
    ``cuda_lib`` declares, and the kernel that ``dynamic_resources`` names
    is the source's."""
    text = open(SOURCE).read()
    for fn, argtypes in cuda_lib.SIGNATURES["sdpa_packed_heads_ws"].items():
        m = re.search(rf"int {fn}\(([^)]*)\)", text)
        assert m, fn
        assert len(m.group(1).split(",")) == len(argtypes), fn
    assert re.search(rf"\b{cuda_lib.PACKED_HEADS_WS_KERNEL}\(", text)
    assert '#include "sdpa_heads_walk.cuh"' in text


# ---------------------------------------------------------------------------
# On the card: the redesign against the plain version, K3 and the kept kernel
# ---------------------------------------------------------------------------

H = sa.H
GPU_REL, GPU_RTOL = 0.1, 2.0 ** -7
QK_GAIN = 1.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest "
                    "--noconftest -m gpu tests/test_torch_sdpa_packed_ws.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_case(b, t, dev, seed=0):
    """(q, k, v [B*H, T, 48] bf16 (q, k at QK_GAIN), the same packed [B, T,
    H*48], mask [B, 1, T] int8, valid [B, T]): a ragged mask, every row at
    least one valid key."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b * H, t, D, generator=gen, device=dev) * gain
               for gain in (QK_GAIN, QK_GAIN, 1.0))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    lens = torch.tensor([max(1, t - (i * t) // (2 * b) - 3) for i in range(b)],
                        device=dev)
    valid = torch.arange(t, device=dev)[None, :] < lens[:, None]
    mask = valid[:, None].to(torch.int8).contiguous()
    return (q, k, v), tuple(packed(x, b, H, t).contiguous()
                            for x in (q, k, v)), mask, valid


def distance(got, ref, valid):
    """max (|got - ref| - GPU_RTOL |ref|) / RMS over the valid query rows of
    [B, T, H*48]."""
    got, ref = got.float()[valid], ref.float()[valid]
    rms = float(ref.pow(2).mean().sqrt())
    return float(((got - ref).abs() - GPU_RTOL * ref.abs()).max()) / rms


@pytest.mark.gpu
@pytest.mark.parametrize("t", [7, 64, 65, 129, 501, 800])
def test_cuda_walk_matches_plain_k3_and_the_kept_kernel(cuda, t):
    b = 3
    (q, k, v), (q3, k3, v3), mask, valid = card_case(b, t, cuda, seed=t)
    before = sa.packed_sdpa.launches
    got = sa.packed_sdpa(q3, k3, v3, mask)
    assert sa.packed_sdpa.launches == before + 1
    assert distance(got, sa.full_packed_plain(q3, k3, v3, mask), valid) <= (
        GPU_REL)
    assert torch.equal(sa.packed_sdpa(q3, k3, v3, mask), got)
    assert torch.equal(sa.packed_sdpa_kept(q3, k3, v3, mask), got)
    assert sa.packed_sdpa.launches == before + 2
    k3_out = fa.fused_mha(*(x.view(b, H, t, D) for x in (q, k, v)), valid)
    assert torch.equal(got, packed(k3_out, b, H, t))


@pytest.mark.gpu
@pytest.mark.parametrize("slots", [1, 5, 1000])
def test_cuda_walk_keeps_its_bits_under_any_plan(cuda, slots):
    b, t = 2, 129
    _, (q3, k3, v3), mask, _ = card_case(b, t, cuda, seed=1)
    got = sa.packed_sdpa(q3, k3, v3, mask)
    plan = torch.from_numpy(sa.heads_plan(b * H, t, slots)).to(cuda)
    out = sa._packed_walk(q3, k3, v3, mask, b, t, plan,
                          torch.full_like(q3, float("nan")))
    assert torch.equal(out, got)


@pytest.mark.gpu
def test_cuda_planted_maps(cuda):
    """The flat map at column 48 h changes only the unread columns of a
    box: the same bits; shifted by 16 the check sees it."""
    b, t = 2, 200
    _, (q3, k3, v3), mask, valid = card_case(b, t, cuda, seed=3)
    got = sa.packed_sdpa(q3, k3, v3, mask)
    assert torch.equal(sa._packed_walk(q3, k3, v3, mask, b, t, flat=0), got)
    shifted = sa._packed_walk(q3, k3, v3, mask, b, t, flat=16)
    assert distance(shifted, got, valid) > GPU_REL


@pytest.mark.gpu
def test_cuda_entry_refuses_what_it_does_not_take(cuda):
    """H other than 16, a flat offset out of range or an unaligned pointer:
    error 1 (cudaErrorInvalidValue) and nothing written."""
    b, t = 1, 64
    _, (q3, k3, v3), mask, _ = card_case(b, t, cuda)
    plan = torch.from_numpy(sa.heads_plan(b * H, t, 132)).to(cuda)
    lib = cuda_lib.library("sdpa_packed_heads_ws")
    out = torch.zeros_like(q3)
    wide = torch.zeros(q3.numel() + 8, dtype=torch.bfloat16, device=cuda)

    def entry(n_heads=H, flat=-1, q_ptr=None, o_ptr=None, p_ptr=None):
        return lib.gigaam_sdpa_packed_heads_ws(
            q3.data_ptr() if q_ptr is None else q_ptr, k3.data_ptr(),
            v3.data_ptr(), mask.data_ptr(),
            out.data_ptr() if o_ptr is None else o_ptr,
            plan.data_ptr() if p_ptr is None else p_ptr, len(plan), b,
            n_heads, t, flat, sa.SCALE,
            torch.cuda.current_stream().cuda_stream)

    for kw in (dict(n_heads=8), dict(n_heads=32), dict(flat=-2),
               dict(flat=D), dict(q_ptr=wide.data_ptr() + 2),
               dict(o_ptr=wide.data_ptr() + 8),
               dict(p_ptr=plan.data_ptr() + 4)):
        assert entry(**kw) == 1, kw
    torch.cuda.synchronize()
    assert not out.any() and not wide.any()
    assert entry() == 0
    torch.cuda.synchronize()
    assert out.any()
    eight = [x[..., :8 * D].contiguous() for x in (q3, k3, v3)]
    with pytest.raises(ValueError, match="takes 16 heads"):
        sa.packed_sdpa(*eight, mask)


@pytest.mark.gpu
def test_cuda_occupancy_one_block_an_sm(cuda):
    pair = (ctypes.c_int * 2)()
    cuda_lib.check(cuda_lib.library("sdpa_packed_heads_ws")
                   .gigaam_sdpa_packed_heads_ws_occupancy(pair),
                   "gigaam_sdpa_packed_heads_ws_occupancy")
    heads = (ctypes.c_int * 12)()
    cuda_lib.check(cuda_lib.library("sdpa_heads_ws")
                   .gigaam_sdpa_heads_ws_occupancy(heads),
                   "gigaam_sdpa_heads_ws_occupancy")
    assert list(pair) == [heads[0], 1]
