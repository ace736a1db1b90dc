"""The shared-memory ceiling probe (P3) on its redesign
(``csrc/smem_probe_ws.cu``: eight blocks, one row of x each, every block
claiming the whole buffer and moving its row into the buffer's top with
one bulk copy), driven by ``smem_copy`` of
``gigaam_tpu_torch/probes/subsampling_probe.py``.

On the CPU ``vmem_plain``, the plain version of the Pallas body of
``benchmarks/pallas_subsampling_probe.py``'s ``probe_vmem``, is exactly
2 x at every size of ``SMEM_LADDER_KB``, ``smem_copy`` takes it for CPU
tensors (no block count, no launch counted), and the new library's entry
points are registered with the argument counts of their source.

The tests marked ``gpu`` hold the redesign on the card: 2 x exactly at
every ladder size the card grants, the same bits as the kept single-block
kernel, one block an SM at the limit, the next size refused before any
launch, the entry's own refusals, the empty kernel; they skip without a
card (on the card: ``pytest --noconftest -m gpu
tests/test_torch_smem_probe_ws.py``).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from gigaam_tpu_torch.ops import cuda_lib
from gigaam_tpu_torch.probes import subsampling_probe as sp

SOURCE = os.path.join(cuda_lib.CSRC_DIR, "smem_probe_ws.cu")


def draw_x(seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (sp.PROBE_ROWS, sp.PROBE_COLS)).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("kb", sp.SMEM_LADDER_KB)
def test_vmem_plain_is_exactly_twice_x(kb):
    x = draw_x(kb)
    got = sp.vmem_plain(x, kb * 1024)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got.float(), 2 * x.float())


def test_cpu_wrapper_takes_the_plain_version():
    x = draw_x(0)
    sp.reset_launch_counts()
    for kb in sp.SMEM_LADDER_KB:
        got, blocks = sp.smem_copy(x, kb * 1024)
        assert blocks is None
        assert torch.equal(got, sp.vmem_plain(x, kb * 1024))
    assert [fn.launches for fn in sp.KERNELS] == [0] * len(sp.KERNELS)


def test_the_library_is_registered_for_its_launches():
    """Each entry point is in its source with the argument count that
    ``cuda_lib`` declares, and the row a block takes is x's."""
    text = open(SOURCE).read()
    for fn, argtypes in cuda_lib.SIGNATURES["smem_probe_ws"].items():
        m = re.search(rf"int {fn}\(([^)]*)\)", text)
        assert m, fn
        assert len(m.group(1).split(",")) == len(argtypes), fn
    assert f"kRowBytes = {sp.PROBE_COLS} * 2;" in text
    assert f"kRows = {sp.PROBE_ROWS};" in text


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest "
                    "--noconftest -m gpu tests/test_torch_smem_probe_ws.py)")
    return torch.device("cuda")


def optin_limit() -> int:
    return torch.cuda.get_device_properties(0).shared_memory_per_block_optin


@pytest.mark.gpu
def test_cuda_twice_x_at_every_granted_size(cuda):
    limit = optin_limit()
    x = draw_x(1).to(cuda)
    sizes = [kb * 1024 for kb in sp.SMEM_LADDER_KB if kb * 1024 <= limit]
    assert sizes and sizes[-1] == limit
    before = sp.smem_copy.launches
    for n_bytes in sizes:
        got, blocks = sp.smem_copy(x, n_bytes)
        assert torch.equal(got, x * 2), n_bytes
        kept, kept_blocks = sp.smem_copy_kept(x, n_bytes)
        assert torch.equal(kept, got), n_bytes
        assert blocks >= 1 and blocks >= kept_blocks
    assert blocks == 1
    assert sp.smem_copy.launches == before + len(sizes)


@pytest.mark.gpu
def test_cuda_past_the_limit_is_refused_before_a_launch(cuda):
    x = draw_x(2).to(cuda)
    before = sp.smem_copy.launches
    with pytest.raises(sp.SharedMemoryRefused):
        sp.smem_copy(x, optin_limit() + 1024)
    assert sp.smem_copy.launches == before
    got, _ = sp.smem_copy(x, 16384)
    assert torch.equal(got, x * 2)


@pytest.mark.gpu
def test_cuda_entry_refuses_what_it_does_not_take(cuda):
    """An unaligned pointer or a size that is no multiple of 16 or cannot
    hold a row and the barrier: error 1 and nothing written."""
    lib = cuda_lib.library("smem_probe_ws")
    x = draw_x(3).to(cuda)
    wide = torch.zeros(x.numel() + 8, dtype=torch.bfloat16, device=cuda)
    result = (ctypes.c_int * 2)()
    stream = torch.cuda.current_stream().cuda_stream
    for x_ptr, o_ptr, n_bytes in (
            (x.data_ptr() + 2, wide.data_ptr(), 16384),
            (x.data_ptr(), wide.data_ptr() + 8, 16384),
            (x.data_ptr(), wide.data_ptr(), 16392),
            (x.data_ptr(), wide.data_ptr(), 2048)):
        assert lib.gigaam_smem_probe_ws(x_ptr, o_ptr, n_bytes, result,
                                        stream) == 1
        assert list(result) == [0, 0]
    torch.cuda.synchronize()
    assert not wide.any()


@pytest.mark.gpu
def test_cuda_empty_kernel_launches(cuda):
    before = sp.smem_copy.launches
    sp.empty_launch(cuda)
    torch.cuda.synchronize()
    assert sp.smem_copy.launches == before
