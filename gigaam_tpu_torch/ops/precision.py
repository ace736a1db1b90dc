"""Float32 matmuls that stay float32 on the card.

A float32 ``torch.matmul`` on CUDA runs in TF32 whenever
``torch.backends.cuda.matmul.allow_tf32`` is on, which keeps about three
decimal digits.  The frontend (whose JAX counterpart asks for
``Precision.HIGHEST``) and the kernels' plain versions need the full float32
product, so they run under :func:`full_fp32`.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    """Turn TF32 off for cuBLAS matmuls and cuDNN convolutions inside the
    block, and restore the caller's settings after it."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
