"""Float32 matmuls that stay float32 on the card.

A float32 ``torch.matmul`` on CUDA runs in TF32 whenever
``torch.backends.cuda.matmul.allow_tf32`` is on, which keeps about three
decimal digits.  The frontend (whose JAX counterpart asks for
``Precision.HIGHEST``) and the kernels' plain versions need the full float32
product, so they run under :func:`full_fp32`.

The flags are process-wide, and a server runs model calls in several
threads at once.  So the blocks of all threads share one depth count under a
module lock: the first block to open saves the flags and turns TF32 off, and
the last block to close restores them.  TF32 stays off while any thread is
inside a block.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Tuple

import torch

_lock = threading.Lock()
_depth = 0
_saved: Optional[Tuple[bool, bool]] = None


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    """Turn TF32 off for cuBLAS matmuls and cuDNN convolutions inside the
    block; the last block of any thread to close restores the settings
    that the first one found."""
    global _depth, _saved
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    with _lock:
        if _depth == 0:
            _saved = (matmul.allow_tf32, cudnn.allow_tf32)
            matmul.allow_tf32 = False
            cudnn.allow_tf32 = False
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                matmul.allow_tf32, cudnn.allow_tf32 = _saved
