"""CTC head (port of ``gigaam_tpu/models/heads.py::ctc_log_probs``).

The reference's 1x1 Conv1d (``gigaam/decoder.py:7-21``) is a plain matmul.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..ops.conformer_ops import Params, linear


def ctc_log_probs(params: Mapping[str, Params],
                  encoded: torch.Tensor) -> torch.Tensor:
    """encoded [B, T, D] -> log_probs [B, T, V] (fp32 log-softmax)."""
    logits = linear(params["proj"], encoded).float()
    return torch.log_softmax(logits, dim=-1)
