"""CTC and emotion heads (port of ``gigaam_tpu/models/heads.py``:
``ctc_log_probs``, ``ctc_logits``, ``emo_probs``).

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


def ctc_logits(params: Mapping[str, Params],
               encoded: torch.Tensor) -> torch.Tensor:
    """encoded [B, T, D] -> raw head outputs [B, T, V] in fp32, for the
    loss (which normalizes them itself)."""
    return linear(params["proj"], encoded).float()


def emo_probs(params: Mapping[str, Params], encoded: torch.Tensor,
              lengths: torch.Tensor) -> torch.Tensor:
    """Mean pool over the valid frames + linear + softmax
    (``gigaam/model.py:272-285``) -> [B, num_classes] fp32.

    The reference avg-pools over the full (unmasked) T; pooling over valid
    frames matches it for unpadded single samples and is right for padded
    batches.  The frame count is exact in fp32 (a bf16 sum of the mask
    would round counts above 256)."""
    t = encoded.shape[1]
    valid = (torch.arange(t, device=encoded.device)[None, :]
             < lengths[:, None]).to(encoded.dtype)
    count = torch.clamp(lengths, max=t).float()[:, None]
    pooled = ((encoded * valid[:, :, None]).float().sum(dim=1)
              / torch.clamp(count, min=1.0))
    logits = linear(params["proj"], pooled).float()
    return torch.softmax(logits, dim=-1)
