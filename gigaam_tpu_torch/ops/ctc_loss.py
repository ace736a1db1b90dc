"""CTC loss (blank = num_classes - 1, matching the GigaAM head layout): port
of ``gigaam_tpu/ops/ctc_loss.py``.

The reference uses ``nn.CTCLoss(blank=blank_id, zero_infinity=True)`` with
the default ``reduction='mean'`` (``train_utils/module.py:60,92-104``).  The
JAX package wraps an XLA-compiled alpha recursion, outside any Pallas kernel;
here ``torch.nn.functional.ctc_loss`` carries the recursion, per sequence,
and this module applies the JAX function's padding and reduction contract
around it (``reduction="mean"`` would not mask the padded rows).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ctc_loss(
    logits: torch.Tensor,
    input_lengths: torch.Tensor,
    targets: torch.Tensor,
    target_lengths: torch.Tensor,
    blank_id: int,
) -> torch.Tensor:
    """torch-``reduction='mean'`` CTC loss over the valid rows.

    logits [B, T, V] (raw head outputs, normalized here in fp32),
    input_lengths [B], targets [B, U] int, target_lengths [B].

    * lengths beyond T are clamped to T;
    * a target that cannot be aligned (``T < U + consecutive repeats``)
      contributes 0, not infinity (``zero_infinity``);
    * each row's loss divides by ``max(target_length, 1)`` (an empty
      transcript trains pure blank emission);
    * rows with ``input_length == 0`` (pad rows) are left out of the mean,
      whose denominator is ``max(number of valid rows, 1)``.
    """
    t = logits.shape[1]
    input_lengths = torch.clamp(input_lengths, max=t).long()
    target_lengths = target_lengths.long()
    log_probs = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    # int64 targets keep the recursion on PyTorch's own implementation
    per_seq = F.ctc_loss(log_probs, targets.long(), input_lengths,
                         target_lengths, blank=blank_id, reduction="none",
                         zero_infinity=True)
    per_seq = per_seq / torch.clamp(target_lengths, min=1)
    valid = (input_lengths > 0).to(per_seq.dtype)
    return (per_seq * valid).sum() / torch.clamp(valid.sum(), min=1.0)
