"""CTC greedy decoding: the mask on the device, the extraction on the host.

Port of ``gigaam_tpu/decode/ctc_greedy.py``: argmax -> dedup mask
(labels[t] != labels[t-1]) -> length mask, all as tensor ops on the
device; one host transfer then extracts per-sample (token_ids, frames).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def ctc_greedy_mask(
    log_probs: torch.Tensor, lengths: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """log_probs [B, T, V] (blank = V-1), lengths [B] ->
    (labels [B, T], keep-mask [B, T])."""
    blank_id = log_probs.shape[-1] - 1
    labels = torch.argmax(log_probs, dim=-1)
    t = labels.shape[1]
    prev = torch.cat([torch.full_like(labels[:, :1], -1), labels[:, :-1]],
                     dim=1)
    keep = (labels != blank_id) & (labels != prev)
    frame = torch.arange(t, device=labels.device)[None, :]
    keep &= frame < torch.clamp(lengths, 0, t)[:, None]
    return labels, keep


def ctc_extract(
    labels: np.ndarray, keep: np.ndarray
) -> List[Tuple[List[int], List[int]]]:
    """Host-side: per sample (token_ids, token_frames)."""
    out = []
    for b in range(labels.shape[0]):
        frames = np.nonzero(keep[b])[0]
        out.append((labels[b, frames].tolist(), frames.tolist()))
    return out
