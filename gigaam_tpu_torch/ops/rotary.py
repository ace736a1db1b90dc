"""Rotary position embedding tables + application (port of
``gigaam_tpu/ops/rotary.py``).

Inverse-frequency table with base ``pos_emb_max_len``,
``emb = concat(freqs, freqs)``, rotate-half ``[-x2, x1]``; RoPE rotates the
*pre-projection* input of the attention block (``gigaam/encoder.py:244-250``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rotary_tables(length: int, dim: int, base: float
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Precompute (cos, sin), each [length, dim] float32, on the host."""
    inv_freq = 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    t = np.arange(length, dtype=np.float64)
    freqs = np.outer(t, inv_freq)                       # [L, dim/2]
    emb = np.concatenate([freqs, freqs], axis=-1)       # [L, dim]
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """[-x2, x1] over the last dim (reference ``rtt_half``)."""
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary_wide(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                      n_heads: int) -> torch.Tensor:
    """RoPE on the flat [B, T, H*d] layout, in x's dtype; the same values
    as ``apply_rotary`` on the [B, T, H, d] view."""
    b, t, dd = x.shape
    cos_w = cos.repeat(1, n_heads).to(x.dtype)          # [T, H*d]
    sin_w = sin.repeat(1, n_heads).to(x.dtype)
    # rotate_half within each head, as slices of the [B, T, H, d] view (a
    # gather by index would cost an index_put in the backward pass)
    rot = rotate_half(x.reshape(b, t, n_heads, dd // n_heads))
    return x * cos_w + rot.reshape(b, t, dd) * sin_w


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Apply RoPE to x [B, T, H, d] with tables cos/sin [T, d]."""
    cos = cos[None, :, None, :].to(x.dtype)
    sin = sin[None, :, None, :].to(x.dtype)
    return x * cos + rotate_half(x) * sin
