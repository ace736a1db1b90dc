"""Multi-head self-attention (port of ``gigaam_tpu/ops/attention.py``).

* ``rotary_mha`` (v3): RoPE is applied to the *pre-projection* input for Q
  and K (faithful to ``gigaam/encoder.py:244-256``); V projects the
  un-rotated input.
* ``relpos_mha`` (v1/v2): Transformer-XL relative-position attention with
  the pad/reshape ``rel_shift`` (``gigaam/encoder.py:202-206``).

Masking: a boolean *valid* mask [B, T] (True = real frame); invalid score
entries get a finite -1e9 before the softmax, so padded query rows are
finite garbage, never NaN.

Weights layout: Linear weights are [in, out] (``x @ w + b``).

Tensor parallelism (``tp``, the "model" group of ``parallel/mesh.py``): the
rank holds H/m heads (Q/K/V columns, ``linear_pos`` columns and
``pos_bias_u``/``pos_bias_v`` rows), runs the SDPA core on them, and the
output projection is row-parallel, its bias added once after the reduce.
RoPE rotates the replicated input over all H heads, as one process does.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from ..parallel.collectives import copy_to_model, reduce_from_model
from .conformer_ops import Params, linear
from .rotary import apply_rotary_wide

NEG_INF = -1e9


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, T, D] -> [B, H, T, d]"""
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).transpose(1, 2)


def _out_proj(p: Params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Output projection straight off the [B, H, T, d] head layout:
    ``sum_h x[:, h] @ w[h]``, the merge-transpose folded into the matmul;
    under ``tp`` summed over the ranks' heads before the bias."""
    b, h, t, d = x.shape
    w = p["w"].reshape(h, d, -1).to(x.dtype)
    y = reduce_from_model(torch.einsum("bhtd,hdk->btk", x, w), tp)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _masked_softmax(scores: torch.Tensor,
                    valid: Optional[torch.Tensor]) -> torch.Tensor:
    """scores [B, H, Tq, Tk]; valid [B, T] -> softmax over Tk in fp32."""
    if valid is not None:
        pair = valid[:, None, None, :] & valid[:, None, :, None]
        scores = torch.where(pair, scores,
                             torch.full((), NEG_INF, dtype=scores.dtype,
                                        device=scores.device))
    return torch.softmax(scores.float(), dim=-1).to(scores.dtype)


def rotary_mha(
    params: Mapping[str, Params],
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    valid: Optional[torch.Tensor],
    n_heads: int,
    use_fused: bool = False,
    tp=None,
) -> torch.Tensor:
    """Rotary self-attention. x [B, T, D]; cos/sin [T, d_head] fp32.

    ``use_fused`` routes the SDPA core through the hand-written kernel
    ``ops.fused_attention.fused_mha`` (K3); the projections stay
    ``torch.matmul``, as they were XLA ops around the Pallas kernel.
    ``n_heads`` counts all heads, also under ``tp``.
    """
    b, t, d = x.shape
    x = copy_to_model(x, tp)
    xr = apply_rotary_wide(x, cos, sin, n_heads)
    heads = _local_heads(n_heads, tp)
    q = _split_heads(linear(params["linear_q"], xr), heads)
    k = _split_heads(linear(params["linear_k"], xr), heads)
    v = _split_heads(linear(params["linear_v"], x), heads)

    if use_fused:
        from .fused_attention import fused_mha

        valid_b = (torch.ones((b, t), dtype=torch.bool, device=x.device)
                   if valid is None else valid)
        out = fused_mha(q.contiguous(), k.contiguous(), v.contiguous(),
                        valid_b)
        return _out_proj(params["linear_out"], out, tp)

    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = (q.float() @ k.float().transpose(-1, -2)) * scale
    attn = _masked_softmax(scores, valid).to(v.dtype)
    out = (attn.float() @ v.float()).to(x.dtype)
    return _out_proj(params["linear_out"], out, tp)


def _local_heads(n_heads: int, tp) -> int:
    return n_heads if tp is None else (
        n_heads // torch.distributed.get_world_size(tp))


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift (``gigaam/encoder.py:202-206``).

    x: [B, H, Tq, P] with P = 2*Tq - 1 -> shifted [B, H, Tq, P].
    """
    b, h, q, p = x.shape
    x = F.pad(x, (1, 0)).reshape(b, h, p + 1, q)
    return x[:, :, 1:].reshape(b, h, q, p)


def relpos_mha(
    params: Mapping[str, Params],
    x: torch.Tensor,
    pos_emb: torch.Tensor,
    valid: Optional[torch.Tensor],
    n_heads: int,
    use_fused: bool = False,
    tp=None,
) -> torch.Tensor:
    """Relative-position self-attention (v1/v2).  x [B, T, D]; pos_emb
    [2T-1, D] fp32 (positions T-1 .. -(T-1)); ``n_heads`` counts all
    heads, also under ``tp``.

    ``use_fused`` routes the scores, the shift and the softmax through the
    hand-written kernel ``ops.fused_attention.fused_relpos_mha`` (K5); the
    Q/K/V/position and output projections stay ``torch.matmul``, as they
    were XLA ops around the Pallas kernel.  The composed branch is the
    JAX package's: fp32 ``matrix_ac + rel_shift(matrix_bd)``, pair mask.
    """
    b, t, d = x.shape
    d_head = d // n_heads
    n_heads = _local_heads(n_heads, tp)
    x = copy_to_model(x, tp)
    q = _split_heads(linear(params["linear_q"], x), n_heads)
    k = _split_heads(linear(params["linear_k"], x), n_heads)
    v = _split_heads(linear(params["linear_v"], x), n_heads)

    p = linear(params["linear_pos"], pos_emb.to(x.dtype))          # [P, D]
    p = p.reshape(-1, n_heads, d_head).transpose(0, 1)             # [H, P, d]

    q_u = q + params["pos_bias_u"].to(x.dtype)[None, :, None, :]
    q_v = q + params["pos_bias_v"].to(x.dtype)[None, :, None, :]

    if use_fused:
        from .fused_attention import fused_relpos_mha

        valid_b = (torch.ones((b, t), dtype=torch.bool, device=x.device)
                   if valid is None else valid)
        out = fused_relpos_mha(q_u.contiguous(), k.contiguous(),
                               v.contiguous(), q_v.contiguous(),
                               p.contiguous(), valid_b)
        return _out_proj(params["linear_out"], out, tp)

    scale = 1.0 / math.sqrt(d_head)
    matrix_bd = rel_shift(q_v.float() @ p.float().transpose(-1, -2))[..., :t]
    matrix_ac = q_u.float() @ k.float().transpose(-1, -2)
    scores = (matrix_ac + matrix_bd) * scale
    attn = _masked_softmax(scores, valid).to(v.dtype)
    out = (attn.float() @ v.float()).to(x.dtype)
    return _out_proj(params["linear_out"], out, tp)
