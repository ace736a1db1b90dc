"""Torch-compatible multi-layer LSTM as plain tensor functions (port of
``gigaam_tpu/ops/lstm.py``).

Gate packing follows torch's ``[i, f, g, o]`` row order.  Weights per
layer: ``w_ih`` [in, 4H], ``w_hh`` [H, 4H], ``b`` [4H] (torch's
``b_ih + b_hh``, pre-summed).  Both products accumulate in fp32 and the
outputs are cast back to the input's dtype.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import torch


def lstm_cell(
    p: Mapping[str, torch.Tensor],
    x: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step. x [B, in], h/c [B, H] -> (h', c').

    The operands are rounded to x's dtype, as the JAX cell casts the
    weights, then multiplied and summed in fp32 (its
    ``preferred_element_type``); for fp32 inputs the casts are no-ops."""
    dt = x.dtype
    gates = torch.addmm(p["b"].float(), x.float(), p["w_ih"].to(dt).float())
    gates.addmm_(h.to(dt).float(), p["w_hh"].to(dt).float())
    hidden = gates.shape[-1] // 4
    i, f, _, o = torch.sigmoid(gates).chunk(4, dim=-1)
    g = torch.tanh(gates[:, 2 * hidden:3 * hidden])
    c_new = torch.addcmul(f * c.float(), i, g)
    h_new = o * torch.tanh(c_new)
    return h_new.to(dt), c_new.to(dt)


def lstm_step_stacked(
    layers: Sequence[Mapping[str, torch.Tensor]],
    x: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step through L stacked layers. x [B, in]; h/c [L, B, H].

    Returns (top-layer output [B, H], h', c')."""
    hs, cs = [], []
    inp = x
    for li, p in enumerate(layers):
        h_new, c_new = lstm_cell(p, inp, h[li], c[li])
        hs.append(h_new)
        cs.append(c_new)
        inp = h_new
    return inp, torch.stack(hs), torch.stack(cs)


def lstm_sequence(
    layers: Sequence[Mapping[str, torch.Tensor]],
    xs: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A full sequence. xs [B, T, in]; h0/c0 [L, B, H].

    Returns (outputs [B, T, H], hT, cT)."""
    h, c = h0, c0
    outs = []
    for t in range(xs.shape[1]):
        out, h, c = lstm_step_stacked(layers, xs[:, t], h, c)
        outs.append(out)
    return torch.stack(outs, dim=1), h, c
