"""RNN-Transducer loss (port of ``gigaam_tpu/ops/rnnt_loss.py``).

The reference calls torchaudio's ``rnnt_loss`` on the whole [B, T, U+1, V]
joint (``train_utils/module.py:106-117,146-176``).  Neither package builds
that tensor:

* ``rnnt_blank_emit_log_probs`` runs the joint in time chunks, each under
  ``torch.utils.checkpoint``, and reduces every chunk at once to the two
  numbers per lattice node the loss needs (blank and target-emit
  log-probs).  Only one chunk's [B, tc, U+1, V] lives at a time, in the
  forward and again in the backward's recompute.  The joint is fp32 with
  TF32 off, as the RNNT head is everywhere in the port.
* ``rnnt_loss_from_log_probs`` runs the forward (alpha) recursion as an
  anti-diagonal wavefront: T+U steps of [B, U+1] work.  It is a
  ``torch.autograd.Function``: the backward runs the beta recursion on the
  same diagonals and writes the gradient as arc occupancies, instead of
  autograd keeping ~T+U steps of saved tensors and replaying each.

Semantics as torchaudio's ``rnnt_loss(reduction="mean",
fused_log_softmax=True)``: log-softmax over V, blank and emit paths, the
mean over the rows that have frames.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models.heads import rnnt_joint_logits, rnnt_predict_sequence
from ..parallel.collectives import global_count
from .precision import full_fp32

# a finite stand-in for -inf: logaddexp(NEG, NEG) and its gradient stay
# finite, and NEG + any log-prob rounds back to NEG in fp32
NEG = -1e30


def rnnt_blank_emit_log_probs(
    head: Mapping[str, Any], encoded: torch.Tensor, pred_out: torch.Tensor,
    targets: torch.Tensor, blank_id: int, time_chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(blank_lp, emit_lp), each [B, T, U+1] fp32, without keeping the
    [B, T, U+1, V] joint alive.

    encoded [B, T, D]; pred_out [B, U+1, H] (the teacher-forced prediction
    net's output after the zero BOS); targets [B, U].  ``emit_lp[..., U]``
    is NEG: no emission out of the last row."""
    b = encoded.shape[0]
    u1 = pred_out.shape[1]
    tgt_idx = torch.cat([targets.long(), targets.new_full(
        (b, 1), blank_id, dtype=torch.long)], dim=1)[:, None, :, None]

    def one_chunk(enc_c: torch.Tensor, pred: torch.Tensor):
        with full_fp32():
            lp = torch.log_softmax(
                rnnt_joint_logits(head, enc_c, pred).float(), dim=-1)
        idx = tgt_idx.expand(-1, enc_c.shape[1], -1, -1)
        return lp[..., blank_id], lp.gather(-1, idx)[..., 0]

    blank, emit = [], []
    for enc_c in encoded.split(time_chunk, dim=1):
        bl, em = checkpoint(one_chunk, enc_c, pred_out, use_reentrant=False)
        blank.append(bl)
        emit.append(em)
    blank_lp, emit_lp = torch.cat(blank, dim=1), torch.cat(emit, dim=1)
    last = torch.arange(u1, device=emit_lp.device) == u1 - 1
    return blank_lp, emit_lp.masked_fill(last, NEG)


def _skew(x: torch.Tensor, n_diag: int) -> torch.Tensor:
    """x [B, T, U+1] -> [n_diag, B, U+1] with y[d, b, u] = x[b, d - u, u]
    where 0 <= d - u < T, else NEG."""
    b, t, u1 = x.shape
    d = torch.arange(n_diag, device=x.device)[:, None]
    u = torch.arange(u1, device=x.device)[None, :]
    tt = d - u                                                # [D, U+1]
    inside = (tt >= 0) & (tt < t)
    y = x[:, tt.clamp(0, t - 1), u.expand_as(tt)]             # [B, D, U+1]
    return y.masked_fill(~inside, NEG).transpose(0, 1)


def _unskew(y: torch.Tensor, t: int) -> torch.Tensor:
    """The inverse gather: y [D, B, U+1] -> x [B, t, U+1], x[b, t', u] =
    y[t' + u, b, u]."""
    u1 = y.shape[2]
    tt = torch.arange(t, device=y.device)[:, None]
    u = torch.arange(u1, device=y.device)[None, :]
    return y[tt + u, :, u.expand(t, -1)].permute(2, 0, 1)


def _shift_u(v: torch.Tensor, step: int) -> torch.Tensor:
    """v [B, U+1] moved by ``step`` along u (+1: v[u - 1] lands at u), the
    vacated column NEG."""
    fill = v.new_full((v.shape[0], 1), NEG)
    if step > 0:
        return torch.cat([fill, v[:, :-1]], dim=1)
    return torch.cat([v[:, 1:], fill], dim=1)


class _RNNTNegLogLik(torch.autograd.Function):
    """Per-row negative log-likelihood [B] of the RNNT lattice, from the
    per-node transition log-probs; the backward is the beta recursion."""

    @staticmethod
    def forward(ctx, blank_lp, emit_lp, t_len, u_len):
        b, t_max, u1 = blank_lp.shape
        n_diag = t_max + u1 - 1
        dev = blank_lp.device
        blank_d = _skew(blank_lp, n_diag)
        emit_d = _skew(emit_lp, n_diag)
        d = torch.arange(n_diag, device=dev)[:, None, None]
        u = torch.arange(u1, device=dev)[None, None, :]
        # diagonal d holds alpha(d - u, u); cells off the lattice are NEG
        inside = (d - u >= 0) & (d - u < t_max)               # [D, 1, U+1]
        neg = blank_lp.new_tensor(NEG)
        alpha = blank_lp.new_full((n_diag, b, u1), NEG)
        alpha[0, :, 0] = 0.0
        for k in range(1, n_diag):
            prev = alpha[k - 1]
            v = torch.logaddexp(prev + blank_d[k - 1],        # from (t-1, u)
                                _shift_u(prev + emit_d[k - 1], 1))  # (t, u-1)
            torch.where(inside[k], v, neg, out=alpha[k])
        rows = torch.arange(b, device=dev)
        log_z = (alpha[t_len - 1 + u_len, rows, u_len]
                 + blank_lp[rows, t_len - 1, u_len])
        ctx.save_for_backward(blank_lp, emit_lp, blank_d, emit_d, alpha,
                              log_z, t_len, u_len)
        return -log_z

    @staticmethod
    def backward(ctx, grad):
        (blank_lp, emit_lp, blank_d, emit_d, alpha, log_z, t_len,
         u_len) = ctx.saved_tensors
        n_diag, b, u1 = alpha.shape
        t_max = blank_lp.shape[1]
        dev = alpha.device
        d = torch.arange(n_diag + 1, device=dev)[:, None, None]
        u = torch.arange(u1, device=dev)[None, None, :]
        tl, ul = t_len[None, :, None], u_len[None, :, None]
        # beta(t, u): the log-sum of the paths from (t, u) to the end, the
        # final blank included, over the region t < T_b, u <= U_b; a
        # virtual node (T_b, U_b) holds 0, so that beta(T_b - 1, U_b) =
        # blank(T_b - 1, U_b)
        region = (d - u >= 0) & (d - u < tl) & (u <= ul)     # [D+1, B, U+1]
        virtual = (d == tl + ul) & (u == ul)
        neg, zero = alpha.new_tensor(NEG), alpha.new_tensor(0.0)
        beta = alpha.new_full((n_diag + 1, b, u1), NEG)
        beta[n_diag].masked_fill_(virtual[n_diag], 0.0)
        for k in range(n_diag - 1, -1, -1):
            nxt = beta[k + 1]
            v = torch.logaddexp(blank_d[k] + nxt,             # to (t+1, u)
                                emit_d[k] + _shift_u(nxt, -1))  # to (t, u+1)
            v = torch.where(region[k], v, neg)
            torch.where(virtual[k], zero, v, out=beta[k])
        a = _unskew(alpha, t_max)                              # [B, T, U+1]
        beta_grid = _unskew(beta, t_max + 1)                   # [B, T+1, U+1]
        to_blank = beta_grid[:, 1:]                            # beta(t+1, u)
        to_emit = torch.cat([beta_grid[:, :t_max, 1:],         # beta(t, u+1)
                             beta_grid.new_full((b, t_max, 1), NEG)], dim=2)
        # the arcs' occupancies, times the loss's -1 and its upstream grad,
        # on the region only (an emit arc out of (T_b, U_b - 1) would reach
        # the virtual node)
        tt = torch.arange(t_max, device=dev)[None, :, None]
        scale = torch.where((tt < t_len[:, None, None])
                            & (u <= u_len[:, None, None]),
                            -grad[:, None, None], 0.0)
        a = a - log_z[:, None, None]
        return (scale * torch.exp(a + blank_lp + to_blank),
                scale * torch.exp(a + emit_lp + to_emit), None, None)


def rnnt_loss_from_log_probs(blank_lp: torch.Tensor, emit_lp: torch.Tensor,
                             logit_lengths: torch.Tensor,
                             target_lengths: torch.Tensor) -> torch.Tensor:
    """Per-row negative log-likelihood [B] from blank_lp/emit_lp [B, T, U+1]
    (fp32), logit_lengths in [1, T] and target_lengths in [0, U]:

    alpha(t, u) = logaddexp(alpha(t-1, u) + blank(t-1, u),
                            alpha(t, u-1) + emit(t, u-1))
    loss = -(alpha(T_b - 1, U_b) + blank(T_b - 1, U_b)),

    each row ending at its own (T_b - 1, U_b)."""
    return _RNNTNegLogLik.apply(blank_lp, emit_lp, logit_lengths.long(),
                                target_lengths.long())


def rnnt_loss(head: Mapping[str, Any], encoded: torch.Tensor,
              targets: torch.Tensor, logit_lengths: torch.Tensor,
              target_lengths: torch.Tensor, blank_id: int,
              time_chunk: int = 64, group=None) -> torch.Tensor:
    """The batch-mean RNNT loss from the encoder output: the teacher-forced
    prediction net, the chunked joint and the wavefront.  encoded [B, T, D]
    (fp32); targets [B, U].  ``logit_lengths`` is clamped to [1, T] for the
    recursion and rows of zero length are left out of the mean;
    ``target_lengths`` of 0 (an empty transcript) is valid.  Under a data
    ``group`` the mean's count is the batch's (``ctc_loss``)."""
    t_max, u_max = encoded.shape[1], targets.shape[1]
    with full_fp32():
        pred_out = rnnt_predict_sequence(head, targets.long())
    blank_lp, emit_lp = rnnt_blank_emit_log_probs(
        head, encoded, pred_out, targets, blank_id, time_chunk)
    nll = rnnt_loss_from_log_probs(
        blank_lp, emit_lp, logit_lengths.clamp(1, t_max),
        target_lengths.clamp(0, u_max))
    valid = logit_lengths > 0
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / global_count(valid.sum(), group).clamp(min=1).to(
        nll.dtype)
