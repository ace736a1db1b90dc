"""CTC, RNNT and emotion heads (port of ``gigaam_tpu/models/heads.py``).

* CTC: the reference's 1x1 Conv1d (``gigaam/decoder.py:7-21``) is a plain
  matmul.
* RNNT prediction network: an embedding whose blank row is zero
  (``padding_idx``), so embedding the blank id is the reference's
  ``predict(None)`` zero input (``decoder.py:85-102``), then the stacked
  LSTM of ``ops/lstm.py``.
* RNNT joint: enc [.., J] + pred [.., J] -> ReLU -> out, in fp32
  (``decoder.py:41-47``); the encoder-side projection can be hoisted out
  of a decode loop (``rnnt_joint_enc_proj``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import torch

from ..config import RNNTHeadConfig
from ..ops.conformer_ops import Params, linear
from ..ops.lstm import lstm_sequence, lstm_step_stacked
from .encoder import _uniform, init_linear


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


def init_rnnt_head(gen: torch.Generator, cfg: RNNTHeadConfig
                   ) -> Dict[str, Any]:
    """Random RNNT head weights with the JAX package's distributions
    (``init_rnnt_head``): the embedding N(0, 1) with the blank row zero,
    each LSTM weight U(+-1/sqrt(H)), the bias the sum of two such uniforms
    (torch's separate ``b_ih`` and ``b_hh``), the joint's linears
    U(+-1/sqrt(in))."""
    dec, jnt = cfg.decoder, cfg.joint
    embed = torch.randn((dec.num_classes, dec.pred_hidden), generator=gen)
    embed[dec.num_classes - 1] = 0.0
    h = dec.pred_hidden
    bound = 1.0 / math.sqrt(h)
    layers = [{"w_ih": _uniform(gen, (h, 4 * h), bound),
               "w_hh": _uniform(gen, (h, 4 * h), bound),
               "b": (_uniform(gen, (4 * h,), bound)
                     + _uniform(gen, (4 * h,), bound))}
              for _ in range(dec.pred_rnn_layers)]
    return {"decoder": {"embed": embed, "lstm": layers},
            "joint": {"enc": init_linear(gen, jnt.enc_hidden,
                                         jnt.joint_hidden),
                      "pred": init_linear(gen, jnt.pred_hidden,
                                          jnt.joint_hidden),
                      "out": init_linear(gen, jnt.joint_hidden,
                                         jnt.num_classes)}}


def rnnt_predict_step(params: Mapping[str, Any], labels: torch.Tensor,
                      h: torch.Tensor, c: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One prediction-network step. labels [B] (int); h/c [L, B, H] ->
    (output [B, H], h', c').  The blank id embeds to zeros."""
    emb = params["decoder"]["embed"][labels]
    return lstm_step_stacked(params["decoder"]["lstm"], emb, h, c)


def rnnt_predict_sequence(params: Mapping[str, Any], tokens: torch.Tensor
                          ) -> torch.Tensor:
    """Teacher-forced prediction net: tokens [B, U] -> outputs [B, U+1, H],
    after a zero-vector BOS (reference ``train_utils/module.py:130-144``)."""
    emb = params["decoder"]["embed"][tokens]
    bos = emb.new_zeros((emb.shape[0], 1, emb.shape[2]))
    inp = torch.cat([bos, emb], dim=1)
    h0 = emb.new_zeros((len(params["decoder"]["lstm"]), emb.shape[0],
                        emb.shape[2]))
    out, _, _ = lstm_sequence(params["decoder"]["lstm"], inp, h0, h0)
    return out


def rnnt_joint_step(params: Mapping[str, Any], enc_t: torch.Tensor,
                    pred: torch.Tensor) -> torch.Tensor:
    """Single-frame joint: enc_t [B, D], pred [B, H] -> log_probs [B, V]."""
    j = params["joint"]
    return rnnt_joint_step_preproj(params, linear(j["enc"], enc_t), pred)


def rnnt_joint_enc_proj(params: Mapping[str, Any], encoded: torch.Tensor
                        ) -> torch.Tensor:
    """The encoder side of the joint, hoisted out of the decode loop:
    [B, T, D] -> [B, T, J]."""
    return linear(params["joint"]["enc"], encoded)


def rnnt_joint_step_preproj(params: Mapping[str, Any],
                            enc_proj_t: torch.Tensor, pred: torch.Tensor
                            ) -> torch.Tensor:
    """Joint from a pre-projected encoder frame [B, J] and pred [B, H] ->
    fp32 log_probs [B, V]."""
    j = params["joint"]
    x = enc_proj_t + linear(j["pred"], pred)
    logits = linear(j["out"], torch.relu(x)).float()
    return torch.log_softmax(logits, dim=-1)


def rnnt_joint_logits(params: Mapping[str, Any], encoded: torch.Tensor,
                      pred_out: torch.Tensor) -> torch.Tensor:
    """The full lattice for training: [B, T, D] x [B, U+1, H] ->
    [B, T, U+1, V]."""
    j = params["joint"]
    enc = linear(j["enc"], encoded)[:, :, None, :]
    pred = linear(j["pred"], pred_out)[:, None, :, :]
    return linear(j["out"], torch.relu(enc + pred))


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
