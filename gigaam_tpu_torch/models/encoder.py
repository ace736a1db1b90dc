"""Conformer encoder, inference forward (port of
``gigaam_tpu/models/encoder.py`` for the rotary (v3) generation).

* Parameters live in ``nn.ParameterDict``/``nn.ModuleDict`` trees keyed as in
  the JAX package; the JAX tree's per-layer leaves, stacked on a leading
  layer axis there, become one ``ConformerLayer`` module per layer.
* Macaron structure per layer (``gigaam/encoder.py:473-498``):
  x + 0.5*FFN -> +MHSA -> +Conv -> +0.5*FFN -> LN.
* Masks: a boolean valid [B, T'] built from subsampled lengths; attention
  masking is always applied (inputs are padded to buckets).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import EncoderConfig
from ..ops.attention import rotary_mha
from ..ops.conformer_ops import (
    conformer_conv,
    ffn,
    layer_norm,
    striding_subsampling_conv2d,
)
from ..ops.fused_attention import (
    FoldedWeights,
    folded_rotary_attention,
    folded_rotary_attention_lnres,
    prepare_folded_weights,
)
from ..ops.rotary import rotary_tables

# Attention dispatch thresholds, copied from the JAX package
# (``pallas_attention.py::_MAX_FOLD_T``, ``encoder.py::_LNRES_MIN_BATCH``).
# Both were measured on a TPU v5e and have not been re-measured on the H100:
# the Hopper fold has no VMEM bound, and whether K1 or K2 wins at a given
# batch is an open A/B on the card (ROADMAP).
_MAX_FOLD_T = 1024       # fold the attention module when T' <= this
_LNRES_MIN_BATCH = 16    # fold LN + residual too (K1) from this batch on


def as_module(tree: Dict[str, Any]) -> nn.Module:
    """A nested dict of tensors -> ``nn.ModuleDict`` of ``nn.ParameterDict``
    leaves (inference only: no parameter requires a gradient)."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({
            k: nn.Parameter(v, requires_grad=False) for k, v in tree.items()})
    if any(isinstance(v, torch.Tensor) for v in tree.values()):
        raise ValueError(f"mixed tensor/dict node: {sorted(tree)}")
    return nn.ModuleDict({k: as_module(v) for k, v in tree.items()})


class PosTables:
    """Rotary tables grown on demand (mirror of ``extend_pe``), with one
    device copy per (length, device)."""

    def __init__(self, cfg: EncoderConfig):
        self.cfg = cfg
        self._len = 0
        self._host: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._dev: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]] = {}

    def rotary(self, t: int, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cos, sin), each [t, d_head] fp32 on ``device``."""
        length = max(t, self.cfg.pos_emb_max_len)
        if length > self._len:
            self._host = rotary_tables(length, self.cfg.d_head,
                                       self.cfg.pos_emb_max_len)
            self._len = length
            self._dev.clear()
        key = (t, str(device))
        if key not in self._dev:
            cos, sin = self._host
            self._dev[key] = (torch.from_numpy(cos[:t]).to(device),
                              torch.from_numpy(sin[:t]).to(device))
        return self._dev[key]


class ConformerLayer(nn.ModuleDict):
    """One Conformer layer's parameters, plus the attention weights prepared
    once for the folded kernels (per dtype and device)."""

    def __init__(self, tree: Dict[str, Any], n_heads: int):
        super().__init__({k: as_module(v) for k, v in tree.items()})
        self.n_heads = n_heads
        self._folded: Dict[Tuple[torch.dtype, str], FoldedWeights] = {}

    def folded_weights(self, dtype: torch.dtype) -> FoldedWeights:
        key = (dtype, str(self["self_attn"]["linear_q"]["w"].device))
        if key not in self._folded:
            self._folded[key] = prepare_folded_weights(
                self["self_attn"], self["norm_self_att"], self.n_heads, dtype)
        return self._folded[key]

    def clear_prepared(self) -> None:
        self._folded.clear()


class ConformerEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig, state: Dict[str, Any]):
        super().__init__()
        if cfg.self_attention_model != "rotary" or cfg.subsampling != "conv2d":
            raise NotImplementedError(
                "only the rotary / conv2d-subsampling (v3) encoder is ported")
        self.cfg = cfg
        self.pre_encode = as_module(state["pre_encode"])
        self.layers = nn.ModuleList(
            ConformerLayer(lp, cfg.n_heads) for lp in state["layers"])

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor,
                pos: Tuple[torch.Tensor, torch.Tensor],
                compute_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        return conformer_forward(self, feats, lengths, self.cfg, pos,
                                 compute_dtype)


def _layer_forward(lp: ConformerLayer, x: torch.Tensor,
                   pos: Tuple[torch.Tensor, torch.Tensor],
                   valid: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    """One Conformer layer (``gigaam/encoder.py:473-498``), with the JAX
    package's attention dispatch (``encoder.py:301-347``):

    * T' <= _MAX_FOLD_T and batch >= _LNRES_MIN_BATCH: K1 (LN + module +
      residual in one fold);
    * T' <= _MAX_FOLD_T, smaller batch: LN, then K2 (the module fold);
    * longer T': LN, then ``rotary_mha`` with its SDPA core on K3.

    On the CPU every kernel wrapper takes its plain version.
    """
    cos, sin = pos
    b, t, _ = x.shape
    residual = x
    residual = residual + 0.5 * ffn(lp["feed_forward1"],
                                    layer_norm(lp["norm_feed_forward1"], x))
    if t <= _MAX_FOLD_T:
        w = lp.folded_weights(x.dtype)
        if b >= _LNRES_MIN_BATCH:
            residual = folded_rotary_attention_lnres(
                w, residual, cos, sin, valid, cfg.n_heads)
        else:
            y = layer_norm(lp["norm_self_att"], residual)
            residual = residual + folded_rotary_attention(
                w, y, cos, sin, valid, cfg.n_heads)
    else:
        y = layer_norm(lp["norm_self_att"], residual)
        residual = residual + rotary_mha(lp["self_attn"], y, cos, sin, valid,
                                         cfg.n_heads, use_fused=True)

    y = layer_norm(lp["norm_conv"], residual)
    residual = residual + conformer_conv(lp["conv"], y, valid,
                                         cfg.conv_norm_type)
    y = ffn(lp["feed_forward2"], layer_norm(lp["norm_feed_forward2"], residual))
    residual = residual + 0.5 * y
    return layer_norm(lp["norm_out"], residual)


def conformer_forward(encoder: ConformerEncoder, feats: torch.Tensor,
                      lengths: torch.Tensor, cfg: EncoderConfig,
                      pos: Tuple[torch.Tensor, torch.Tensor],
                      compute_dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats [B, T, F] (time-major), lengths [B] in feature frames, pos =
    (cos, sin) sliced to T'.  Returns (encoded [B, T', D], out_lengths [B])."""
    x, out_len = striding_subsampling_conv2d(
        encoder.pre_encode, feats.to(compute_dtype), lengths,
        cfg.num_subsampling_stages, cfg.subs_kernel_size)
    t = x.shape[1]
    valid = torch.arange(t, device=x.device)[None, :] < out_len[:, None]
    for lp in encoder.layers:
        x = _layer_forward(lp, x, pos, valid, cfg)
    return x, out_len


# ---------------------------------------------------------------------------
# Random init (torch-style uniform bounds, as the JAX package's init)
# ---------------------------------------------------------------------------

def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def init_linear(gen: torch.Generator, d_in: int, d_out: int
                ) -> Dict[str, torch.Tensor]:
    bound = 1.0 / math.sqrt(d_in)
    return {"w": _uniform(gen, (d_in, d_out), bound),
            "b": _uniform(gen, (d_out,), bound)}


def _init_norm(d: int) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


def _init_layer(gen: torch.Generator, cfg: EncoderConfig) -> Dict[str, Any]:
    d, k = cfg.d_model, cfg.conv_kernel_size
    dw_bound = 1.0 / math.sqrt(k)
    pc1 = init_linear(gen, d, 2 * d)
    ffn_p = lambda: {"linear1": init_linear(gen, d, cfg.d_ff),
                     "linear2": init_linear(gen, cfg.d_ff, d)}
    return {
        "norm_feed_forward1": _init_norm(d),
        "feed_forward1": ffn_p(),
        "norm_self_att": _init_norm(d),
        "self_attn": {name: init_linear(gen, d, d) for name in
                      ("linear_q", "linear_k", "linear_v", "linear_out")},
        "norm_conv": _init_norm(d),
        "conv": {
            "pointwise_conv1": {
                "w_value": pc1["w"][:, :d].contiguous(),
                "w_gate": pc1["w"][:, d:].contiguous(),
                "b_value": pc1["b"][:d].contiguous(),
                "b_gate": pc1["b"][d:].contiguous()},
            "depthwise_conv": {"w": _uniform(gen, (d, 1, k), dw_bound),
                               "b": _uniform(gen, (d,), dw_bound)},
            "pointwise_conv2": init_linear(gen, d, d),
            "batch_norm": dict(_init_norm(d), mean=torch.zeros(d),
                               var=torch.ones(d)),
        },
        "norm_feed_forward2": _init_norm(d),
        "feed_forward2": ffn_p(),
        "norm_out": _init_norm(d),
    }


def init_encoder_state(gen: torch.Generator, cfg: EncoderConfig
                       ) -> Dict[str, Any]:
    """Random encoder weights in the port's layout.  The values differ from
    the JAX package's ``PRNGKey`` init; tests share weights through
    ``weights.params_from_jax`` instead."""
    pre: Dict[str, Any] = {}
    in_ch, ks = 1, cfg.subs_kernel_size
    for i in range(cfg.num_subsampling_stages):
        bound = 1.0 / math.sqrt(in_ch * ks * ks)
        pre[f"conv_{i}"] = {"w": _uniform(gen, (cfg.d_model, in_ch, ks, ks),
                                          bound),
                            "b": _uniform(gen, (cfg.d_model,), bound)}
        in_ch = cfg.d_model
    f_out = cfg.feat_in
    for _ in range(cfg.num_subsampling_stages):
        f_out = (f_out - 1) // 2 + 1
    pre["out"] = init_linear(gen, cfg.d_model * f_out, cfg.d_model)
    return {"pre_encode": pre,
            "layers": [_init_layer(gen, cfg) for _ in range(cfg.n_layers)]}
