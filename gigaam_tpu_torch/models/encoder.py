"""Conformer encoder, inference and training forward (port of
``gigaam_tpu/models/encoder.py``): the rotary (v3) and the rel-pos (v1/v2)
generations, with conv2d or conv1d subsampling.

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
import threading
from functools import partial
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..config import EncoderConfig
from ..ops.attention import relpos_mha, rotary_mha
from ..ops.conformer_ops import (
    conformer_conv,
    ffn,
    layer_norm,
    striding_subsampling_conv1d,
    striding_subsampling_conv2d,
)
from ..ops.fused_attention import (
    FoldedWeights,
    folded_rotary_attention,
    folded_rotary_attention_lnres,
    prepare_folded_weights,
)
from ..ops.rotary import rotary_tables

# Attention dispatch thresholds, measured on the card (NVIDIA H100 80GB HBM3,
# 700 W; chip_smoke.py's dispatch A/B, device time per call of the attention
# sub-block).  The JAX package's values (1024 and 16, pallas_attention.py::
# _MAX_FOLD_T, encoder.py::_LNRES_MIN_BATCH) were a TPU v5e's VMEM bound and
# timings.  On the H100 the fold (K2) took 0.60-0.79 of the composed path's
# time (F.linear projections around K3) at every T' measured, 1024 to 3000,
# batch 1 and 8, so it folds up to the longest T' measured; K1 took
# 0.57-0.64 of LN + K2 + the residual add at every batch measured, 1 to 32
# (T' 500), so it runs from batch 2 on.  Batch 1 keeps K2, which is its
# only main path (K1 would save ~0.03 ms a layer there: ROADMAP, Queue 2).
# The gate reads the batch this process runs: under data-parallel inference
# (``GigaAM.set_mesh``) that is the per-rank block of rows, so a global batch
# of 2 over 2 ranks takes K2 on each rank and a batch of 3 (padded to 4)
# takes K1.  The JAX package gated on the global batch
# (``gigaam_tpu/models/encoder.py:284``) while each device ran its block.
_MAX_FOLD_T = 3000       # fold the attention module when T' <= this
_LNRES_MIN_BATCH = 2     # fold LN + residual too (K1) from this batch on

# the positional input of a forward: (cos, sin) [T', d_head] for rotary, the
# [2T'-1, D] table for rel-pos; both fp32
Pos = Union[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]


class MixedDict(nn.ModuleDict):
    """A ``ModuleDict`` that also holds tensor leaves, as parameters indexed
    like the dict it came from (the rel-pos attention node holds
    ``pos_bias_u``/``pos_bias_v`` beside its ``linear_*`` nodes)."""

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return super().__getitem__(key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or super().__contains__(key)


def as_module(tree: Union[Dict[str, Any], list]) -> nn.Module:
    """A nested dict of tensors -> ``nn.ModuleDict`` of ``nn.ParameterDict``
    leaves, ``MixedDict`` where a node holds both, ``nn.ModuleList`` for a
    list (the RNNT predictor's LSTM layers, in order).  No parameter
    requires a gradient: a trainer switches that on for the leaves it
    updates."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList([as_module(v) for v in tree])
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({
            k: nn.Parameter(v, requires_grad=False) for k, v in tree.items()})
    if not any(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ModuleDict({k: as_module(v) for k, v in tree.items()})
    node = MixedDict({k: as_module(v) for k, v in tree.items()
                      if not isinstance(v, torch.Tensor)})
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            node.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return node


def relpos_table(length: int, dim: int) -> np.ndarray:
    """Sinusoidal relative-position table [2L-1, dim]; index i holds
    position L-1-i (reference ``gigaam/encoder.py:312-327``)."""
    positions = np.arange(length - 1, -length, -1, dtype=np.float64)[:, None]
    pe = np.zeros((2 * length - 1, dim), dtype=np.float64)
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float64)
                      * -(math.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(positions * div_term)
    pe[:, 1::2] = np.cos(positions * div_term)
    return pe.astype(np.float32)


class PosTables:
    """Positional tables grown on demand (mirror of ``extend_pe``), with one
    device copy per (kind, length, device).  Each kind keeps its own host
    table and length, so growing one never hides or shrinks the other.

    Safe to share between threads, as the JAX package's tables are
    (``gigaam_tpu/models/encoder.py:60-110``): growth and the device copies
    are made under one lock, and each call returns the value it found or
    built, never a second read of the cache that another thread's growth
    may have emptied."""

    def __init__(self, cfg: EncoderConfig):
        self.cfg = cfg
        self._host: Dict[str, Tuple[int, Any]] = {}
        self._dev: Dict[Tuple[str, int, str], Pos] = {}
        self._lock = threading.Lock()

    def _table(self, kind: str, t: int) -> Tuple[int, Any]:
        """(length, host table) of ``kind``, grown to cover ``t``.  Called
        with the lock held."""
        length = max(t, self.cfg.pos_emb_max_len)
        have = self._host.get(kind)
        if have is None or length > have[0]:
            table = (rotary_tables(length, self.cfg.d_head,
                                   self.cfg.pos_emb_max_len)
                     if kind == "rotary"
                     else relpos_table(length, self.cfg.d_model))
            have = self._host[kind] = (length, table)
            for key in [k for k in self._dev if k[0] == kind]:
                del self._dev[key]
        return have

    def _get(self, kind: str, t: int, device: torch.device, build) -> Pos:
        key = (kind, t, str(device))
        have = self._dev.get(key)
        if have is not None:
            return have
        with self._lock:
            have = self._dev.get(key)
            if have is None:
                # a table first asked for under inference_mode is later
                # saved for backward by a train step: keep it an ordinary
                # tensor
                with torch.inference_mode(False):
                    have = build(self._table(kind, t))
                self._dev[key] = have
        return have

    def rotary(self, t: int, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cos, sin), each [t, d_head] fp32 on ``device``."""
        return self._get("rotary", t, device, lambda have: tuple(
            torch.from_numpy(a[:t]).to(device) for a in have[1]))

    def relpos(self, t: int, device: torch.device) -> torch.Tensor:
        """[2t-1, d_model] fp32 on ``device``: positions t-1 .. -(t-1), the
        rows [L-t, L+t-1) of the length-L table."""
        return self._get("rel_pos", t, device, lambda have: torch.from_numpy(
            have[1][have[0] - t: have[0] + t - 1]).to(device))


class ConformerLayer(nn.ModuleDict):
    """One Conformer layer's parameters, plus the attention weights prepared
    for the folded kernels (per dtype and device) and prepared again
    whenever one of their source parameters has changed."""

    _FOLDED_SOURCES = tuple(("self_attn", lin, leaf)
                            for lin in ("linear_q", "linear_k", "linear_v",
                                        "linear_out")
                            for leaf in ("w", "b")) + (
        ("norm_self_att", "scale"), ("norm_self_att", "bias"))

    def __init__(self, tree: Dict[str, Any], n_heads: int):
        super().__init__({k: as_module(v) for k, v in tree.items()})
        self.n_heads = n_heads
        self._folded: Dict[Tuple[torch.dtype, str],
                           Tuple[tuple, FoldedWeights]] = {}

    def _folded_stamp(self) -> tuple:
        """Storage and version of every parameter the fold reads: an
        in-place update (an optimizer step, a checkpoint restore) bumps the
        version, a cast replaces the storage."""
        stamp = []
        for path in self._FOLDED_SOURCES:
            node = self
            for key in path:
                node = node[key]
            stamp.append((node.data_ptr(), node._version))
        return tuple(stamp)

    def folded_weights(self, dtype: torch.dtype) -> FoldedWeights:
        key = (dtype, str(self["self_attn"]["linear_q"]["w"].device))
        stamp = self._folded_stamp()
        have = self._folded.get(key)
        if have is None or have[0] != stamp:
            with torch.no_grad():
                have = self._folded[key] = (stamp, prepare_folded_weights(
                    self["self_attn"], self["norm_self_att"], self.n_heads,
                    dtype))
        return have[1]

    def clear_prepared(self) -> None:
        self._folded.clear()


class ConformerEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig, state: Dict[str, Any]):
        super().__init__()
        if cfg.subsampling not in ("conv1d", "conv2d"):
            raise ValueError(f"unknown subsampling {cfg.subsampling!r}")
        self.cfg = cfg
        self.pre_encode = as_module(state["pre_encode"])
        self.layers = nn.ModuleList(
            ConformerLayer(lp, cfg.n_heads) for lp in state["layers"])
        # the "model" group when the weights are this rank's tensor-parallel
        # shard (``parallel.mesh.shard_model``)
        self.tp_group = None

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor, pos: Pos,
                compute_dtype: torch.dtype, use_fused: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The inference forward: (encoded, out_lengths)."""
        return conformer_forward(self, feats, lengths, self.cfg, pos,
                                 compute_dtype, use_fused=use_fused)[:2]


BNStats = Optional[Dict[str, torch.Tensor]]

REMAT_POLICIES = ("full", "dots")
# the 2-D products: a [B, T, D] @ [D, O] ``linear`` dispatches to one of
# these; the attention's batched products (``aten.bmm``) and its kernels
# are not among them
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat_policy="dots"``, the counterpart of JAX's
    ``dots_with_no_batch_dims_saveable``: keep the outputs of the products
    without batch dimensions, recompute everything else in the backward."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _layer_forward(lp: ConformerLayer, x: torch.Tensor, pos: Pos,
                   valid: torch.Tensor, cfg: EncoderConfig, train: bool,
                   bn_train: bool, use_fused: bool = True,
                   folded: Optional[FoldedWeights] = None, tp=None,
                   bn_group=None) -> Tuple[torch.Tensor, BNStats]:
    """One Conformer layer (``gigaam/encoder.py:473-498``), with the JAX
    package's attention dispatch (``encoder.py:301-347``):

    * rel-pos: LN, then ``relpos_mha`` with its core on K5 (the folds are
      rotary-only, as in the JAX package); K6 is K5's gradient;
    * rotary, ``train``: LN, then ``rotary_mha`` with its SDPA core on K3
      at every T', whose gradient is K4 (the folds are inference kernels);
    * rotary, T' <= _MAX_FOLD_T and batch >= _LNRES_MIN_BATCH: K1 (LN +
      module + residual in one fold);
    * rotary, T' <= _MAX_FOLD_T, smaller batch: LN, then K2 (the module
      fold);
    * rotary, longer T': LN, then ``rotary_mha`` with its SDPA core on K3;
    * ``use_fused=False`` (the caller's choice, ``GigaAM``'s
      ``use_fused_attention``): LN, then ``rotary_mha``/``relpos_mha``
      composed of PyTorch ops, no kernel of ours.

    ``folded`` gives K1/K2 their prepared weights instead of the layer's
    cache (``ConformerLayer.folded_weights``): an exported graph holds them
    as its own buffers (``export.py``).

    ``bn_train`` makes the conv module's BatchNorm use batch statistics; a
    trainer with a frozen encoder passes ``train`` without it.  Returns (x, that BatchNorm's new running stats or None).  On the CPU
    every kernel wrapper takes its plain version.

    ``tp`` (the "model" group; ``lp`` holds this rank's shard) runs the
    layer tensor-parallel: the FFNs, the attention on H/m heads and the
    conv module on C/m channels, each summed over ``tp`` before its bias
    and the residual; LayerNorm on the full, replicated width.  The
    rotary module then takes the composed path with its core on K3 in
    inference too: K1 adds the output bias and the residual inside its
    GEMM, and K1/K2 hold square [D, D] weights.  ``bn_group`` (the "data"
    group) makes the BatchNorm sync-BN (``batch_norm_train``).
    """
    b, t, _ = x.shape
    residual = x
    residual = residual + 0.5 * ffn(lp["feed_forward1"],
                                    layer_norm(lp["norm_feed_forward1"], x),
                                    tp)
    if cfg.self_attention_model == "rel_pos":
        y = layer_norm(lp["norm_self_att"], residual)
        residual = residual + relpos_mha(lp["self_attn"], y, pos, valid,
                                         cfg.n_heads, use_fused=use_fused,
                                         tp=tp)
    elif use_fused and t <= _MAX_FOLD_T and not train and tp is None:
        cos, sin = pos
        w = folded if folded is not None else lp.folded_weights(x.dtype)
        if b >= _LNRES_MIN_BATCH:
            residual = folded_rotary_attention_lnres(
                w, residual, cos, sin, valid, cfg.n_heads)
        else:
            y = layer_norm(lp["norm_self_att"], residual)
            residual = residual + folded_rotary_attention(
                w, y, cos, sin, valid, cfg.n_heads)
    else:
        y = layer_norm(lp["norm_self_att"], residual)
        cos, sin = pos
        residual = residual + rotary_mha(lp["self_attn"], y, cos, sin, valid,
                                         cfg.n_heads, use_fused=use_fused,
                                         tp=tp)

    y = layer_norm(lp["norm_conv"], residual)
    y, new_stats = conformer_conv(lp["conv"], y, valid, cfg.conv_norm_type,
                                  train=bn_train, tp=tp, bn_group=bn_group)
    residual = residual + y
    y = ffn(lp["feed_forward2"], layer_norm(lp["norm_feed_forward2"], residual),
            tp)
    residual = residual + 0.5 * y
    return layer_norm(lp["norm_out"], residual), new_stats


def conformer_forward(encoder: ConformerEncoder, feats: torch.Tensor,
                      lengths: torch.Tensor, cfg: EncoderConfig, pos: Pos,
                      compute_dtype: torch.dtype = torch.float32,
                      train: bool = False, bn_train: Optional[bool] = None,
                      use_fused: bool = True,
                      folded: Optional[Sequence[FoldedWeights]] = None,
                      bn_group=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, BNStats]:
    """feats [B, T, F] (time-major), lengths [B] in feature frames, pos =
    (cos, sin) sliced to T' for rotary, or the [2T'-1, D] table for
    rel-pos.  ``train`` takes the differentiable attention path;
    ``bn_train`` (``train`` unless given) switches BatchNorm to batch
    statistics; ``use_fused=False`` keeps the attention off the kernels
    (``_layer_forward``); ``folded`` holds each layer's prepared K1/K2
    weights in place of the layers' caches; ``bn_group`` is the "data"
    group of sync-BN.  An encoder holding a tensor-parallel shard
    (``encoder.tp_group``) runs every layer and the subsampling over it.  Returns (encoded [B, T', D],
    out_lengths [B], new BatchNorm stats): with ``bn_train`` and a
    batch-norm conv module the stats are ``{"mean", "var"}``, each [n_layers, D], stacked on a layer axis as the
    JAX package's layer scan returns them; else None.

    ``cfg.activation_checkpointing`` (under ``train``) recomputes each
    layer's forward in the backward pass instead of keeping its
    activations: all of it under ``remat_policy="full"``; under ``"dots"``
    all but the 2-D products' outputs (``save_dots``)."""
    subsample = (striding_subsampling_conv2d if cfg.subsampling == "conv2d"
                 else striding_subsampling_conv1d)
    tp = encoder.tp_group
    x, out_len = subsample(
        encoder.pre_encode, feats.to(compute_dtype), lengths,
        cfg.num_subsampling_stages, cfg.subs_kernel_size, tp=tp)
    t = x.shape[1]
    valid = torch.arange(t, device=x.device)[None, :] < out_len[:, None]
    remat = cfg.activation_checkpointing and train
    if remat and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                         f"got {cfg.remat_policy!r}")
    bn_train = train if bn_train is None else bn_train
    stats = []
    for i, lp in enumerate(encoder.layers):
        if remat:
            kw = ({} if cfg.remat_policy == "full" else {"context_fn": partial(
                create_selective_checkpoint_contexts, save_dots)})
            x, new_stats = checkpoint(_layer_forward, lp, x, pos, valid, cfg,
                                      train, bn_train, use_fused, None, tp,
                                      bn_group, use_reentrant=False, **kw)
        else:
            x, new_stats = _layer_forward(
                lp, x, pos, valid, cfg, train, bn_train, use_fused,
                None if folded is None else folded[i], tp, bn_group)
        stats.append(new_stats)
    bn_stats = None
    if bn_train and cfg.conv_norm_type == "batch_norm":
        bn_stats = {k: torch.stack([s[k] for s in stats])
                    for k in ("mean", "var")}
    return x, out_len, bn_stats


# ---------------------------------------------------------------------------
# Random init (torch-style uniform bounds, as the JAX package's init)
# ---------------------------------------------------------------------------

def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                bias: bool = True) -> Dict[str, torch.Tensor]:
    bound = 1.0 / math.sqrt(d_in)
    p = {"w": _uniform(gen, (d_in, d_out), bound)}
    if bias:
        p["b"] = _uniform(gen, (d_out,), bound)
    return p


def _init_attention(gen: torch.Generator, cfg: EncoderConfig
                    ) -> Dict[str, Any]:
    """As ``_init_attention`` of the JAX package: rel-pos adds
    ``linear_pos`` (no bias) and zero ``pos_bias_u``/``pos_bias_v``."""
    d = cfg.d_model
    p: Dict[str, Any] = {name: init_linear(gen, d, d) for name in
                         ("linear_q", "linear_k", "linear_v", "linear_out")}
    if cfg.self_attention_model == "rel_pos":
        p["linear_pos"] = init_linear(gen, d, d, bias=False)
        p["pos_bias_u"] = torch.zeros(cfg.n_heads, cfg.d_head)
        p["pos_bias_v"] = torch.zeros(cfg.n_heads, cfg.d_head)
    return p


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
        "self_attn": _init_attention(gen, cfg),
        "norm_conv": _init_norm(d),
        "conv": {
            "pointwise_conv1": {
                "w_value": pc1["w"][:, :d].contiguous(),
                "w_gate": pc1["w"][:, d:].contiguous(),
                # copies, not views of one storage (a saved program
                # stores each tensor whole)
                "b_value": pc1["b"][:d].clone(),
                "b_gate": pc1["b"][d:].clone()},
            "depthwise_conv": {"w": _uniform(gen, (d, 1, k), dw_bound),
                               "b": _uniform(gen, (d,), dw_bound)},
            "pointwise_conv2": init_linear(gen, d, d),
            # running stats only for a BatchNorm, as the JAX init
            "batch_norm": (dict(_init_norm(d), mean=torch.zeros(d),
                                var=torch.ones(d))
                           if cfg.conv_norm_type == "batch_norm"
                           else _init_norm(d)),
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
    conv2d = cfg.subsampling == "conv2d"
    kernel = (cfg.subs_kernel_size,) * (2 if conv2d else 1)
    in_ch = 1 if conv2d else cfg.feat_in
    for i in range(cfg.num_subsampling_stages):
        bound = 1.0 / math.sqrt(in_ch * math.prod(kernel))
        pre[f"conv_{i}"] = {"w": _uniform(gen, (cfg.d_model, in_ch, *kernel),
                                          bound),
                            "b": _uniform(gen, (cfg.d_model,), bound)}
        in_ch = cfg.d_model
    if conv2d:
        f_out = cfg.feat_in
        for _ in range(cfg.num_subsampling_stages):
            f_out = (f_out - 1) // 2 + 1
        pre["out"] = init_linear(gen, cfg.d_model * f_out, cfg.d_model)
    return {"pre_encode": pre,
            "layers": [_init_layer(gen, cfg) for _ in range(cfg.n_layers)]}
