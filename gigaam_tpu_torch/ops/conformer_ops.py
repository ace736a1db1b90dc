"""Conformer building blocks: LayerNorm/BatchNorm, FFN, conv module,
striding subsampling (port of ``gigaam_tpu/ops/conformer_ops.py``).

These were XLA ops in the JAX package, outside any Pallas kernel, so they
run on PyTorch's own ops (``torch.matmul``, ``F.conv1d``, ``F.conv2d``).
Parameters arrive as dict-like nodes (``nn.ParameterDict``) keyed as in the
JAX tree.

Weights layout (``weights.py`` converts from the JAX package):
* Linear: w [in, out], b [out]  (unchanged: ``x @ w + b``)
* Conv1d depthwise: w [C, 1, K]  (JAX [K, 1, C])
* Conv2d: w [Cout, Cin, Kh, Kw]  (JAX [Kh, Kw, Cin, Cout])
* Conv1d subsampling: w [Cout, Cin, K]  (JAX [K, Cin, Cout])

Tensor parallelism (``tp``, the "model" group of ``parallel/mesh.py``):
the parameters are this rank's shards.  A column-parallel product takes its
replicated input through ``copy_to_model``; a row-parallel one leaves out
its bias, and the bias is added once after ``reduce_from_model``.  With
``tp`` None both collectives return their input, so one process runs the
same code.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.collectives import (
    all_reduce_sum,
    copy_to_model,
    reduce_from_model,
)

Params = Mapping[str, torch.Tensor]


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim; statistics in fp32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def batch_norm_infer(p: Params, x: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm over the channel (last) dim, folded to an affine
    transform from the running stats."""
    inv = torch.rsqrt(p["var"].float() + eps)
    scale = p["scale"].float() * inv
    bias = p["bias"].float() - p["mean"].float() * p["scale"].float() * inv
    return x * scale.to(x.dtype) + bias.to(x.dtype)


def batch_norm_train(p: Params, x: torch.Tensor, eps: float = 1e-5,
                     momentum: float = 0.1, group=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training BatchNorm over (batch, time) for x [B, T, C], with
    ``BatchNorm1d``'s semantics: statistics in fp32 over all B*T positions,
    the zeroed padding included; the biased variance normalizes, the unbiased
    one (``var * n / (n - 1)``) goes into the running stat.  Returns the
    output and the new running ``{"mean", "var"}`` (detached: they are
    buffers, not part of the graph).

    ``group`` (the "data" group, each rank an equal block of rows) makes it
    sync-BN, as the JAX package's ``axis_name``
    (``gigaam_tpu/ops/conformer_ops.py:57-80``): the global moments from the
    summed first and second raw moments (a mean of per-rank variances would
    drop the spread of the ranks' means), ``n`` scaled by the group size,
    and the gradient summed back to every rank's moments.  A group of one
    holds the whole batch and takes the plain statistics."""
    xf = x.float()
    n = x.shape[0] * x.shape[1]
    size = 1 if group is None else torch.distributed.get_world_size(group)
    if size > 1:
        moments = all_reduce_sum(torch.stack([xf.mean(dim=(0, 1)),
                                              (xf * xf).mean(dim=(0, 1))]),
                                 group) / size
        mean = moments[0]
        var = moments[1] - mean * mean
        n = n * size
    else:
        mean = xf.mean(dim=(0, 1))
        var = ((xf - mean) ** 2).mean(dim=(0, 1))
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        new_stats = {
            "mean": (1 - momentum) * p["mean"] + momentum * mean,
            "var": (1 - momentum) * p["var"] + momentum * unbiased,
        }
    return y.to(x.dtype), new_stats


def row_parallel(p: Params, x: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel ``linear``: this rank's partial product, summed over
    ``tp``, then the replicated bias once."""
    y = reduce_from_model(x @ p["w"].to(x.dtype), tp)
    return y + p["b"].to(x.dtype) if "b" in p else y


def ffn(p: Mapping[str, Params], x: torch.Tensor, tp=None) -> torch.Tensor:
    """Linear -> SiLU -> Linear (``gigaam/encoder.py:412-424``); under
    ``tp`` the first column-parallel, the second row-parallel."""
    h = F.silu(linear(p["linear1"], copy_to_model(x, tp)))
    return row_parallel(p["linear2"], h, tp)


def depthwise_conv1d(w: torch.Tensor, b: Optional[torch.Tensor],
                     x: torch.Tensor) -> torch.Tensor:
    """Depthwise conv over time. x [B, T, C]; w [C, 1, K]; 'same' padding."""
    k = w.shape[-1]
    y = F.conv1d(x.transpose(1, 2), w.to(x.dtype),
                 None if b is None else b.to(x.dtype),
                 padding=(k - 1) // 2, groups=x.shape[-1])
    return y.transpose(1, 2)


def conformer_conv(p: Mapping[str, Params], x: torch.Tensor,
                   valid: Optional[torch.Tensor], norm_type: str,
                   train: bool = False, tp=None, bn_group=None
                   ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Conformer convolution module (``gigaam/encoder.py:364-409``).

    GLU(value, gate) -> zero padded tail -> depthwise(k=31) -> BN/LN ->
    SiLU -> pointwise.  x [B, T, C]; valid [B, T] True=real frame.  Returns
    (y, new BatchNorm running stats or None); the stats come only from
    ``train`` with ``norm_type == "batch_norm"``.  The padded tail is zeroed
    before the depthwise conv, so the garbage that attention leaves in padded
    rows never reaches a batch statistic.  Under ``tp`` the rank holds C/m
    channels from the GLU to ``pointwise_conv2``, which is row-parallel;
    ``bn_group`` is ``batch_norm_train``'s ``group``.
    """
    pc1 = p["pointwise_conv1"]
    x = copy_to_model(x, tp)

    def half(which: str) -> dict:
        h = {"w": pc1[f"w_{which}"]}
        if f"b_{which}" in pc1:
            h["b"] = pc1[f"b_{which}"]
        return h

    a = linear(half("value"), x)
    g = linear(half("gate"), x)
    y = a * torch.sigmoid(g)
    if valid is not None:
        y = torch.where(valid[:, :, None], y, torch.zeros((), dtype=y.dtype,
                                                          device=y.device))
    dw = p["depthwise_conv"]
    y = depthwise_conv1d(dw["w"], dw.get("b"), y)
    new_stats = None
    if norm_type != "batch_norm":
        y = layer_norm(p["batch_norm"], y)
    elif train:
        y, new_stats = batch_norm_train(p["batch_norm"], y, group=bn_group)
    else:
        y = batch_norm_infer(p["batch_norm"], y)
    return row_parallel(p["pointwise_conv2"], F.silu(y), tp), new_stats


# ---------------------------------------------------------------------------
# Striding subsampling (``gigaam/encoder.py:32-130``)
# ---------------------------------------------------------------------------

def subsampled_length(lengths: torch.Tensor, num_stages: int,
                      kernel_size: int = 3, stride: int = 2) -> torch.Tensor:
    """Valid length after strided conv stages (``gigaam/encoder.py:77-90``)."""
    pad = (kernel_size - 1) // 2
    add_pad = 2 * pad - kernel_size
    out = lengths.float()
    for _ in range(num_stages):
        out = torch.floor((out + add_pad) / stride + 1.0)
    return out.to(torch.int32)


def static_subsampled_length(t_feat: int, num_stages: int,
                             kernel_size: int = 3, stride: int = 2) -> int:
    """Pure-Python twin of ``subsampled_length`` for static shapes."""
    import math

    pad = (kernel_size - 1) // 2
    add_pad = 2 * pad - kernel_size
    out = float(t_feat)
    for _ in range(num_stages):
        out = math.floor((out + add_pad) / stride + 1.0)
    return int(out)


def _mask_time(x: torch.Tensor, lengths: torch.Tensor,
               dim: int = 1) -> torch.Tensor:
    """Zero the padded tail along time (axis ``dim``).

    The batch-invariance fix of ``gigaam/encoder.py:92-109``: the strided
    convs' receptive field is wider than the stride, so without re-zeroing
    after every stage the log-mel pad floor (log 1e-9) of batched short
    samples leaks into their last valid frames.
    """
    t = x.shape[dim]
    m = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
    shape = [1] * x.ndim
    shape[0], shape[dim] = x.shape[0], t
    return torch.where(m.reshape(shape), x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _stage(conv_fn, x: torch.Tensor, conv: Params, i: int, tp, **kw
           ) -> torch.Tensor:
    """Stage ``i``'s strided conv.  Under ``tp`` an even stage is
    column-parallel (this rank's output channels, from the replicated
    input), an odd one row-parallel (this rank's input channels, summed over
    ``tp``, then the replicated bias).  One process keeps the bias inside
    the convolution, whose kernel may add it before the bf16 rounding, so
    that its numerics stay those of a plain conv; an odd stage's sum over
    ranks must come before its bias, so its path differs under ``tp``."""
    w, b = conv["w"].to(x.dtype), conv["b"].to(x.dtype)
    if tp is None or i % 2 == 0:
        return conv_fn(copy_to_model(x, tp), w, b, **kw)
    y = reduce_from_model(conv_fn(x, w, None, **kw), tp)
    return y + b.reshape(-1, *(1,) * (y.ndim - 2))


def striding_subsampling_conv2d(
    p: Mapping[str, Params],
    feats: torch.Tensor,
    lengths: torch.Tensor,
    num_stages: int,
    kernel_size: int = 3,
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv2d subsampling: feats [B, T, F] -> [B, T', d_model].

    Stage convs stride 2 over (time, freq) with ReLU, the time tail
    re-masked after each; the channel x freq block then flattens
    channel-major (torch's [b, t, C, f] reshape at
    ``gigaam/encoder.py:125-127``) through a Linear.  ``tp``: see
    ``_stage`` (an even count of stages leaves the output replicated).
    """
    pad = (kernel_size - 1) // 2
    x = feats[:, None]                                   # [B, 1, T, F] NCHW
    cur_len = lengths
    x = _mask_time(x, cur_len, dim=2)
    for i in range(num_stages):
        x = F.relu(_stage(F.conv2d, x, p[f"conv_{i}"], i, tp, stride=2,
                          padding=pad))
        cur_len = subsampled_length(cur_len, 1, kernel_size)
        x = _mask_time(x, cur_len, dim=2)
    b, c, t, f = x.shape
    x = x.permute(0, 2, 1, 3).reshape(b, t, c * f)      # channel-major
    # cur_len IS subsampled_length(lengths, num_stages): return the value
    # the masks used, so masking and reported lengths cannot drift apart
    return linear(p["out"], x), cur_len


def striding_subsampling_conv1d(
    p: Mapping[str, Params],
    feats: torch.Tensor,
    lengths: torch.Tensor,
    num_stages: int,
    kernel_size: int = 3,
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv1d subsampling: feats [B, T, F] -> [B, T', d_model].

    Each stage is a stride-2 ``F.conv1d`` over time on [B, C, T] (padding
    (K-1)//2), then bias and ReLU, the time tail re-masked after it.
    ``tp``: see ``_stage``."""
    pad = (kernel_size - 1) // 2
    x = _mask_time(feats.transpose(1, 2), lengths, dim=2)   # [B, F, T]
    cur_len = lengths
    for i in range(num_stages):
        x = F.relu(_stage(F.conv1d, x, p[f"conv_{i}"], i, tp, stride=2,
                          padding=pad))
        cur_len = subsampled_length(cur_len, 1, kernel_size)
        x = _mask_time(x, cur_len, dim=2)
    return x.transpose(1, 2).contiguous(), cur_len
