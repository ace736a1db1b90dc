#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card (``nvidia-smi`` name and power limit, torch's name);
2. build the hand-written kernels (``gigaam_tpu_torch/csrc``, one ``nvcc``
   per source, all started together) and print each kernel's registers,
   spills and shared memory (none of the ``wgmma`` kernels may spill);
3. hold each kernel (K3, K2, K1, K5) against its plain PyTorch version at
   the main path's shapes in bf16, show that the check fails for a kernel
   with a planted fault (fed through its inputs: RoPE sign flipped, key mask
   ignored, 1/sqrt(d_h) missing, q zeroed, LayerNorm skipped; for K5 also
   q_u/q_v swapped, the shift reversed, the positional term dropped), and
   time the kernel, its plain version and the library call with CUDA
   events; K3 and K5 also return their log-sum-exp, held against the plain
   one and timed with and without;
4. drive full-width v3_ctc (16 x 768, random weights from a seed, bf16)
   through the user entry points: ``transcribe`` on a 20 s clip (batch 1:
   K2), ``_decode_batch`` on 16 clips of 10-20 s (K1) and ``encode_batch``
   on a 45 s clip (T' = 1125: K3), asserting from the launch counts that
   each path went through its kernel, then profiling each call
   (``torch.profiler``): device busy time, idle share, kernel launches and
   device time by kernel group;
5. compare the card's bf16 v3_ctc encoder output with the port's own CPU
   float32 output on the same weights, on small inputs through each of the
   three rotary attention paths;
6. the same for the rel-pos encoder (K5): full-width v2_ctc (its
   ``pos_bias_u``/``pos_bias_v`` drawn nonzero and apart from a seed)
   through ``transcribe`` on 20 s and ``_decode_batch`` on 16 clips of
   10-20 s (T' = 501), full-width emo through ``get_probs`` on 10 s
   (T' = 251), each profiled, then the v2_ctc reference comparison at 4 s,
   16 x 1-2 s and 42 s (T' = 1051);
7. the backward kernels: K4 and K6 against their plain backward in bf16 at
   B 16 T' 500/501 (the training shape), B 8 T' 750 and B 2 T' 1000, per
   gradient, with ``do`` zero on padded rows; the plain backward against
   ``torch.autograd.grad`` through the plain forward in fp32; planted faults
   (key mask ignored, scale missing from ds, the rowsum term dropped and, fed
   through the inputs, the log-sum-exp of another batch element and D from
   a zeroed forward output; for K6 also P without the bias, the unshear
   reversed, dp from the last batch element only), each of which must land
   above the limit; each kernel from its forward's saved (out, lse) and
   without them, the same bits; times (with the pair given, and without),
   bounds, two runs bit-equal, but for K6's dp, whose spread over two runs
   is printed (its batch sum uses atomics);
8. CTC fine-tuning at full width, bf16 over fp32 master weights, batch 16 of
   10-20 s clips written as WAVs with a TSV manifest to a temporary
   directory: the CLI ``gigaam_tpu_torch.train.train.main`` for v3_ctc
   (4 steps, SpecAugment, validation on the first batch), then
   ``FineTuner.train_step`` directly for v2_ctc, for v3_ctc, and for v3_ctc
   with activation checkpointing (3 steps each), asserting from the launch counts that
   every layer's backward went through K4 / K6 and no train step through
   K1/K2, that every trainable leaf and every BatchNorm buffer moved, that
   the positional parameters got a gradient, and that ``eval_step`` after
   the steps sees the new weights; per step wall time, peak memory, the
   forward/backward/optimizer split and a profile;
9. one train step at full width but 2 layers, batch 4 of 2-4 s: the card's
   bf16 loss and gradients against the port's CPU fp32 ones.

The last two lines of output are a JSON object with every kernel's numbers
(``shape`` names the shape of a row's numbers, ``also`` holds the same
numbers at the kernel's other shapes) and ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
there is no CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

import gigaam_tpu_torch as gt
from gigaam_tpu_torch.audio import save_wav
from gigaam_tpu_torch.config import RU_VOCAB, SAMPLE_RATE, make_preset
from gigaam_tpu_torch.data import AudioDataset, write_manifest
from gigaam_tpu_torch.models.heads import ctc_log_probs
from gigaam_tpu_torch.ops import cuda_lib
from gigaam_tpu_torch.ops import fused_attention as fa
from gigaam_tpu_torch.ops.precision import full_fp32
from gigaam_tpu_torch.ops.rotary import rotary_tables
from gigaam_tpu_torch.train import train as train_cli
from gigaam_tpu_torch.train.finetune import FineTuner, TrainConfig

# A kernel passes where, on every valid query row,
#   |got - ref| <= KERNEL_REL * RMS(attention output of ref) + KERNEL_RTOL * |ref|:
# a tenth of the output's own size, plus one bf16 rounding of the value (K1
# adds the residual in bf16).  The attention output is ref itself for K3/K2
# and ref - x for K1.  The planted faults must land above the same limit.
KERNEL_REL = 0.1
KERNEL_RTOL = 2.0 ** -7
# q/k projections at QK_GAIN / sqrt(d) (K3: q, k ~ N(0, QK_GAIN^2)) give
# scores with a standard deviation of about QK_GAIN^2 = 2.25, so each query
# weighs a few keys (about T' e^-5) instead of averaging all of them; x has a
# per-channel mean and a per-row scale, so LayerNorm changes it
QK_GAIN = 1.5
# CUDA bf16 vs CPU fp32 encoder output, relative Frobenius error: bf16 keeps
# 8 bits of mantissa (~0.4% per rounding) and every layer ends in a LayerNorm,
# so 16 layers stay well inside 10%
ENCODER_RTOL = 0.1
# One train step, CUDA bf16 vs CPU fp32 on the same weights and batch, at 2
# layers.  The loss is a mean of fp32 log-probabilities over bf16 encodings
# that are within ~1% of the fp32 ones: 2%.  A gradient passes through every
# bf16 rounding of the forward and again through those of the backward (P and
# ds rounded in K4/K6, bf16 matmul outputs), each ~0.4%, and sums over
# B x T' positions whose errors partly add: a leaf group's relative Frobenius
# error stays inside 10%, the encoder's own limit
TRAIN_LOSS_RTOL = 0.02
TRAIN_GRAD_RTOL = 0.1
# the plain backward on fp32 inputs (its rounding points are then no-ops)
# against autograd through the plain forward: the same math in another order
PLAIN_BWD_REL = 1e-3

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): bf16 tensor cores, fp32
# outside them, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

D_MODEL, N_HEADS, D_HEAD = 768, 16, 48

# device-time groups of the main-path profile, matched in this order
PROFILE_GROUPS = (
    # sdpa_kernel matches K5's relpos_sdpa_kernel too
    # and the backward kernels: sdpa_bwd_*, relpos_bwd_*
    ("attention kernels (csrc)",
     r"sdpa_kernel|qkv_kernel|out_proj_kernel|bwd_dq_kernel|bwd_dkv_kernel"),
    ("convolution", r"conv_|convolve|cudnn|winograd|fprop"),
    ("GEMM (cuBLAS)", r"nvjet|gemm|xmma|cutlass|cublas"),
    ("host-device copies", r"^Memcpy|^Memset"),
    ("other (elementwise, reductions)", r""),
)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(n_bytes: float, tensor_ops: float, fp32_ops: float):
    """(least ms, "bytes" | "operations") for the work on this card."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = tensor_ops / PEAK_BF16 + fp32_ops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


def ragged_valid(b: int, t: int, dev) -> torch.Tensor:
    lens = torch.tensor([t - 7 - (i * t) // (2 * b) for i in range(b)],
                        device=dev)
    return torch.arange(t, device=dev)[None, :] < lens[:, None]


def synth_wav(seconds: float, rng) -> np.ndarray:
    """A few harmonics under a syllable-rate envelope, plus noise."""
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    f0 = rng.uniform(100, 220)
    sig = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 4 * t + rng.uniform(0, 6)))
    return (0.1 * sig * env + 0.01 * rng.standard_normal(t.shape)).astype(
        np.float32)


def distance(got, ref, valid, time_dim: int, residual=None):
    """(max |got - ref|, max (|got - ref| - KERNEL_RTOL |ref|) / RMS) over
    the valid query rows, where RMS is that of ref's attention output."""
    shape = [1] * got.dim()
    shape[0], shape[time_dim] = valid.shape
    rows = valid.reshape(shape).expand_as(got)
    ref = ref.float()[rows]
    attn = ref if residual is None else ref - residual.float()[rows]
    rms = float(attn.pow(2).mean().sqrt())
    err = (got.float()[rows] - ref).abs()
    return float(err.max()), max(
        0.0, float((err - KERNEL_RTOL * ref.abs()).max()) / rms)


def check_kernel(name: str, got, ref, valid, time_dim: int, faults,
                 residual=None):
    """Raise unless ``got`` is within the limit of ``ref`` and each planted
    fault ``(label, fn)`` lands outside it; returns (max_abs_err, in RMS)."""
    err, rel = distance(got, ref, valid, time_dim, residual)
    if not rel <= KERNEL_REL:
        raise AssertionError(f"{name}: max error {rel:.4f} x RMS over "
                             f"{KERNEL_REL} x RMS + |ref|/128 (max_abs_err {err})")
    for label, fn in faults:
        _, fault_rel = distance(fn(), ref, valid, time_dim, residual)
        print(f"  {name} planted fault, {label}: {fault_rel:.4f} x RMS "
              f"(limit {KERNEL_REL})", flush=True)
        if not fault_rel > KERNEL_REL:
            raise AssertionError(f"{name}: the check misses the fault {label}")
    return err, rel


def attention_weights(gen, dev) -> fa.FoldedWeights:
    def lin(gain):
        return {"w": torch.randn(D_MODEL, D_MODEL, generator=gen)
                * (gain / D_MODEL ** 0.5),
                "b": 0.1 * torch.randn(D_MODEL, generator=gen)}
    attn = {"linear_q": lin(QK_GAIN), "linear_k": lin(QK_GAIN),
            "linear_v": lin(1.0), "linear_out": lin(1.0)}
    ln = {"scale": 1.0 + 0.1 * torch.randn(D_MODEL, generator=gen),
          "bias": 0.1 * torch.randn(D_MODEL, generator=gen)}
    attn = {n: {k: v.to(dev) for k, v in p.items()} for n, p in attn.items()}
    ln = {k: v.to(dev) for k, v in ln.items()}
    return fa.prepare_folded_weights(attn, ln, N_HEADS, torch.bfloat16)


def attention_input(gen, b: int, t: int, dev) -> torch.Tensor:
    """[B, T, D] bf16 with a per-channel mean and a per-row scale in
    [0.5, 2], so that LayerNorm changes it."""
    mean = 0.5 * torch.randn(D_MODEL, generator=gen)
    scale = 0.5 + 1.5 * torch.rand(b, t, 1, generator=gen)
    x = mean + scale * torch.randn(b, t, D_MODEL, generator=gen)
    return x.to(dev, torch.bfloat16)


# lse is fp32 on both sides, from the same bf16 inputs: another order of
# accumulation and the kernel's exp2/log2 approximations (relative 2^-22)
LSE_ATOL = 1e-3
# K5's lse: the share of rows held to LSE_ATOL (relpos_kernel_phase says why
# not all)
LSE_SHARE = 0.999


def shaped_row(readings: dict, main) -> dict:
    """The JSON row of a kernel timed at several shapes: the numbers at
    ``main`` (b, t), the others under ``also``."""
    def named(shape):
        return dict(readings[shape], shape=f"B {shape[0]}, T' {shape[1]}")
    return dict(named(main), also=[named(s) for s in readings if s != main])


def kernel_phase(dev) -> dict:
    """Each kernel against its plain version; returns the JSON rows.  The
    planted faults run at the shape the JSON row reports."""
    gen = torch.Generator().manual_seed(0)
    rows = {}
    k3 = {}
    # K3 at T' = 500 (B 1 and 16) and at the main path's T' = 1125 (B 1)
    for b, t in ((1, 500), (16, 500), (1, 1125)):
        q, k, v = (torch.randn(b, N_HEADS, t, D_HEAD, generator=gen)
                   * gain for gain in (QK_GAIN, QK_GAIN, 1.0))
        q, k, v = (a.to(dev, torch.bfloat16) for a in (q, k, v))
        valid = ragged_valid(b, t, dev)
        got = fa.fused_mha(q, k, v, valid)
        ref, lse_ref = fa.mha_plain(q, k, v, valid, return_lse=True)
        out2, lse = fa._mha_forward(q, k, v, valid, want_lse=True)
        lse_err = float((lse - lse_ref).abs().max())
        if not (torch.equal(out2, got) and lse_err <= LSE_ATOL):
            raise AssertionError(f"K3 B={b} T'={t}: lse off by {lse_err} "
                                 f"(limit {LSE_ATOL}) or the output changed")
        faults = () if (b, t) != (1, 1125) else (
            ("key mask ignored",
             lambda: fa.fused_mha(q, k, v, torch.ones_like(valid))),
            ("1/sqrt(d_h) missing",
             lambda: fa.fused_mha(q * math.sqrt(D_HEAD), k, v, valid)),
            ("q zeroed",
             lambda: fa.fused_mha(torch.zeros_like(q), k, v, valid)))
        err, rel = check_kernel(f"K3 B={b} T'={t}", got, ref, valid, 2, faults)
        ms = time_ms(lambda: fa.fused_mha(q, k, v, valid))
        lse_ms = time_ms(lambda: fa._mha_forward(q, k, v, valid,
                                                 want_lse=True))
        plain_ms = time_ms(lambda: fa.mha_plain(q, k, v, valid), iters=5)
        mask4 = valid[:, None, None, :]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask4))
        scores = b * N_HEADS * t * t
        bms, by = bound(4 * b * N_HEADS * t * D_HEAD * 2 + b * t,
                        4 * scores * D_HEAD, 4 * scores)
        print(f"K3 fused_mha B={b} T'={t}: max_abs_err {err:.3e}, "
              f"{rel:.4f} x RMS (limit {KERNEL_REL}), lse within {lse_err:.2e} "
              f"(limit {LSE_ATOL}); kernel {ms:.4f} ms ({lse_ms:.4f} writing "
              f"lse), plain {plain_ms:.4f} ms, F.sdpa {lib_ms:.4f} ms, bound "
              f"{bms:.4f} ms ({by})", flush=True)
        k3[(b, t)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                          library_ms=lib_ms, max_abs_err=err)
    rows["K3"] = shaped_row(k3, (1, 1125))

    w = attention_weights(gen, dev)
    root_dh = math.sqrt(D_HEAD)
    w_unscaled = dataclasses.replace(
        w, wq=(w.wq.float() * root_dh).to(w.wq.dtype), bq=w.bq * root_dh)
    w_q0 = dataclasses.replace(w, wq=torch.zeros_like(w.wq),
                               bq=torch.zeros_like(w.bq))
    t = 500
    cos_np, sin_np = rotary_tables(t, D_HEAD, 5000.0)
    cos, sin = (torch.from_numpy(a).to(dev) for a in (cos_np, sin_np))
    for name, wrapper, plain, lnres in (
            ("K2", fa.folded_rotary_attention,
             fa.folded_rotary_attention_plain, False),
            ("K1", fa.folded_rotary_attention_lnres,
             fa.folded_rotary_attention_lnres_plain, True)):
        for b in (1, 16):
            x = attention_input(gen, b, t, dev)
            valid = ragged_valid(b, t, dev)
            got = wrapper(w, x, cos, sin, valid, N_HEADS)
            ref = plain(w, x, cos, sin, valid, N_HEADS)
            faults = () if (name, b) not in (("K2", 1), ("K1", 16)) else (
                ("RoPE sign flipped",
                 lambda: wrapper(w, x, cos, -sin, valid, N_HEADS)),
                ("key mask ignored",
                 lambda: wrapper(w, x, cos, sin, torch.ones_like(valid),
                                 N_HEADS)),
                ("1/sqrt(d_h) missing",
                 lambda: wrapper(w_unscaled, x, cos, sin, valid, N_HEADS)),
                ("q zeroed", lambda: wrapper(w_q0, x, cos, sin, valid, N_HEADS)),
            ) + ((("LayerNorm skipped", lambda: x + fa.folded_rotary_attention(
                w, x, cos, sin, valid, N_HEADS)),) if lnres else ())
            err, rel = check_kernel(f"{name} B={b}", got, ref, valid, 1,
                                    faults, residual=x if lnres else None)
            ms = time_ms(lambda: wrapper(w, x, cos, sin, valid, N_HEADS))
            plain_ms = time_ms(lambda: plain(w, x, cos, sin, valid, N_HEADS),
                               iters=5)
            m, scores = b * t, b * N_HEADS * t * t
            n_bytes = (2 * m * D_MODEL * 2 + 4 * D_MODEL * D_MODEL * 2
                       + 6 * D_MODEL * 4 + 2 * t * D_HEAD * 4 + b * t)
            fp32_ops = 4 * scores + 3 * m * D_MODEL + (8 * m * D_MODEL
                                                       if lnres else 0)
            bms, by = bound(n_bytes, 8 * m * D_MODEL * D_MODEL
                            + 4 * scores * D_HEAD, fp32_ops)
            print(f"{name} {wrapper.__name__} B={b} T'={t}: max_abs_err "
                  f"{err:.3e}, {rel:.4f} x RMS (limit {KERNEL_REL}); kernel "
                  f"{ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
            if (name, b) in (("K2", 1), ("K1", 16)):
                rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                  bound_by=by, library_ms=None,
                                  max_abs_err=err, shape=f"B {b}, T' {t}")
    rows["K5"] = relpos_kernel_phase(gen, dev)
    return rows


def relpos_kernel_phase(gen, dev) -> dict:
    """K5 at the v2 main path's T' = 501 (B 1 and 16) and at T' = 1126
    (B 1, a 45 s clip); the faults and the JSON row at B 16."""
    k5 = {}
    for b, t in ((1, 501), (16, 501), (1, 1126)):
        def draw(shape, gain):
            return (torch.randn(shape, generator=gen) * gain).to(
                dev, torch.bfloat16)
        # q_u.k and the positional term of one size (both at QK_GAIN), q_u
        # and q_v drawn apart so that a swap shows
        q_u, k, q_v = (draw((b, N_HEADS, t, D_HEAD), QK_GAIN)
                       for _ in range(3))
        v = draw((b, N_HEADS, t, D_HEAD), 1.0)
        p_heads = draw((N_HEADS, 2 * t - 1, D_HEAD), QK_GAIN)
        valid = ragged_valid(b, t, dev)
        args = (q_u, k, v, q_v, p_heads, valid)
        got = fa.fused_relpos_mha(*args)
        ref, lse_ref = fa.relpos_mha_plain(*args, return_lse=True)
        out2, lse = fa._relpos_forward(*args, want_lse=True)
        # The kernel and the plain version round the same fp32 positional
        # product, summed in two orders, to bf16: where they round apart a
        # score moves by one bf16 step of the bias, and the row's lse by that
        # times the key's probability.  Every row within LSE_ATOL plus one
        # step at the largest bias, LSE_SHARE of the rows within LSE_ATOL.
        lse_diff = (lse - lse_ref).abs()
        lse_err = float(lse_diff.max())
        lse_share = float((lse_diff <= LSE_ATOL).float().mean())
        step = (float(fa._relpos_bias(q_v, p_heads).abs().max()) * 2.0 ** -7
                / math.sqrt(D_HEAD))
        if not (torch.equal(out2, got) and lse_err <= LSE_ATOL + step
                and lse_share >= LSE_SHARE):
            raise AssertionError(
                f"K5 B={b} T'={t}: lse off by {lse_err} (limit {LSE_ATOL} + "
                f"{step}), within {LSE_ATOL} on {lse_share} of the rows "
                f"(limit {LSE_SHARE}), or the output changed")
        root_dh = math.sqrt(D_HEAD)
        faults = () if (b, t) != (16, 501) else (
            ("key mask ignored", lambda: fa.fused_relpos_mha(
                q_u, k, v, q_v, p_heads, torch.ones_like(valid))),
            ("1/sqrt(d_h) missing", lambda: fa.fused_relpos_mha(
                q_u * root_dh, k, v, q_v * root_dh, p_heads, valid)),
            ("q_u/q_v swapped", lambda: fa.fused_relpos_mha(
                q_v, k, v, q_u, p_heads, valid)),
            ("shift reversed", lambda: fa.fused_relpos_mha(
                q_u, k, v, q_v, p_heads.flip(1).contiguous(), valid)),
            ("positional term dropped", lambda: fa.fused_relpos_mha(
                q_u, k, v, q_v, torch.zeros_like(p_heads), valid)))
        err, rel = check_kernel(f"K5 B={b} T'={t}", got, ref, valid, 2, faults)
        ms = time_ms(lambda: fa.fused_relpos_mha(*args))
        lse_ms = time_ms(lambda: fa._relpos_forward(*args, want_lse=True))
        plain_ms = time_ms(lambda: fa.relpos_mha_plain(*args), iters=5)
        scores = b * N_HEADS * t * t
        bms, by = bound(
            (5 * b * N_HEADS * t * D_HEAD + N_HEADS * (2 * t - 1) * D_HEAD) * 2
            + b * t, 6 * scores * D_HEAD, 5 * scores)
        print(f"K5 fused_relpos_mha B={b} T'={t}: max_abs_err {err:.3e}, "
              f"{rel:.4f} x RMS (limit {KERNEL_REL}), lse within {lse_err:.2e} "
              f"(limit {LSE_ATOL} + a bf16 step of the bias, {step:.2e}) and "
              f"within {LSE_ATOL} on {lse_share:.5f} of the rows (limit "
              f"{LSE_SHARE}); kernel {ms:.4f} ms ({lse_ms:.4f} writing lse), "
              f"plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
        k5[(b, t)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                          library_ms=None, max_abs_err=err)
    return shaped_row(k5, (16, 501))


# ---------------------------------------------------------------------------
# The backward kernels
# ---------------------------------------------------------------------------

def bwd_inputs(gen, b: int, t: int, dev, relpos: bool):
    """Peaked inputs as the forward checks use, and a ``do`` that is zero on
    padded query rows, as in a train step."""
    def draw(shape, gain):
        return (torch.randn(shape, generator=gen) * gain).to(
            dev, torch.bfloat16)

    shape = (b, N_HEADS, t, D_HEAD)
    valid = ragged_valid(b, t, dev)
    q, k = draw(shape, QK_GAIN), draw(shape, QK_GAIN)
    v = draw(shape, 1.0)
    do = draw(shape, 1.0) * valid[:, None, :, None]
    if not relpos:
        return (q, k, v, do, valid)
    q_v = draw(shape, QK_GAIN)
    p_heads = draw((N_HEADS, 2 * t - 1, D_HEAD), QK_GAIN)
    return (q, k, v, q_v, p_heads, do, valid)


def faulty_backward(args, fault: str, relpos: bool):
    """The attention backward in fp32 with one fault planted: what a kernel
    with that fault would return, up to rounding."""
    if relpos:
        q, k, v, q_v, p, do, valid = args
        q_v, p = q_v.float(), p.float()
    else:
        q, k, v, do, valid = args
    q, k, v, do = (x.float() for x in (q, k, v, do))
    b, h, t, d = q.shape
    scale = 1.0 / math.sqrt(d)
    with full_fp32():
        s = q @ k.transpose(-1, -2)
        if relpos:
            ar = torch.arange(t, device=q.device)
            idx = ((t - 1) - ar[:, None] + ar[None, :]).expand(b, h, t, t)
            if fault != "P without the bias":
                raw = q_v @ p.transpose(-1, -2)
                s = s + raw.gather(-1, idx).bfloat16().float()
        s = s * scale
        if fault != "key mask ignored":
            s = s + (valid[:, None, None, :].float() - 1.0) * 1e9
        prob = torch.softmax(s, dim=-1)
        dv = prob.transpose(-1, -2) @ do
        dprob = do @ v.transpose(-1, -2)
        row = (dprob * prob).sum(-1, keepdim=True)
        if fault == "rowsum term dropped":
            row = torch.zeros_like(row)
        ds = prob * (dprob - row)
        if fault != "scale missing from ds":
            ds = ds * scale
        out = [ds @ k, ds.transpose(-1, -2) @ q, dv]
        if relpos:
            if fault == "unshear reversed":
                idx = (2 * t - 2) - idx
            d_raw = ds.new_zeros((b, h, t, 2 * t - 1)).scatter_(-1, idx, ds)
            out.append(d_raw @ p)
            if fault == "dp from the last batch element":
                d_raw, q_v = d_raw[-1:], q_v[-1:]
            out.append(torch.einsum("bhtp,bhtd->hpd", d_raw, q_v))
    return out


def grad_distances(names, got, ref, valid):
    """Per gradient (max_abs_err, error in that gradient's RMS), over the
    valid rows (query rows for dq*, key rows for dk and dv, all of dp)."""
    out = {}
    for name, g, r in zip(names, got, ref):
        if name == "dp":
            g, r = g[None], r[None]
            rows = torch.ones((1, g.shape[2]), dtype=torch.bool,
                              device=g.device)
        else:
            rows = valid
        out[name] = distance(g, r, rows, 2)
    return out


def bwd_kernel_phase(gen, dev, relpos: bool) -> dict:
    key = "K6" if relpos else "K4"
    kernel, plain, fwd_kernel, fwd_plain = (
        (fa.relpos_mha_bwd, fa.relpos_mha_bwd_plain, fa._relpos_forward,
         fa.relpos_mha_plain) if relpos else
        (fa.mha_bwd, fa.mha_bwd_plain, fa._mha_forward, fa.mha_plain))
    names = (("dq_u", "dk", "dv", "dq_v", "dp") if relpos
             else ("dq", "dk", "dv"))
    # dp's sum over the batch uses atomics; the others give the same bits
    n_exact = 4 if relpos else 3
    exact = ", ".join(names[:n_exact])
    faults = ("key mask ignored", "scale missing from ds",
              "rowsum term dropped") + ((
                  "P without the bias", "unshear reversed",
                  "dp from the last batch element") if relpos else ())
    readings = {}
    t_train = 501 if relpos else 500   # the JSON row: the training shape
    for b, t in ((16, t_train), (8, 750), (2, 1000)):
        args = bwd_inputs(gen, b, t, dev, relpos)
        valid = args[-1]
        fwd_args = args[:-2] + (valid,)
        # the backward starts from what the forward saved: the kernel from
        # the forward kernel's own (out, lse), the plain backward from the
        # plain forward's
        pair = fwd_kernel(*fwd_args, want_lse=True)
        plain_pair = fwd_plain(*fwd_args, return_lse=True)
        got = kernel(*args, *pair)
        torch.cuda.synchronize()
        ref = plain(*args, *plain_pair)
        dist = grad_distances(names, got, ref, valid)
        worst = max(rel for _, rel in dist.values())
        err = max(e for e, _ in dist.values())
        print(f"{key} {kernel.__name__} B={b} T'={t}: " + ", ".join(
            f"{n} {rel:.4f} x RMS (max_abs_err {e:.3e})"
            for n, (e, rel) in dist.items()) + f" (limit {KERNEL_REL})",
            flush=True)
        if not worst <= KERNEL_REL:
            raise AssertionError(f"{key} B={b} T'={t}: {dist}")
        # without the pair the backward runs the forward kernel for it first:
        # the same bits; and the plain backward's other form (row statistics
        # recomputed, D = rowsum(dP P), as the Pallas kernel) stays close
        unsaved = kernel(*args)
        if not all(torch.equal(a, g) for a, g in
                   zip(unsaved[:n_exact], got[:n_exact])):
            raise AssertionError(f"{key}: without the saved pair the "
                                 f"gradients differ")
        odist = grad_distances(names, unsaved, plain(*args), valid)
        oworst = max(rel for _, rel in odist.values())
        print(f"  {key} without the saved pair: {exact} bit-equal; against "
              f"the plain backward that recomputes the row statistics: worst "
              f"{oworst:.4f} x RMS (limit {KERNEL_REL})", flush=True)
        if not oworst <= KERNEL_REL:
            raise AssertionError(f"{key} B={b} T'={t}: {odist}")

        # the plain backward itself, in both forms, on fp32 inputs, against
        # autograd through the plain forward
        wide = [x.float() for x in args[:-1]]
        do32 = wide.pop(-1)
        leaves = [x.clone().requires_grad_() for x in wide]
        auto = torch.autograd.grad(fwd_plain(*leaves, valid), leaves, do32)
        pdist = grad_distances(names, plain(*wide, do32, valid), auto, valid)
        pworst = max(rel for _, rel in pdist.values())
        with torch.no_grad():
            pair32 = fwd_plain(*wide, valid, return_lse=True)
        pdist = grad_distances(
            names, plain(*wide, do32, valid, *pair32), auto, valid)
        pworst = max(pworst, *(rel for _, rel in pdist.values()))
        print(f"  {key} plain backward vs autograd of the plain forward, "
              f"fp32: worst {pworst:.2e} x RMS (limit {PLAIN_BWD_REL})",
              flush=True)
        if not pworst <= PLAIN_BWD_REL:
            raise AssertionError(f"{key} plain backward: {pdist}")
        del leaves, auto, wide, pair32

        if b == 16:
            def must_show(fault, fdist):
                name, (_, rel) = max(fdist.items(), key=lambda kv: kv[1][1])
                print(f"  {key} planted fault, {fault}: {name} {rel:.4f} x "
                      f"RMS (limit {KERNEL_REL})", flush=True)
                if not rel > KERNEL_REL:
                    raise AssertionError(f"{key}: the check misses {fault}")

            # faults in the arithmetic: the kernel against a faulty reference
            for fault in faults:
                must_show(fault, grad_distances(
                    names, got, faulty_backward(args, fault, relpos), valid))
            # faults in what the forward handed over: fed through the inputs
            out_k, lse_k = pair
            must_show("lse of another batch element", grad_distances(
                names, kernel(*args, out_k, lse_k.roll(1, 0).contiguous()),
                ref, valid))
            must_show("D from a zeroed out", grad_distances(
                names, kernel(*args, torch.zeros_like(out_k), lse_k), ref,
                valid))
            again = kernel(*args, *pair)
            same = all(torch.equal(a, g) for a, g in
                       zip(again[:n_exact], got[:n_exact]))
            spread = "" if not relpos else (
                f"; dp differs by at most "
                f"{float((again[4].float() - got[4].float()).abs().max()):.3e}"
                f" (max |dp| {float(got[4].float().abs().max()):.3e})")
            print(f"  {key} two runs: {exact} bit-equal: {same}{spread}",
                  flush=True)
            if not same:
                raise AssertionError(f"{key}: a deterministic output changed "
                                     f"between two runs")
        ms = time_ms(lambda: kernel(*args, *pair))
        unsaved_ms = time_ms(lambda: kernel(*args))
        plain_ms = time_ms(lambda: plain(*args, *plain_pair), iters=5)
        print(f"  {key} B={b} T'={t} without the saved pair (the forward's "
              f"kernel first): {unsaved_ms:.4f} ms", flush=True)
        scores = b * N_HEADS * t * t
        tile = b * N_HEADS * t * D_HEAD * 2
        lse_bytes = b * N_HEADS * t * 4
        if relpos:
            # q_u, k, v, q_v, do, out in, dq_u, dk, dv, dq_v out, the table in
            # and its gradient out, lse, the mask
            table = N_HEADS * (2 * t - 1) * D_HEAD * 2
            bms, by = bound(10 * tile + 2 * table + lse_bytes + b * t,
                            16 * scores * D_HEAD, 10 * scores)
            lib_ms = None
        else:
            # q, k, v, do, out in, dq, dk, dv out, lse, the mask
            bms, by = bound(8 * tile + lse_bytes + b * t,
                            10 * scores * D_HEAD, 8 * scores)
            mask4 = valid[:, None, None, :]
            q, k, v, do = (x for x in args[:4])
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]

            def lib_fwd():
                return F.scaled_dot_product_attention(*leaves, attn_mask=mask4)

            def lib_both():
                torch.autograd.grad(lib_fwd(), leaves, do)

            lib_ms = time_ms(lib_both) - time_ms(lib_fwd)
        print(f"  {key} B={b} T'={t}: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
              f" ms, library "
              f"{'none' if lib_ms is None else format(lib_ms, '.4f') + ' ms'}"
              f", bound {bms:.4f} ms ({by})", flush=True)
        readings[(b, t)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                bound_by=by, library_ms=lib_ms,
                                max_abs_err=err)
    return shaped_row(readings, (16, t_train))


def counts() -> dict:
    return {"K3": fa.fused_mha.launches,
            "K2": fa.folded_rotary_attention.launches,
            "K1": fa.folded_rotary_attention_lnres.launches,
            "K5": fa.fused_relpos_mha.launches,
            "K4": fa.mha_bwd.launches,
            "K6": fa.relpos_mha_bwd.launches}


def profile_calls(label: str, fn, calls: int, wall_ms: float) -> None:
    """Print device busy time, idle share, launches and device time by group
    per call of ``fn``, from ``calls`` calls under ``torch.profiler``."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        # the optimizer's own range is mirrored on the device timeline: it
        # is a span over kernels counted already, not a kernel
        span = (getattr(evt, "is_user_annotation", False)
                or evt.key.startswith("Optimizer."))
        if (us > 0 and not span
                and evt.device_type == torch.autograd.DeviceType.CUDA):
            kernels[evt.key] = (us / 1e3 / calls, evt.count // calls)
    groups = defaultdict(float)
    for name, (ms, _) in kernels.items():
        group = next(g for g, pattern in PROFILE_GROUPS
                     if re.search(pattern, name, re.IGNORECASE))
        groups[group] += ms
    busy = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    print("  profile " + json.dumps({
        "call": label, "wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall_ms,
        "launches": sum(n for _, n in kernels.values()),
        "groups_ms": groups,
        "top_kernels": [[k[:90], ms, n] for k, (ms, n) in top]}), flush=True)


def run_path(label: str, fn, kernel: str, n_layers: int, calls: int = 3):
    """Warm ``fn`` once, then run it ``calls`` times from zeroed counts and
    assert that only ``kernel``'s wrapper ran, once per layer per call; then
    profile ``calls`` more calls.  The wall time per call comes from the
    unprofiled calls."""
    fn()
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(calls):
        out = fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    got = counts()
    want = {k: (n_layers * calls if k == kernel else 0) for k in got}
    print(f"main path {label}: {wall_ms:.2f} ms per call (wall, after "
          f"warm-up), launches {got}", flush=True)
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    profile_calls(label, fn, calls, wall_ms)
    return out, got[kernel]


def main_path(model, rng, card: str) -> dict:
    n_layers = model.cfg.encoder.n_layers
    launches = {}
    wav20 = synth_wav(20.0, rng)
    res, launches["K2"] = run_path(
        "transcribe 20 s, batch 1 (K2)",
        lambda: model.transcribe(wav20, word_timestamps=True), "K2", n_layers)
    if not (isinstance(res.text, str) and isinstance(res.words, list)):
        raise AssertionError(f"transcribe returned {res!r}")
    print(f"  transcribe: {len(res.text)} chars, {len(res.words)} words; "
          f"card {card}", flush=True)

    wavs16 = [synth_wav(s, rng) for s in np.linspace(10.0, 20.0, 16)]
    outs, launches["K1"] = run_path(
        "_decode_batch 16 x 10-20 s (K1)",
        lambda: model._decode_batch(wavs16, word_timestamps=True), "K1",
        n_layers)
    if len(outs) != 16 or not all(isinstance(t, str) for t, _ in outs):
        raise AssertionError("_decode_batch returned a malformed batch")
    print(f"  _decode_batch: 16 results; card {card}", flush=True)

    wav45 = synth_wav(45.0, rng)
    (enc, enc_len), launches["K3"] = run_path(
        "encode_batch 45 s, T'=1125 (K3)",
        lambda: model.encode_batch([wav45]), "K3", n_layers)
    if (tuple(enc.shape) != (1, 1125, D_MODEL) or int(enc_len[0]) != 1125
            or not bool(torch.isfinite(enc).all())):
        raise AssertionError(f"encode_batch: {tuple(enc.shape)}, "
                             f"len {enc_len.tolist()}")
    print(f"  encode_batch: {tuple(enc.shape)} finite; card {card}", flush=True)
    return launches


def relpos_main_path(asr, emo, rng, card: str) -> int:
    """v2_ctc ``transcribe`` 20 s and ``_decode_batch`` 16 x 10-20 s
    (T' = 501), emo ``get_probs`` 10 s (T' = 251): K5 in every layer, none
    of K1-K3.  Returns K5's launches over the three paths."""
    n_layers = asr.cfg.encoder.n_layers
    wav20 = synth_wav(20.0, rng)
    res, n_transcribe = run_path(
        "v2_ctc transcribe 20 s, batch 1 (K5)",
        lambda: asr.transcribe(wav20, word_timestamps=True), "K5", n_layers)
    if not (isinstance(res.text, str) and isinstance(res.words, list)):
        raise AssertionError(f"transcribe returned {res!r}")
    print(f"  v2_ctc transcribe: {len(res.text)} chars, {len(res.words)} "
          f"words; card {card}", flush=True)

    wavs16 = [synth_wav(s, rng) for s in np.linspace(10.0, 20.0, 16)]
    outs, n_batch = run_path(
        "v2_ctc _decode_batch 16 x 10-20 s (K5)",
        lambda: asr._decode_batch(wavs16, word_timestamps=True), "K5",
        n_layers)
    if len(outs) != 16 or not all(isinstance(t, str) for t, _ in outs):
        raise AssertionError("_decode_batch returned a malformed batch")
    print(f"  v2_ctc _decode_batch: 16 results; card {card}", flush=True)

    wav10 = synth_wav(10.0, rng)
    probs, n_emo = run_path("emo get_probs 10 s, T'=251 (K5)",
                            lambda: emo.get_probs(wav10), "K5",
                            emo.cfg.encoder.n_layers)
    values = np.array(list(probs.values()))
    if (list(probs) != emo.id2name or not np.isfinite(values).all()
            or abs(values.sum() - 1.0) > 1e-3):
        raise AssertionError(f"get_probs returned {probs}")
    print(f"  emo get_probs: {probs}; card {card}", flush=True)
    return n_transcribe + n_batch + n_emo


def nonzero_pos_biases(model, seed: int) -> None:
    """Draw ``pos_bias_u``/``pos_bias_v`` (zero in a fresh init, as in the
    JAX package) from ``seed``, apart from each other, so that a u/v swap
    changes the output."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in model.encoder.layers:
            for name in ("pos_bias_u", "pos_bias_v"):
                p = layer["self_attn"][name]
                p.copy_(0.5 * torch.randn(p.shape, generator=gen))


def v2_ctc(device=None):
    model = gt.load_model("v2_ctc", init="random", seed=0, device=device)
    nonzero_pos_biases(model, seed=1)
    return model


def reference_phase(model, cpu, rng, paths) -> None:
    """CUDA bf16 against the port's CPU fp32 on the same weights, on small
    inputs through each attention path: 4 s at batch 1, 16 clips of 1-2 s
    and 42 s at batch 1 (T' = 1050, 1051 with v2's centred frames);
    ``paths`` names the kernel of each."""
    cases = ((f"4 s, batch 1 ({paths[0]})", [synth_wav(4.0, rng)]),
             (f"16 x 1-2 s ({paths[1]})", [synth_wav(s, rng)
                                           for s in np.linspace(1.0, 2.0, 16)]),
             (f"42 s, batch 1 ({paths[2]})", [synth_wav(42.0, rng)]))
    name = model.cfg.model_name
    for label, wavs in cases:
        with torch.inference_mode():
            enc_g, len_g = model.encode_batch(wavs)
            enc_c, len_c = cpu.encode_batch(wavs)
            ids_g = ctc_log_probs(model.head, enc_g).argmax(-1).cpu()
            ids_c = ctc_log_probs(cpu.head, enc_c).argmax(-1)
        enc_g, len_g = enc_g.float().cpu(), len_g.cpu()
        if not torch.equal(len_g, len_c) or not bool(torch.isfinite(enc_g).all()):
            raise AssertionError(f"{label}: lengths differ or output not finite")
        rows = torch.arange(enc_c.shape[1])[None, :] < len_c[:, None]
        diff, ref = (enc_g - enc_c)[rows], enc_c[rows]
        max_abs = float(diff.abs().max())
        rel = float(diff.norm() / ref.norm())
        agree = float((ids_g == ids_c)[rows].float().mean())
        print(f"reference {name} {label}, T'={enc_c.shape[1]}: CUDA bf16 vs "
              f"CPU fp32 encoder max_abs {max_abs:.4f}, relative {rel:.4f} "
              f"(tol {ENCODER_RTOL}); greedy ids agree on {agree:.4f} of "
              f"frames", flush=True)
        if not rel <= ENCODER_RTOL:
            raise AssertionError(f"{label}: encoder relative error {rel} > "
                                 f"{ENCODER_RTOL}")


# ---------------------------------------------------------------------------
# Fine-tuning
# ---------------------------------------------------------------------------

def write_train_set(root: str, rng, n: int, lo: float, hi: float) -> str:
    """``n`` synthetic clips of ``lo``-``hi`` seconds as 16-bit WAVs with
    random transcripts over the model's characters; returns the manifest."""
    rows = []
    for i, seconds in enumerate(np.linspace(lo, hi, n)):
        path = os.path.join(root, f"clip{i:02d}.wav")
        save_wav(path, synth_wav(float(seconds), rng))
        n_chars = int(rng.integers(int(2 * seconds), int(4 * seconds)))
        text = "".join(rng.choice(RU_VOCAB, size=n_chars))
        rows.append((path, float(seconds), " ".join(text.split()) or "а"))
    manifest = os.path.join(root, "train.tsv")
    write_manifest(manifest, rows)
    return manifest


def snapshot(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def assert_training_moved(label: str, ft, before: dict) -> None:
    """Every trainable leaf and every BatchNorm buffer differs from
    ``before``; the positional parameters hold a nonzero gradient."""
    stuck = [n for n, p in ft.model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    if stuck:
        raise AssertionError(f"{label}: {len(stuck)} leaves did not move, "
                             f"e.g. {stuck[:3]}")
    n_pos = 0
    for name, p in ft.model.named_parameters():
        if any(k in name for k in ("pos_bias_u", "pos_bias_v", "linear_pos")):
            n_pos += 1
            if p.grad is None or not float(p.grad.abs().max()) > 0.0:
                raise AssertionError(f"{label}: {name} got no gradient")
    print(f"  {label}: all {len(before)} leaves moved (BatchNorm mean/var "
          f"included); {n_pos} positional leaves hold a nonzero gradient",
          flush=True)


def drive_train_steps(label: str, ft, batch, steps: int, want: dict,
                      card: str) -> dict:
    """``steps`` calls of ``train_step`` from zeroed counts, each timed and
    held to ``want`` launches; returns the launches over all steps."""
    total = defaultdict(int)
    marks = []

    def mark(name: str) -> None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))

    ft.on_phase = mark
    for step in range(steps):
        marks.clear()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = ft.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        got = counts()
        for k, n in got.items():
            total[k] += n
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        phases = {b_[0]: a[1].elapsed_time(b_[1])
                  for a, b_ in zip(marks, marks[1:])}
        print(f"train {label} step {step + 1}: {wall_ms:.1f} ms wall, "
              f"forward {phases['forward']:.1f} backward "
              f"{phases['backward']:.1f} optimizer {phases['optimizer']:.1f} "
              f"ms (CUDA events), loss {loss:.4f}, grad_norm {gnorm:.3f}, "
              f"lr {m['lr']:.2e}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
              f"launches {got}; card {card}", flush=True)
        if got != {k: want.get(k, 0) for k in got}:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        if not (math.isfinite(loss) and loss > 0 and math.isfinite(gnorm)
                and gnorm > 0):
            raise AssertionError(f"{label}: loss {loss}, grad_norm {gnorm}")
    ft.on_phase = None
    profile_calls(f"train_step {label}", lambda: ft.train_step(batch), 1,
                  wall_ms)
    return total


def first_batch(manifest: str, tokenizer, batch_size: int, stride: int = 1):
    """The first duration-sorted batch of every ``stride``-th clip."""
    ds = AudioDataset(manifest, tokenizer=tokenizer, return_tokens=True)
    ds.samples = ds.samples[::stride]
    return next(iter(ds.batches(batch_size, sort_by_duration=True)))


def training_path(model_v3, model_v2, manifest: str, card: str) -> dict:
    """The CLI for v3_ctc, then ``FineTuner`` directly for v2_ctc, for v3_ctc
    and for v3_ctc with activation checkpointing; returns the launches."""
    n_layers = model_v3.cfg.encoder.n_layers
    save_dir = os.path.join(os.path.dirname(manifest), "exp")
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    train_cli.main([
        "--model_name", "v3_ctc", "--init", "random", "--seed", "0",
        "--train_manifest", manifest, "--val_manifest", manifest,
        "--batch_size", "16", "--precision", "bf16", "--max_steps", "4",
        "--spec_augment", "--val_first_batches", "1", "--save_top_k", "0",
        "--log_every_n_steps", "1", "--save_dir", save_dir])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    got = counts()
    # 4 train steps (K3 forward, K4 backward), one validation batch at the
    # end of the first epoch and one at the end (K1)
    want = {"K3": 4 * n_layers, "K4": 4 * n_layers, "K1": 2 * n_layers}
    print(f"main path train CLI v3_ctc, 4 steps + 2 validation batches: "
          f"{cli_s:.1f} s, launches {got}; card {card}", flush=True)
    if got != {k: want.get(k, 0) for k in got}:
        raise AssertionError(f"train CLI: launches {got}, expected {want}")
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train_recs = [r for r in recs if r["kind"] == "train"]
    if len(train_recs) != 4 or not all(
            math.isfinite(r["loss"]) and r["loss"] > 0
            and math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
            for r in train_recs):
        raise AssertionError(f"train CLI: metrics {train_recs}")
    if not os.path.exists(os.path.join(save_dir, "final.npz")):
        raise AssertionError("train CLI wrote no final.npz")
    print("  CLI losses " + ", ".join(f"{r['loss']:.4f}" for r in train_recs)
          + "; val " + ", ".join(f"{r['loss']:.4f}" for r in recs
                                  if r["kind"] == "val"), flush=True)
    launches = defaultdict(int, got)
    torch.cuda.empty_cache()

    tc = TrainConfig(total_steps=4, precision="bf16")
    # every other of the 32 clips: 16 clips that span 10-20 s (T' = 500)
    batch = first_batch(manifest, model_v2.tokenizer, 16, stride=2)
    ft = FineTuner(model_v2, tc)
    before = snapshot(model_v2)
    total = drive_train_steps("v2_ctc", ft, batch, 3,
                              {"K5": n_layers, "K6": n_layers}, card)
    assert_training_moved("v2_ctc", ft, before)
    for k, n in total.items():
        launches[k] += n
    del ft, before
    torch.cuda.empty_cache()

    ft = FineTuner(model_v3, tc)
    before = snapshot(model_v3)
    fa.reset_launch_counts()
    loss0, _ = ft.eval_step(batch)
    if counts()["K1"] != n_layers:
        raise AssertionError(f"eval_step: launches {counts()}")
    total = drive_train_steps("v3_ctc", ft, batch, 3,
                              {"K3": n_layers, "K4": n_layers}, card)
    assert_training_moved("v3_ctc", ft, before)
    for k, n in total.items():
        launches[k] += n
    del before
    ft = FineTuner(model_v3, dataclasses.replace(
        tc, activation_checkpointing=True))
    total = drive_train_steps("v3_ctc, activation checkpointing", ft, batch,
                              3, {"K3": 2 * n_layers, "K4": n_layers}, card)
    for k, n in total.items():
        launches[k] += n
    # eval_step goes through K1, whose prepared weights must follow the
    # optimizer's updates
    fa.reset_launch_counts()
    loss1, hyps = ft.eval_step(batch)
    got = counts()
    for layer in model_v3.encoder.layers:
        layer.clear_prepared()
    loss2, _ = ft.eval_step(batch)
    print(f"eval_step v3_ctc: loss {loss0:.4f} before training, {loss1:.4f} "
          f"after, {loss2:.4f} with freshly prepared folded weights; "
          f"launches {got}", flush=True)
    if got != {k: (n_layers if k == "K1" else 0) for k in got}:
        raise AssertionError(f"eval_step: launches {got}")
    if loss1 == loss0 or loss1 != loss2 or len(hyps) != 16:
        raise AssertionError("eval_step does not see the updated weights")
    return launches


GRAD_GROUPS = (
    ("pos biases and linear_pos", r"pos_bias_|linear_pos"),
    ("attention projections", r"self_attn\.linear_"),
    ("FFN", r"feed_forward"),
    ("conv module", r"\.conv\."),
    ("head", r"^head\."),
    ("norms and subsampling", r""),
)


def training_reference_phase(name: str, manifest: str) -> None:
    """One train step at full width, 2 layers, batch 4: the card's bf16 loss
    and gradients against the CPU's fp32 ones on the same weights."""
    cfg = make_preset(name)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, n_layers=2))
    grads, losses = {}, {}
    batch = None
    for device, precision in (("cuda", "bf16"), ("cpu", "fp32")):
        model = gt.GigaAMASR(cfg, device=device, seed=0)
        if name == "v2_ctc":
            nonzero_pos_biases(model, seed=1)
        if batch is None:
            batch = first_batch(manifest, model.tokenizer, 4)
        # no clipping, and the first update has lr 0: the gradients stay in
        # .grad as the backward left them
        ft = FineTuner(model, TrainConfig(total_steps=4, precision=precision,
                                          grad_clip=1e30))
        losses[device] = float(ft.train_step(batch)["loss"])
        grads[device] = {n: p.grad.float().cpu()
                         for n, p in model.named_parameters()
                         if p.grad is not None}
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    groups = defaultdict(lambda: [0.0, 0.0])
    for n, g_ref in grads["cpu"].items():
        group = next(g for g, pattern in GRAD_GROUPS if re.search(pattern, n))
        groups[group][0] += float((grads["cuda"][n] - g_ref).pow(2).sum())
        groups[group][1] += float(g_ref.pow(2).sum())
    rels = {g: math.sqrt(num / den) for g, (num, den) in groups.items()
            if den > 0}
    print(f"training reference {name}, 2 layers, batch 4, T' from "
          f"{batch[0].shape[1] / SAMPLE_RATE:.0f} s: loss CUDA bf16 "
          f"{losses['cuda']:.4f} vs CPU fp32 {losses['cpu']:.4f} (relative "
          f"{loss_rel:.4f}, tol {TRAIN_LOSS_RTOL}); gradient relative "
          f"Frobenius error by group (tol {TRAIN_GRAD_RTOL}): "
          + ", ".join(f"{g} {r:.4f}" for g, r in rels.items()), flush=True)
    if not loss_rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{name}: loss relative error {loss_rel}")
    if not all(r <= TRAIN_GRAD_RTOL for r in rels.values()):
        raise AssertionError(f"{name}: gradient error {rels}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch.cuda.get_device_name(0): {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    logs = []
    build_s = cuda_lib.build(verbose=True, logs=logs)
    print(f"kernel build: {build_s:.1f} s", flush=True)
    resources = cuda_lib.kernel_resources("\n".join(logs))
    print("kernel resources " + json.dumps(resources), flush=True)
    wgmma_kernels = ("sdpa_kernel", "sdpa_bwd_dq_kernel", "sdpa_bwd_dkv_kernel",
                     "relpos_sdpa_kernel", "relpos_bwd_dq_kernel",
                     "relpos_bwd_dkv_kernel")
    if not set(wgmma_kernels) <= set(resources):
        raise AssertionError(f"the build reported {sorted(resources)}")
    spilled = [k for k in wgmma_kernels if resources[k]["spill_bytes"]]
    if spilled:
        raise AssertionError(f"register spills in {spilled}")
    # the rel-pos kernels size their shared memory at launch
    print("kernel dynamic resources "
          + json.dumps(cuda_lib.dynamic_resources()), flush=True)

    rows = kernel_phase(dev)
    gen = torch.Generator().manual_seed(1)
    rows["K4"] = bwd_kernel_phase(gen, dev, relpos=False)
    rows["K6"] = bwd_kernel_phase(gen, dev, relpos=True)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    model = gt.load_model("v3_ctc", init="random", seed=0)
    launches = main_path(model, rng, card)
    reference_phase(model, gt.load_model("v3_ctc", init="random", seed=0,
                                         device="cpu"), rng, ("K2", "K1", "K3"))
    asr = v2_ctc()
    emo = gt.load_model("emo", init="random", seed=0)
    nonzero_pos_biases(emo, seed=2)
    launches["K5"] = relpos_main_path(asr, emo, rng, card)
    del emo
    reference_phase(asr, v2_ctc(device="cpu"), rng, ("K5",) * 3)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as root:
        manifest = write_train_set(root, rng, 32, 10.0, 20.0)
        train_launches = training_path(model, asr, manifest, card)
        del model, asr
        torch.cuda.empty_cache()
        small = os.path.join(root, "small")
        os.makedirs(small)
        manifest = write_train_set(small, rng, 4, 2.0, 4.0)
        for name in ("v3_ctc", "v2_ctc"):
            training_reference_phase(name, manifest)
    launches["K4"], launches["K6"] = train_launches["K4"], train_launches["K6"]

    replaces = {
        "K3": ("fused_mha", "gigaam_tpu_torch/csrc/attention.cu",
               "gigaam_tpu/ops/pallas_attention.py:1108"),
        "K2": ("folded_rotary_attention", "gigaam_tpu_torch/csrc/projection.cu",
               "gigaam_tpu/ops/pallas_attention.py:297"),
        "K1": ("folded_rotary_attention_lnres",
               "gigaam_tpu_torch/csrc/projection.cu",
               "gigaam_tpu/ops/pallas_attention.py:414"),
        "K5": ("fused_relpos_mha", "gigaam_tpu_torch/csrc/relpos_attention.cu",
               "gigaam_tpu/ops/pallas_attention.py:977"),
        "K4": ("mha_bwd", "gigaam_tpu_torch/csrc/attention_bwd.cu",
               "gigaam_tpu/ops/pallas_attention.py:573"),
        "K6": ("relpos_mha_bwd",
               "gigaam_tpu_torch/csrc/relpos_attention_bwd.cu",
               "gigaam_tpu/ops/pallas_attention.py:731"),
    }
    kernels = []
    for key in ("K3", "K2", "K1", "K5", "K4", "K6"):
        name, source, repl = replaces[key]
        r = rows[key]
        kernels.append({
            "name": f"{key} {name}", "route": "cuda", "source": source,
            "replaces": repl, "launches": launches[key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "also": r.get("also", [])})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
