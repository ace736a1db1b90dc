#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card (``nvidia-smi`` name and power limit, torch's name);
2. build the hand-written kernels (``gigaam_tpu_torch/csrc``, one ``nvcc``
   per source, all started together);
3. hold each kernel (K3, K2, K1, K5) against its plain PyTorch version at
   the main path's shapes in bf16, show that the check fails for a kernel
   with a planted fault (fed through its inputs: RoPE sign flipped, key mask
   ignored, 1/sqrt(d_h) missing, q zeroed, LayerNorm skipped; for K5 also
   q_u/q_v swapped, the shift reversed, the positional term dropped), and
   time the kernel, its plain version and the library call with CUDA
   events;
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
   16 x 1-2 s and 42 s (T' = 1051).

The last two lines are a JSON object with every kernel's numbers and
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
there is no CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

import gigaam_tpu_torch as gt
from gigaam_tpu_torch.config import SAMPLE_RATE
from gigaam_tpu_torch.models.heads import ctc_log_probs
from gigaam_tpu_torch.ops import cuda_lib
from gigaam_tpu_torch.ops import fused_attention as fa
from gigaam_tpu_torch.ops.rotary import rotary_tables

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

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): bf16 tensor cores, fp32
# outside them, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

D_MODEL, N_HEADS, D_HEAD = 768, 16, 48

# device-time groups of the main-path profile, matched in this order
PROFILE_GROUPS = (
    # sdpa_kernel matches K5's relpos_sdpa_kernel too
    ("attention kernels (csrc)", r"sdpa_kernel|qkv_kernel|out_proj_kernel"),
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


def kernel_phase(dev) -> dict:
    """Each kernel against its plain version; returns the JSON rows.  The
    planted faults run at the shape the JSON row reports."""
    gen = torch.Generator().manual_seed(0)
    rows = {}
    # K3 at T' = 500 (B 1 and 16) and at the main path's T' = 1125 (B 1)
    for b, t in ((1, 500), (16, 500), (1, 1125)):
        q, k, v = (torch.randn(b, N_HEADS, t, D_HEAD, generator=gen)
                   * gain for gain in (QK_GAIN, QK_GAIN, 1.0))
        q, k, v = (a.to(dev, torch.bfloat16) for a in (q, k, v))
        valid = ragged_valid(b, t, dev)
        got = fa.fused_mha(q, k, v, valid)
        ref = fa.mha_plain(q, k, v, valid)
        faults = () if (b, t) != (1, 1125) else (
            ("key mask ignored",
             lambda: fa.fused_mha(q, k, v, torch.ones_like(valid))),
            ("1/sqrt(d_h) missing",
             lambda: fa.fused_mha(q * math.sqrt(D_HEAD), k, v, valid)),
            ("q zeroed",
             lambda: fa.fused_mha(torch.zeros_like(q), k, v, valid)))
        err, rel = check_kernel(f"K3 B={b} T'={t}", got, ref, valid, 2, faults)
        ms = time_ms(lambda: fa.fused_mha(q, k, v, valid))
        plain_ms = time_ms(lambda: fa.mha_plain(q, k, v, valid), iters=5)
        mask4 = valid[:, None, None, :]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask4))
        scores = b * N_HEADS * t * t
        bms, by = bound(4 * b * N_HEADS * t * D_HEAD * 2 + b * t,
                        4 * scores * D_HEAD, 4 * scores)
        print(f"K3 fused_mha B={b} T'={t}: max_abs_err {err:.3e}, "
              f"{rel:.4f} x RMS (limit {KERNEL_REL}); kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, F.sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})",
              flush=True)
        if (b, t) == (1, 1125):
            rows["K3"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                              bound_by=by, library_ms=lib_ms, max_abs_err=err)

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
                                  bound_by=by, library_ms=None, max_abs_err=err)
    rows["K5"] = relpos_kernel_phase(gen, dev)
    return rows


def relpos_kernel_phase(gen, dev) -> dict:
    """K5 at the v2 main path's T' = 501 (B 1 and 16) and at T' = 1126
    (B 1, a 45 s clip); the faults and the JSON row at B 16."""
    row = None
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
        ref = fa.relpos_mha_plain(*args)
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
        plain_ms = time_ms(lambda: fa.relpos_mha_plain(*args), iters=5)
        scores = b * N_HEADS * t * t
        bms, by = bound(
            (5 * b * N_HEADS * t * D_HEAD + N_HEADS * (2 * t - 1) * D_HEAD) * 2
            + b * t, 6 * scores * D_HEAD, 5 * scores)
        print(f"K5 fused_relpos_mha B={b} T'={t}: max_abs_err {err:.3e}, "
              f"{rel:.4f} x RMS (limit {KERNEL_REL}); kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
        if (b, t) == (16, 501):
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                       library_ms=None, max_abs_err=err)
    return row


def counts() -> dict:
    return {"K3": fa.fused_mha.launches,
            "K2": fa.folded_rotary_attention.launches,
            "K1": fa.folded_rotary_attention_lnres.launches,
            "K5": fa.fused_relpos_mha.launches}


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
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
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

    build_s = cuda_lib.build(verbose=True)
    print(f"kernel build: {build_s:.1f} s", flush=True)

    rows = kernel_phase(dev)
    rng = np.random.default_rng(0)
    model = gt.load_model("v3_ctc", init="random", seed=0)
    launches = main_path(model, rng, card)
    reference_phase(model, gt.load_model("v3_ctc", init="random", seed=0,
                                         device="cpu"), rng, ("K2", "K1", "K3"))
    del model
    torch.cuda.empty_cache()

    asr = v2_ctc()
    emo = gt.load_model("emo", init="random", seed=0)
    nonzero_pos_biases(emo, seed=2)
    launches["K5"] = relpos_main_path(asr, emo, rng, card)
    del emo
    reference_phase(asr, v2_ctc(device="cpu"), rng, ("K5",) * 3)

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
    }
    kernels = []
    for key in ("K3", "K2", "K1", "K5"):
        name, source, repl = replaces[key]
        r = rows[key]
        kernels.append({
            "name": f"{key} {name}", "route": "cuda", "source": source,
            "replaces": repl, "launches": launches[key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
