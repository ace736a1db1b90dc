"""PyanNet neural VAD (pyannote ``segmentation-3.0``), port of
``gigaam_tpu/models/vad_net.py``:

    wav -> InstanceNorm -> sinc FIR conv (80 x 251, stride 10) -> |.|
        -> [MaxPool(3) -> InstanceNorm -> LeakyReLU]
        -> 2 x [Conv1d(60, k=5) -> MaxPool(3) -> InstanceNorm -> LeakyReLU]
        -> 4-layer BiLSTM(128) -> 2 x [Linear(128) -> LeakyReLU]
        -> Linear(n_classes) -> log_softmax            (powerset classes)

* The sinc filterbank is materialised as plain FIR taps (conversion time,
  ``gigaam_tpu.checkpoint.convert_pyannote_vad``), so the hot path is one
  strided ``F.conv1d``; on the card the convolutions and the LSTM are
  cuDNN's (``nn.LSTM(bidirectional=True)`` concatenates [forward,
  backward] as the JAX ``_bilstm`` does).
* Everything runs in float32 under ``ops/precision.py::full_fp32``, so that
  TF32 touches neither the sinc conv nor the LSTM.
* Long audio is cut into sliding windows on the host and classified in
  mega-batches of at most 64 windows (rows padded to a multiple of 8), the
  overlapping frames averaged.

Layouts (the port's state): taps [F, 1, K] and conv weights [Cout, Cin, K]
(torch's); the LSTM under ``nn.LSTM``'s names; linears ``w`` [in, out], as
in the JAX tree.  ``weights.vad_params_from_jax``/``vad_params_to_jax``
carry a JAX tree across, and ``save_vad``/``load_vad`` write and read the
JAX package's artifact (npz + json), so one converted file serves both
packages.

Speech is the powerset convention: a frame is speech iff its argmax class
is not the empty set (class 0).  The chunk policy on top lives in
``gigaam_tpu_torch/vad.py``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.precision import full_fp32
from ..weights import (
    _flatten,
    _unflatten,
    vad_params_from_jax,
    vad_params_to_jax,
)
from .encoder import as_module
from .model import resolve_device

IN_EPS = 1e-5               # torch nn.InstanceNorm1d default
LEAKY_SLOPE = 0.01          # torch nn.LeakyReLU default
MEGA_BATCH = 64             # windows per device call
ROW_MULTIPLE = 8            # a call's rows pad to a multiple of this


@dataclass(frozen=True)
class VADNetConfig:
    """Architecture hyperparameters (defaults = pyannote segmentation-3.0)."""

    sample_rate: int = 16000
    sinc_filters: int = 80
    sinc_kernel: int = 251
    sinc_stride: int = 10
    conv_channels: int = 60
    conv_kernel: int = 5
    n_conv_blocks: int = 2
    pool: int = 3
    lstm_hidden: int = 128
    lstm_layers: int = 4
    linear_hidden: int = 128
    linear_layers: int = 2
    # powerset over 3 speakers, <=2 simultaneous: {}, 3 singles, 3 pairs
    n_classes: int = 7
    # sliding-window inference (pyannote uses 10 s windows for seg-3.0)
    window_s: float = 10.0
    step_s: float = 5.0

    def receptive_field(self) -> Tuple[int, int]:
        """(kernel, stride) of one output frame in input samples."""
        k, s = self.sinc_kernel, self.sinc_stride
        k, s = k + (self.pool - 1) * s, s * self.pool
        for _ in range(self.n_conv_blocks):
            k = k + (self.conv_kernel - 1) * s
            k, s = k + (self.pool - 1) * s, s * self.pool
        return k, s

    def num_frames(self, n_samples: int) -> int:
        t = (n_samples - self.sinc_kernel) // self.sinc_stride + 1
        t = t // self.pool
        for _ in range(self.n_conv_blocks):
            t = t - (self.conv_kernel - 1)
            t = t // self.pool
        return t


def _instance_norm(p, x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm1d with an affine, over time: x [B, C, T], statistics
    per (sample, channel) in fp32."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + IN_EPS)
    return y * p["w"][:, None] + p["b"][:, None]


def _pool_norm_act(p, x: torch.Tensor, pool: int) -> torch.Tensor:
    x = F.max_pool1d(x, pool)                 # floor mode, as the JAX pool
    return F.leaky_relu(_instance_norm(p, x), LEAKY_SLOPE)


class PyanNet(nn.Module):
    """The frame classifier; ``forward`` is the JAX ``frame_logits``."""

    def __init__(self, cfg: VADNetConfig, state: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.wav_norm = as_module(state["wav_norm"])
        self.sinc = as_module(state["sinc"])
        self.norms = as_module(state["norms"])
        self.convs = as_module(state["convs"])
        self.lstm = nn.LSTM(cfg.conv_channels, cfg.lstm_hidden,
                            num_layers=cfg.lstm_layers, bidirectional=True,
                            batch_first=True)
        self.lstm.load_state_dict(state["lstm"])
        self.lstm.requires_grad_(False)
        self.linear = as_module(state["linear"])
        self.classifier = as_module(state["classifier"])

    @property
    def device(self) -> torch.device:
        return self.sinc["taps"].device

    def forward(self, wavs: torch.Tensor) -> torch.Tensor:
        """wavs [B, N] float32 -> log-probs [B, T_frames, n_classes]."""
        cfg = self.cfg
        with full_fp32():
            x = _instance_norm(self.wav_norm, wavs[:, None, :].float())
            x = F.conv1d(x, self.sinc["taps"], stride=cfg.sinc_stride).abs()
            x = _pool_norm_act(self.norms[0], x, cfg.pool)
            for norm, conv in zip(self.norms[1:], self.convs):
                x = F.conv1d(x, conv["w"], conv["b"])
                x = _pool_norm_act(norm, x, cfg.pool)
            x, _ = self.lstm(x.transpose(1, 2).contiguous())    # [B, T, 2H]
            for lin in self.linear:
                x = F.leaky_relu(x @ lin["w"] + lin["b"], LEAKY_SLOPE)
            logits = x @ self.classifier["w"] + self.classifier["b"]
            return torch.log_softmax(logits, dim=-1)


def init_vad_state(cfg: VADNetConfig, seed: int = 0) -> Dict[str, Any]:
    """Random weights in the port's layout from a ``torch.Generator``
    seeded with ``seed``, with the JAX ``init_vad_params``'s distributions
    (tests and smoke runs; real weights come from a converted artifact)."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    def lin(i, o):
        return {"w": normal(i, o, scale=1.0 / math.sqrt(i)),
                "b": torch.zeros(o)}

    def norm(c):
        return {"w": torch.ones(c), "b": torch.zeros(c)}

    c, h = cfg.conv_channels, cfg.lstm_hidden
    convs = [{"w": normal(c, cfg.sinc_filters if i == 0 else c,
                          cfg.conv_kernel, scale=0.05),
              "b": torch.zeros(c)} for i in range(cfg.n_conv_blocks)]
    lstm = {}
    for k in range(cfg.lstm_layers):
        d_in = c if k == 0 else 2 * h
        for suffix in ("", "_reverse"):
            lstm[f"weight_ih_l{k}{suffix}"] = normal(
                4 * h, d_in, scale=1.0 / math.sqrt(d_in))
            lstm[f"weight_hh_l{k}{suffix}"] = normal(
                4 * h, h, scale=1.0 / math.sqrt(h))
            lstm[f"bias_ih_l{k}{suffix}"] = torch.zeros(4 * h)
            lstm[f"bias_hh_l{k}{suffix}"] = torch.zeros(4 * h)
    linear, d = [], 2 * h
    for _ in range(cfg.linear_layers):
        linear.append(lin(d, cfg.linear_hidden))
        d = cfg.linear_hidden
    return {
        "wav_norm": norm(1),
        "sinc": {"taps": normal(cfg.sinc_filters, 1, cfg.sinc_kernel,
                                scale=0.02)},
        "norms": [norm(cfg.sinc_filters)]
        + [norm(c) for _ in range(cfg.n_conv_blocks)],
        "convs": convs,
        "lstm": lstm,
        "linear": linear,
        "classifier": lin(d, cfg.n_classes),
    }


# ---------------------------------------------------------------------------
# sliding-window inference
# ---------------------------------------------------------------------------

@torch.inference_mode()
def _window_probs(net: PyanNet, windows: np.ndarray) -> np.ndarray:
    """Class probabilities [rows, frames, classes] of one mega-batch."""
    x = torch.from_numpy(windows)
    if net.device.type == "cuda":
        x = x.pin_memory().to(net.device, non_blocking=True)
    return torch.exp(net(x)).cpu().numpy()


def sliding_class_probs(net: PyanNet, wav: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Classify a waveform with overlap-averaged sliding windows: (probs
    [N, n_classes], frame centre times [N] in seconds)."""
    cfg = net.cfg
    wav = np.asarray(wav, dtype=np.float32)
    sr = cfg.sample_rate
    rf_k, rf_s = cfg.receptive_field()
    win = int(cfg.window_s * sr)
    # the hop snapped to whole output frames, so that every window's frame
    # grid lies on the global one (exact overlap-averaging)
    step = max(rf_s, int(cfg.step_s * sr) // rf_s * rf_s)

    if len(wav) < rf_k:
        wav = np.pad(wav, (0, rf_k - len(wav)))
    audio_len = len(wav)
    if len(wav) <= win:
        # one zero-padded window of the canonical length: every clip
        # shorter than window_s has the same shapes; the padded frames are
        # dropped below
        starts = [0]
        wav = np.pad(wav, (0, win - len(wav)))
    else:
        # starts are multiples of step; the last window is zero-padded
        starts = list(range(0, len(wav) - win + step, step))

    frames_per_win = cfg.num_frames(win)
    # bounded mega-batches: host and device memory stay O(MEGA_BATCH)
    # windows whatever the recording's length
    parts = []
    for c0 in range(0, len(starts), MEGA_BATCH):
        chunk = starts[c0:c0 + MEGA_BATCH]
        n_pad = -len(chunk) % ROW_MULTIPLE
        windows = np.zeros((len(chunk) + n_pad, win), dtype=np.float32)
        for i, s in enumerate(chunk):
            seg = wav[s:s + win]
            windows[i, :len(seg)] = seg
        parts.append(_window_probs(net, windows)[:len(chunk)])
    probs = np.concatenate(parts, axis=0)

    n_frames = (starts[-1] // rf_s) + frames_per_win
    acc = np.zeros((n_frames, probs.shape[-1]), dtype=np.float64)
    cnt = np.zeros((n_frames, 1), dtype=np.float64)
    for i, s in enumerate(starts):
        f0 = s // rf_s
        acc[f0:f0 + frames_per_win] += probs[i]
        cnt[f0:f0 + frames_per_win] += 1.0
    avg = (acc / np.maximum(cnt, 1.0)).astype(np.float32)
    times = (np.arange(n_frames) * rf_s + rf_k / 2) / sr
    # frames whose receptive field starts past the audio see only the zero
    # padding of the last window, which can argmax to a speech class: keep
    # the frames that start inside the audio
    keep = (np.arange(n_frames) * rf_s) < audio_len
    return avg[keep], times[keep]


def speech_regions(net: PyanNet, wav: np.ndarray,
                   min_duration_on: float = 0.0,
                   min_duration_off: float = 0.0) -> List[Tuple[float, float]]:
    """(start, end) speech regions from the powerset argmax (speech iff the
    argmax is not the empty-set class), as the reference's pipeline with
    ``min_duration_on/off = 0.0`` (``gigaam/vad_utils.py:75``)."""
    cfg = net.cfg
    probs, times = sliding_class_probs(net, wav)
    speech = probs.argmax(axis=-1) != 0
    _, rf_s = cfg.receptive_field()
    half = rf_s / cfg.sample_rate / 2
    total = len(wav) / cfg.sample_rate

    regions: List[Tuple[float, float]] = []
    start = None
    for i, s in enumerate(speech):
        if s and start is None:
            start = max(0.0, times[i] - half)
        elif not s and start is not None:
            regions.append((start, min(total, times[i - 1] + half)))
            start = None
    if start is not None:
        regions.append((start, total))

    if min_duration_off > 0 and regions:
        merged = [regions[0]]
        for s, e in regions[1:]:
            if s - merged[-1][1] < min_duration_off:
                merged[-1] = (merged[-1][0], e)
            else:
                merged.append((s, e))
        regions = merged
    if min_duration_on > 0:
        regions = [(s, e) for s, e in regions if e - s >= min_duration_on]
    return regions


def make_speech_regions_fn(net: PyanNet):
    """Adapter for ``vad.segment_audio_file(speech_regions_fn=)``."""
    return lambda wav: speech_regions(net, wav)


# ---------------------------------------------------------------------------
# artifacts: the JAX package's npz + json pair
# ---------------------------------------------------------------------------

def save_vad(path: str, net: PyanNet) -> None:
    """Write ``net`` as the JAX ``save_vad`` pair: ``<base>.npz`` (the JAX
    tree's leaves under ``/``-joined keys) and ``<base>.json`` (the
    config)."""
    base = path[:-4] if path.endswith(".npz") else path
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    np.savez(base + ".npz", **_flatten(vad_params_to_jax(net)))
    with open(base + ".json", "w") as f:
        json.dump(dataclasses.asdict(net.cfg), f, indent=2)


def load_vad(path: str) -> Tuple[VADNetConfig, Dict[str, Any]]:
    """Read a ``save_vad`` pair (either package's): (config, state in the
    port's layout, CPU tensors)."""
    base = path[:-4] if path.endswith(".npz") else path
    with open(base + ".json") as f:
        cfg = VADNetConfig(**json.load(f))
    with np.load(base + ".npz") as z:
        params = _unflatten({k: z[k] for k in z.files})
    return cfg, vad_params_from_jax(params)


def load_vad_regions_fn(path: str, device: Optional[Any] = None):
    """Artifact path -> ``speech_regions_fn`` on ``device`` (None: the
    card; it raises without CUDA)."""
    device = resolve_device(device)
    return make_speech_regions_fn(PyanNet(*load_vad(path)).to(device))
