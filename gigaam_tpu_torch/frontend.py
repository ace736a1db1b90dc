"""Log-mel frontend in PyTorch (port of ``gigaam_tpu/frontend.py``).

Framing + window-folded real DFT as one matmul + power + mel filterbank
matmul + log-clamp, the formulation of the JAX package:

  * Hann window, periodic, length ``win_length`` (torch.hann_window default).
  * ``center=True``: reflect-pad by n_fft//2 on both sides;
    ``center=False`` (v3): no padding.  (torch.stft semantics.)
  * power spectrum |X|^2, HTK mel scale, no filterbank norm.
  * log(clamp(x, 1e-9, 1e9))  (``gigaam/preprocess.py:49-50``).
  * output length: center ? len//hop + 1 : (len - win)//hop + 1, clamped
    at 0.

Both products run in full float32 (:func:`ops.precision.full_fp32`): the
log amplifies small power errors, so TF32 would cost ~1e-2 in the log-mel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import FeaturesConfig
from .ops.precision import full_fp32


def hz_to_mel_htk(freq: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def mel_to_hz_htk(mel: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int) -> np.ndarray:
    """Triangular mel filterbank [n_freqs, n_mels], HTK scale, no norm
    (torchaudio ``melscale_fbanks(..., norm=None, mel_scale="htk")``)."""
    f_max = sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel_htk(0.0), hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]                       # [n_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]          # [n_freqs, n_mels+2]
    down = -slopes[:, :-2] / f_diff[:-1]                  # rising edge
    up = slopes[:, 2:] / f_diff[1:]                       # falling edge
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def hann_window_periodic(win_length: int) -> np.ndarray:
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


def _windowed_dft_matrices(n_fft: int, win_length: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis with the Hann window folded in, each
    [n_fft, n_fft//2 + 1]: frames @ cos_mat, frames @ sin_mat."""
    window = hann_window_periodic(win_length)
    if win_length < n_fft:  # center window inside the FFT frame (torch.stft)
        pad_l = (n_fft - win_length) // 2
        window = np.pad(window, (pad_l, n_fft - win_length - pad_l))
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    cos_mat = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_mat = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_mat, sin_mat


def num_frames(num_samples: int, cfg: FeaturesConfig) -> int:
    """Static frame count for a given waveform length."""
    if cfg.center:
        return num_samples // cfg.hop_length + 1
    span = max(cfg.n_fft, cfg.win_length)
    return (num_samples - span) // cfg.hop_length + 1


def out_len(lengths: torch.Tensor, cfg: FeaturesConfig) -> torch.Tensor:
    """Valid feature length per sample, clamped at 0 (center=False audio
    shorter than one window would otherwise give a negative length)."""
    if cfg.center:
        return lengths // cfg.hop_length + 1
    span = max(cfg.n_fft, cfg.win_length)
    return torch.clamp((lengths - span) // cfg.hop_length + 1, min=0)


class LogMelFrontend(nn.Module):
    """Feature extractor: wav [B, L] -> (logmel [B, F, T], lens [B]).

    The windowed DFT basis and the mel filterbank are buffers, so the
    module follows ``.to(device)``.  Framing reshapes the wav into
    hop-sized rows and builds each frame from ceil(n_fft/hop) contiguous row
    slices; the basis is zero-padded to that frame width, so framing +
    windowed DFT is slice/concat + one matmul.
    """

    def __init__(self, cfg: FeaturesConfig):
        super().__init__()
        self.cfg = cfg
        cos_mat, sin_mat = _windowed_dft_matrices(cfg.n_fft, cfg.win_length)
        fb = mel_filterbank(cfg.n_fft // 2 + 1, cfg.features, cfg.sample_rate)
        n_rows = -(-cfg.n_fft // cfg.hop_length)
        basis = np.concatenate([cos_mat, sin_mat], axis=1)  # [n_fft, 2K]
        pad_rows = n_rows * cfg.hop_length - cfg.n_fft
        self._n_rows = n_rows
        self.register_buffer(
            "basis", torch.from_numpy(np.pad(basis, ((0, pad_rows), (0, 0)))))
        self.register_buffer("fb", torch.from_numpy(fb))

    def forward(self, wavs: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        wavs = wavs.float()
        if wavs.ndim == 1:
            wavs = wavs[None, :]
        if cfg.center:
            pad = cfg.n_fft // 2
            wavs = F.pad(wavs[:, None, :], (pad, pad), mode="reflect")[:, 0]
        hop, n_rows = cfg.hop_length, self._n_rows
        n_samples = wavs.shape[1]
        t_frames = (n_samples - cfg.n_fft) // hop + 1
        rows_needed = t_frames - 1 + n_rows
        pad_to = rows_needed * hop
        if pad_to > n_samples:
            wavs = F.pad(wavs, (0, pad_to - n_samples))
        else:
            wavs = wavs[:, :pad_to]
        rows = wavs.reshape(wavs.shape[0], rows_needed, hop)
        frames = torch.cat([rows[:, i:i + t_frames] for i in range(n_rows)],
                           dim=-1)                         # [B, T, rows*hop]
        with full_fp32():
            re_im = frames @ self.basis
            re, im = re_im.chunk(2, dim=-1)
            power = re * re + im * im                      # [B, T, n_freqs]
            mel = power @ self.fb
        logmel = torch.log(torch.clamp(mel, 1e-9, 1e9))
        return logmel.transpose(1, 2), out_len(lengths, cfg)
