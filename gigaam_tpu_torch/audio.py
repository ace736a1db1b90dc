"""Audio loading and resampling, free of the hot path (copy of
``gigaam_tpu/audio.py``, kept so the port never imports the JAX package).

The reference shells out to ffmpeg for every ``load_audio`` call
(``gigaam/preprocess.py:12-40``).  We decode WAV natively (stdlib ``wave`` +
numpy) and only fall back to an ffmpeg subprocess for non-WAV containers, so
the common path has no process boundary.  Resampling is windowed-sinc
(kaiser-windowed polyphase via scipy), done once on the host — the device
pipeline always sees 16 kHz float32.
"""

from __future__ import annotations

import shutil
import struct
import wave
from subprocess import CalledProcessError, run
from typing import Tuple

import numpy as np

from .config import SAMPLE_RATE


def _decode_wav(src) -> Tuple[np.ndarray, int]:
    """Decode a PCM WAV via stdlib. Returns (float32 mono [-1,1], sr).

    ``src`` is a filename or a binary file-like object (``wave.open``
    accepts both) — the HTTP server decodes request bodies through here so
    file and wire paths support the same sample widths (8/16/24/32-bit)."""
    with wave.open(src, "rb") as wf:
        n_channels = wf.getnchannels()
        sampwidth = wf.getsampwidth()
        sr = wf.getframerate()
        n_frames = wf.getnframes()
        raw = wf.readframes(n_frames)

    if sampwidth == 2:
        from . import native

        pcm = np.frombuffer(raw, dtype="<i2")
        if n_channels > 1:
            # native interleaved mixdown: no f32 expansion + reshape + mean
            return native.s16_interleaved_to_mono(pcm, n_channels), sr
        data = native.s16_to_f32(pcm)
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (
            a[:, 0].astype(np.int32)
            | (a[:, 1].astype(np.int32) << 8)
            | (a[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= (1 << 23), vals - (1 << 24), vals)
        data = vals.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"Unsupported WAV sample width: {sampwidth}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, sr


def _decode_ffmpeg(path: str, sample_rate: int) -> np.ndarray:
    """ffmpeg fallback matching the reference command line
    (``gigaam/preprocess.py:16-34``): s16le mono at target rate, /32768."""
    cmd = [
        "ffmpeg", "-nostdin", "-threads", "0", "-i", path,
        "-f", "s16le", "-ac", "1", "-acodec", "pcm_s16le",
        "-ar", str(sample_rate), "-",
    ]
    try:
        audio = run(cmd, capture_output=True, check=True).stdout
    except (CalledProcessError, FileNotFoundError) as exc:
        raise RuntimeError("Failed to load audio") from exc
    return np.frombuffer(audio, dtype="<i2").astype(np.float32) / 32768.0


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase windowed-sinc resampling.

    Tap design (kaiser beta=5 sinc) happens in Python; the upfirdn inner
    loop runs in the native C++ kernel when built (``native/native.cpp``),
    with a scipy fallback.
    """
    if orig_sr == target_sr:
        return wav
    from math import gcd

    g = gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g

    from scipy.signal import firwin

    from . import native

    max_rate = max(up, down)
    half_len = 10 * max_rate
    taps = firwin(2 * half_len + 1, 1.0 / max_rate,
                  window=("kaiser", 5.0)).astype(np.float32)
    n_out = int(np.ceil(len(wav) * up / down))
    return native.resample_poly(wav.astype(np.float32), up, down, taps,
                                offset=half_len, n_out=n_out)


def load_audio(audio_path: str, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Load an audio file and resample to ``sample_rate``.

    Native WAV decode first; ffmpeg subprocess only for other containers
    (reference always shells out: ``gigaam/preprocess.py:12-40``).
    Returns float32 mono waveform in [-1, 1].
    """
    try:
        wav, sr = _decode_wav(audio_path)
    except (wave.Error, EOFError, struct.error, ValueError):
        if shutil.which("ffmpeg") is None:
            raise RuntimeError(
                f"Cannot decode {audio_path!r}: not a PCM WAV and ffmpeg "
                "is not available"
            )
        return _decode_ffmpeg(audio_path, sample_rate)
    return resample(wav, sr, sample_rate)


def save_wav(path: str, wav: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    """Write a float32 mono waveform as 16-bit PCM WAV (test/tool helper)."""
    data = np.clip(wav, -1.0, 1.0)
    pcm = (data * 32767.0).astype("<i2")
    with wave.open(path, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm.tobytes())
