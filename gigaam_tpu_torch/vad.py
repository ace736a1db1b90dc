"""Voice-activity segmentation for longform transcription (port of
``gigaam_tpu/vad.py``).

The chunking policy is the reference's (greedy merge of speech regions into
15-22 s chunks, hard split above 30 s, drop below 0.2 s,
``gigaam/vad_utils.py:104-136``); the speech detector is pluggable:

* the default is a dependency-free energy VAD on the host (frame RMS in dB
  over 30 ms windows with a 10 ms hop, an adaptive threshold between the
  noise floor and the speech level, hangover smoothing);
* a PyanNet artifact (``models/vad_net.py``, the npz + json pair that
  either package's ``save_vad`` writes) found by ``_discover_neural_vad``
  (``$GIGAAM_VAD_ARTIFACT``, then ``~/.cache/gigaam_tpu/
  vad_segmentation.npz``) becomes the default detector; it runs on the
  device it is given, the card unless the caller passes ``device="cpu"``;
* ``speech_regions_fn`` overrides both.

Numpy only, apart from the neural detector.
"""

from __future__ import annotations

import os
import warnings
import zipfile
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

from .audio import load_audio, resample
from .config import SAMPLE_RATE

Region = Tuple[float, float]

CACHE_DIR = os.path.expanduser("~/.cache/gigaam_tpu")

# the detector of the last artifact looked up, keyed by (path, device),
# failures included: an unusable artifact warns once, not on every call
_NEURAL_VAD: Optional[Tuple[Tuple[str, str], Optional[Callable]]] = None

# what reading a broken artifact raises: a missing or truncated file, a
# file that is not a zip, bad json, keys or shapes that do not fit the
# config
_UNREADABLE = (OSError, EOFError, ValueError, KeyError, TypeError,
               IndexError, RuntimeError, zipfile.BadZipFile)


def _discover_neural_vad(device=None
                         ) -> Optional[Callable[[np.ndarray], List[Region]]]:
    """The neural detector of the artifact at ``$GIGAAM_VAD_ARTIFACT`` (set
    it to ``energy``, ``off``, ``none`` or ``0`` for the energy VAD) or at
    ``<cache>/vad_segmentation.npz``, on ``device`` (None: the card, which
    raises without CUDA); None when there is no artifact.

    An artifact that cannot be read becomes the energy VAD with a warning,
    as in the JAX package (a half-written file in the cache must not break
    every ``transcribe_longform``).  That is a choice of detector: an
    artifact that reads but does not run on the device raises."""
    global _NEURAL_VAD
    from .models.model import resolve_device
    from .models.vad_net import PyanNet, load_vad, make_speech_regions_fn

    path = os.environ.get("GIGAAM_VAD_ARTIFACT")
    if path and path.lower() in ("0", "off", "energy", "none"):
        return None
    if not path:
        path = os.path.join(CACHE_DIR, "vad_segmentation.npz")
    if not os.path.isfile(path) and not os.path.isfile(path + ".npz"):
        return None
    device = resolve_device(device)
    key = (path, str(device))
    if _NEURAL_VAD is not None and _NEURAL_VAD[0] == key:
        return _NEURAL_VAD[1]
    try:
        net = PyanNet(*load_vad(path))
    except _UNREADABLE as e:
        warnings.warn(f"ignoring unusable VAD artifact {path!r}: {e}; "
                      f"falling back to the energy VAD")
        fn = None
    else:
        fn = make_speech_regions_fn(net.to(device))
    _NEURAL_VAD = (key, fn)
    return fn


def energy_speech_regions(
    wav: np.ndarray,
    sr: int = SAMPLE_RATE,
    frame_ms: float = 30.0,
    hop_ms: float = 10.0,
    threshold_db: float = 9.0,
    hangover_ms: float = 300.0,
    min_speech_ms: float = 90.0,
) -> List[Region]:
    """Energy-based VAD: merged (start, end) speech regions in seconds."""
    frame = int(sr * frame_ms / 1000)
    hop = int(sr * hop_ms / 1000)
    # absolute silence gate: an adaptive threshold on digital silence would
    # otherwise call everything speech
    SILENCE_DBFS = -55.0
    if len(wav) < frame:
        if not len(wav):
            return []
        level = 20.0 * np.log10(
            float(np.sqrt(np.mean(np.square(wav, dtype=np.float64)))) + 1e-12)
        return [] if level < SILENCE_DBFS else [(0.0, len(wav) / sr)]

    n = (len(wav) - frame) // hop + 1
    # frame energies from a cumulative sum of wav^2: O(N), no [n, frame]
    # gather
    cs = np.concatenate(([0.0], np.cumsum(np.square(wav, dtype=np.float64))))
    starts = np.arange(n) * hop
    rms = np.sqrt((cs[starts + frame] - cs[starts]) / frame + 1e-12)
    db = 20.0 * np.log10(rms + 1e-12)

    floor = np.percentile(db, 10)
    ceil = np.percentile(db, 95)
    if ceil < SILENCE_DBFS:  # noise floor only: no speech anywhere
        return []
    if ceil - floor < 3.0:   # roughly stationary signal: all speech
        return [(0.0, len(wav) / sr)]
    thresh = min(floor + threshold_db, ceil - 3.0)
    speech = db > thresh

    # hangover: frame i is on iff a speech frame lies within the last
    # ``hang`` frames
    hang = max(1, int(hangover_ms / hop_ms))
    last = np.maximum.accumulate(np.where(speech, np.arange(n), -1))
    smoothed = (last >= 0) & (np.arange(n) - last < hang)

    # regions from on/off transitions; the last active frame is off-1,
    # covering samples up to (off-1)*hop + frame
    padded = np.concatenate(([False], smoothed, [False]))
    edges = np.flatnonzero(np.diff(padded.astype(np.int8)))
    regions: List[Region] = []
    for on, off in zip(edges[0::2], edges[1::2]):
        if off >= n:  # ran to the end of the signal
            regions.append((on * hop / sr, len(wav) / sr))
        else:
            regions.append((on * hop / sr, ((off - 1) * hop + frame) / sr))

    min_len = min_speech_ms / 1000.0
    return [(s, e) for s, e in regions if e - s >= min_len]


def merge_regions_into_chunks(
    regions: List[Region],
    total_duration: float,
    max_duration: float = 22.0,
    min_duration: float = 15.0,
    strict_limit_duration: float = 30.0,
    new_chunk_threshold: float = 0.2,
) -> List[Region]:
    """Greedy chunk merge with the reference's policy
    (``gigaam/vad_utils.py:104-136``): grow a chunk with successive speech
    regions until it would exceed ``max_duration`` (or already exceeds
    ``min_duration``), split any chunk above ``strict_limit_duration``
    evenly, drop chunks below ``new_chunk_threshold``."""
    chunks: List[Region] = []

    def emit(start: float, end: float) -> None:
        duration = end - start
        if duration > strict_limit_duration:
            parts = int(duration / strict_limit_duration) + 1
            step = duration / parts
            for p in range(parts):
                chunks.append((start + p * step, start + (p + 1) * step))
        else:
            chunks.append((start, end))

    cur_start = cur_end = None
    for start, end in regions:
        start = max(0.0, start)
        end = min(total_duration, end)
        if cur_start is None:
            cur_start, cur_end = start, end
            continue
        cur_duration = cur_end - cur_start
        if cur_duration > new_chunk_threshold and (
            cur_duration + (end - cur_end) > max_duration
            or cur_duration > min_duration
        ):
            emit(cur_start, cur_end)
            cur_start = start
        cur_end = end

    if cur_start is not None and (cur_end - cur_start) > new_chunk_threshold:
        emit(cur_start, cur_end)
    return chunks


def segment_audio_file(
    wav_file: Union[str, np.ndarray],
    sr: int = SAMPLE_RATE,
    max_duration: float = 22.0,
    min_duration: float = 15.0,
    strict_limit_duration: float = 30.0,
    new_chunk_threshold: float = 0.2,
    speech_regions_fn: Optional[Callable[[np.ndarray], List[Region]]] = None,
    device=None,
) -> Tuple[List[np.ndarray], List[Region]]:
    """Cut an audio file (or a waveform at ``sr``) into ASR-sized chunks:
    (wave segments, (start, end) boundaries in seconds), the reference's
    contract (``gigaam/vad_utils.py:80-136``).  ``device`` is where a
    discovered neural detector runs (None: the card)."""
    audio = (wav_file if isinstance(wav_file, np.ndarray)
             else load_audio(wav_file, sr))
    detector = speech_regions_fn
    if detector is None:
        neural = _discover_neural_vad(device)
        if neural is not None and sr != SAMPLE_RATE:
            # the net is trained at 16 kHz: detect on a resampled copy; the
            # regions are in seconds, so the slicing stays at ``sr``
            detector = (lambda w: neural(resample(w, sr, SAMPLE_RATE)))
        else:
            detector = neural
    if detector is None:
        detector = (lambda w: energy_speech_regions(w, sr))
    regions = detector(audio)
    chunks = merge_regions_into_chunks(
        regions, len(audio) / sr,
        max_duration=max_duration, min_duration=min_duration,
        strict_limit_duration=strict_limit_duration,
        new_chunk_threshold=new_chunk_threshold)
    segments = [audio[int(s * sr): int(e * sr)] for s, e in chunks]
    return segments, chunks
