"""ctypes loader for the native host kernels (see ``native.cpp``).

A copy of ``gigaam_tpu/native`` trimmed to what the port's audio path uses
(``s16_to_f32``, ``s16_interleaved_to_mono``, ``collate``,
``resample_poly``) and what its WER metric uses (``levenshtein_seqs``).  Builds ``_native.so`` with g++ on first use if missing;
every entry point has a pure-numpy fallback, so the package works without a
compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_DIR = os.path.dirname(__file__)
_SO = os.path.join(_DIR, "_native.so")
_SRC = os.path.join(_DIR, "native.cpp")

_lib: Optional[ctypes.CDLL] = None
_load_failed = False  # one attempt per process: no g++ respawn per call
_load_lock = threading.Lock()


def _build() -> bool:
    # compile to a pid-unique temp and rename into place, so concurrent
    # builds never interleave linker writes into the final path
    tmp = f"{_SO}.build.{os.getpid()}"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    if _lib is not None or _load_failed:
        return _lib
    with _load_lock:
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    stale = (not os.path.exists(_SO)
             or os.path.getmtime(_SRC) > os.path.getmtime(_SO))
    if stale and not _build():
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        _load_failed = True
        return None
    lib.s16_to_f32.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64]
    lib.s16_interleaved_to_mono_f32.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int32]
    lib.resample_poly_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.collate_f32.argtypes = [
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.levenshtein_i32.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
    lib.levenshtein_i32.restype = ctypes.c_int64
    _lib = lib
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def s16_to_f32(pcm: np.ndarray) -> np.ndarray:
    """int16 PCM -> float32 [-1, 1)."""
    lib = _load()
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    if lib is None:
        return pcm.astype(np.float32) / 32768.0
    out = np.empty(pcm.shape, dtype=np.float32)
    lib.s16_to_f32(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), _fptr(out),
        pcm.size)
    return out


def s16_interleaved_to_mono(pcm: np.ndarray, channels: int) -> np.ndarray:
    """Interleaved multi-channel int16 -> mono float32 [-1, 1)."""
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    frames = pcm.size // channels
    lib = _load()
    if lib is None:
        return (pcm[: frames * channels].reshape(-1, channels)
                .astype(np.float32).mean(axis=1) / 32768.0).astype(np.float32)
    out = np.empty(frames, dtype=np.float32)
    lib.s16_interleaved_to_mono_f32(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), _fptr(out),
        frames, channels)
    return out


def collate(rows: Sequence[np.ndarray], max_len: int) -> np.ndarray:
    """Zero-pad variable-length float32 rows into a dense [B, max_len]."""
    rows = [np.ascontiguousarray(r, dtype=np.float32) for r in rows]
    lib = _load()
    if lib is None:
        out = np.zeros((len(rows), max_len), dtype=np.float32)
        for i, r in enumerate(rows):
            out[i, : min(len(r), max_len)] = r[:max_len]
        return out
    out = np.empty((len(rows), max_len), dtype=np.float32)
    ptrs = (ctypes.POINTER(ctypes.c_float) * len(rows))(
        *[_fptr(r) for r in rows])
    lens = np.asarray([len(r) for r in rows], dtype=np.int64)
    lib.collate_f32(ptrs, lens.ctypes.data_as(
        ctypes.POINTER(ctypes.c_int64)), len(rows), _fptr(out), max_len)
    return out


def resample_poly(x: np.ndarray, up: int, down: int,
                  taps: np.ndarray, offset: int = 0,
                  n_out: Optional[int] = None) -> np.ndarray:
    """Polyphase FIR resample (native upfirdn core)."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    taps = np.ascontiguousarray(taps, dtype=np.float32)
    if n_out is None:
        n_out = int(np.ceil(len(x) * up / down))
    if lib is None:
        from scipy.signal import upfirdn

        # left-pad the taps so the requested phase lands on the down-grid
        # (the native kernel evaluates at m*down + offset exactly)
        pad = (-offset) % down
        full = upfirdn(np.pad(taps * up, (pad, 0)), x, up, down)
        start = (offset + pad) // down
        return full[start:start + n_out].astype(np.float32)
    out = np.empty(n_out, dtype=np.float32)
    lib.resample_poly_f32(_fptr(x), len(x), _fptr(out), n_out,
                          _fptr(taps), len(taps), up, down, offset)
    return out


def levenshtein_ids(a: Sequence[int], b: Sequence[int]) -> int:
    lib = _load()
    aa = np.asarray(list(a), dtype=np.int32)
    bb = np.asarray(list(b), dtype=np.int32)
    if lib is None:
        from ..metrics import levenshtein as py_lev

        return py_lev(aa.tolist(), bb.tolist())
    return int(lib.levenshtein_i32(
        aa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), aa.size,
        bb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), bb.size))


def levenshtein_seqs(a: Sequence, b: Sequence) -> int:
    """Edit distance over arbitrary hashable items (e.g. words)."""
    ids = {}
    enc = [[], []]
    for out, seq in zip(enc, (a, b)):
        for item in seq:
            out.append(ids.setdefault(item, len(ids)))
    return levenshtein_ids(enc[0], enc[1])
