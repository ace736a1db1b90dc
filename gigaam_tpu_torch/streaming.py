"""Streaming (incremental) ASR on top of the offline GigaAM models (port of
``gigaam_tpu/streaming.py``).

The reference has NO streaming story (``gigaam/model.py`` is file-in,
text-out); this module adds one WITHOUT retraining: the shipped models are
full-context Conformers, so instead of a causal encoder we run **buffered
re-decoding with LocalAgreement commits** — the policy used by
whisper-streaming (Polák et al., "Turning Whisper into Real-Time
Transcription System", IJCNLP-AACL 2023 demo) and NeMo's buffered CTC
inference:

* audio accumulates in a rolling buffer (bounded by ``window_s``);
* every ``stride_s`` of new audio the whole buffer is re-decoded: ONE
  fixed-bucket forward through the model's ``_decode_batch`` (on the card,
  the encoder's attention on K2 at batch 1, or K1 when the server batches
  the strides; ``PERF.md`` holds the stride latency), so re-decoding stays
  far below real time;
* words that appear identically in two consecutive decodes (and end
  before the unstable right edge) are COMMITTED — LocalAgreement-2;
  committed text never changes again, giving the caller a stable prefix
  plus a live partial tail;
* once committed text clears ``trim_s``, the buffer drops audio up to the
  last committed word boundary (the Conformer re-hears a bounded past, so
  per-stride cost stays constant for unbounded streams).

The buffer is padded to coarse duration buckets (``bucket_s``), so a
stream meets a handful of shapes; padded frames are masked, and a flush
decodes the exact remaining buffer, making short-stream output equal to
offline ``transcribe``.

Latency/quality knobs: ``stride_s`` bounds commit latency (a word commits
~2 strides + margin after it is spoken); ``right_margin_s`` trades
latency for stability at the buffer edge.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .config import SAMPLE_RATE
from .models.model import GigaAMASR
from .types import Word


@dataclasses.dataclass
class StreamEvent:
    """One streaming output increment.

    ``kind`` is ``"committed"`` (stable, never retracted) or ``"partial"``
    (the current unstable tail; superseded by the next event batch).
    Times are absolute seconds from stream start.
    """

    kind: str
    text: str
    words: List[Word]

    def to_dict(self) -> dict:
        return {"kind": self.kind, "text": self.text,
                "words": [w.to_dict() for w in self.words]}


def _common_prefix(a: Sequence[Word], b: Sequence[Word],
                   tol: float = 0.2) -> int:
    """Length of the agreeing word prefix (same text, times within tol)."""
    n = 0
    for wa, wb in zip(a, b):
        if wa.text != wb.text or abs(wa.start - wb.start) > tol:
            break
        n += 1
    return n


class StreamingTranscriber:
    """Incremental transcription for one audio stream.

    Usage::

        st = StreamingTranscriber(model)
        for chunk in microphone():          # float32 @ 16 kHz, any length
            for ev in st.push(chunk):
                print(ev.kind, ev.text)
        final = st.flush()                  # TranscriptionResult-like text

    ``push`` returns events as soon as enough new audio arrived (>= one
    stride); ``flush`` decodes the remaining buffer and commits everything.
    """

    def __init__(
        self,
        model: GigaAMASR,
        window_s: float = 20.0,
        stride_s: float = 2.0,
        right_margin_s: float = 1.0,
        trim_s: float = 12.0,
        beam_size: int = 1,
        bucket_s: float = 5.0,
        decode_fn=None,
    ):
        assert window_s > trim_s > 0 and stride_s > 0
        self.model = model
        # pluggable decode: the HTTP server passes a fn that routes buffer
        # decodes through its dynamic-batching queue, so concurrent streams'
        # strides batch together (and with shortform traffic) instead of
        # each issuing single-row forwards.  Contract: wav -> List[Word]
        # with times relative to the wav start.
        self._decode_fn = decode_fn
        # coarse duration buckets bound the set of shapes to
        # window_s/bucket_s per stream (positional tables, the RNNT loop's
        # CUDA graphs); padding is masked so results are bucket-invariant
        # (pinned by the serving tests)
        self.bucket = int(bucket_s * SAMPLE_RATE)
        self.window = int(window_s * SAMPLE_RATE)
        self.stride = int(stride_s * SAMPLE_RATE)
        self.right_margin = right_margin_s
        self.trim = int(trim_s * SAMPLE_RATE)
        self.beam_size = beam_size
        # rolling state: buffer starts at absolute sample `base`
        self._buf = np.zeros(0, np.float32)
        self._base = 0           # absolute sample index of buf[0]
        self._since_decode = 0   # new samples since the last decode
        self._prev: Optional[List[Word]] = None  # last decode (absolute t)
        self.committed: List[Word] = []
        self._closed = False

    # -- internals ----------------------------------------------------------

    def _decode_buffer(self) -> List[Word]:
        """One fixed-bucket decode of the current buffer -> absolute words."""
        if not len(self._buf):
            return []
        if self._decode_fn is not None:
            words = self._decode_fn(self._buf)
        else:
            words = self.model._decode_batch(
                [self._buf], word_timestamps=True, beam_size=self.beam_size,
                bucket=self.bucket)[0][1]
        off = self._base / SAMPLE_RATE
        return [w.shifted(off) for w in words or []]

    def _commit(self, words: List[Word], edge_s: float) -> List[Word]:
        """LocalAgreement-2: commit the prefix agreeing with the previous
        decode, clear of the unstable right edge and of already-committed
        words."""
        if self._prev is None:
            self._prev = words
            return []
        n = _common_prefix(self._prev, words)
        self._prev = words
        # hold back the final agreed word: a word at the hypothesis edge can
        # still EXTEND as audio arrives ("г" growing into "гдг" keeps the
        # same start, so start-based agreement alone would commit the stub);
        # only words with an agreed successor have an established boundary.
        # max(0, ...): with zero agreement a bare n-1 = -1 would slice
        # words[:-1] and commit nearly the whole DISAGREEING hypothesis
        n = max(0, n - 1)
        done_until = self.committed[-1].end if self.committed else -1.0
        # midpoint rule: word times re-derive from a shifted buffer each
        # decode, so exact >= comparisons on rounded starts would drop (or
        # double) boundary words; a word belongs after the committed edge
        # iff most of it lies there
        fresh = [w for w in words[:n]
                 if (w.start + w.end) / 2 > done_until and w.end <= edge_s]
        self.committed.extend(fresh)
        return fresh

    def _maybe_trim(self) -> None:
        """Drop audio the committed transcript has fully cleared."""
        if not self.committed or len(self._buf) <= self.trim:
            return
        cut_abs = int(self.committed[-1].end * SAMPLE_RATE)
        cut = cut_abs - self._base
        if cut <= 0:
            return
        self._buf = self._buf[cut:]
        self._base = cut_abs
        # previous hypothesis referenced audio that no longer exists in the
        # buffer; agreement restarts after a trim
        self._prev = None

    # -- public API -----------------------------------------------------------

    def push(self, chunk: np.ndarray) -> List[StreamEvent]:
        """Feed audio; returns zero or more events (committed + partial)."""
        assert not self._closed, "stream already flushed"
        chunk = np.asarray(chunk, np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, chunk])
        self._since_decode += len(chunk)
        # hard bound on EVERY push (not just at decode time): the buffer —
        # and with it per-decode cost — must never exceed one window even
        # when nothing commits (e.g. music) or pushes outpace strides
        if len(self._buf) > self.window:
            drop = len(self._buf) - self.window
            self._buf = self._buf[drop:]
            self._base += drop
            self._prev = None
        events: List[StreamEvent] = []
        # ONE decode per distinct buffer content: looping stride-by-stride
        # inside a single push would re-decode the identical buffer, and
        # identical decodes agree vacuously — LocalAgreement's stability
        # signal only means something across decodes of different audio
        if self._since_decode >= self.stride:
            self._since_decode %= self.stride
            words = self._decode_buffer()
            edge = (self._base + len(self._buf)) / SAMPLE_RATE \
                - self.right_margin
            fresh = self._commit(words, edge)
            if fresh:
                events.append(StreamEvent(
                    "committed", " ".join(w.text for w in fresh), fresh))
            done = self.committed[-1].end if self.committed else -1.0
            tail = [w for w in words if (w.start + w.end) / 2 > done]
            events.append(StreamEvent(
                "partial", " ".join(w.text for w in tail), tail))
            self._maybe_trim()
        return events

    def flush(self) -> StreamEvent:
        """Final decode: commits everything left and closes the stream.

        For streams shorter than ``window_s`` with no trims, the full
        committed text equals offline ``transcribe`` exactly (same padded
        bucket, same shapes)."""
        assert not self._closed, "stream already flushed"
        self._closed = True
        words = self._decode_buffer()
        done_until = self.committed[-1].end if self.committed else -1.0
        fresh = [w for w in words if (w.start + w.end) / 2 > done_until]
        self.committed.extend(fresh)
        return StreamEvent(
            "committed", " ".join(w.text for w in fresh), fresh)

    @property
    def text(self) -> str:
        """Full committed transcript so far."""
        return " ".join(w.text for w in self.committed)


def stream_file(
    model: GigaAMASR,
    wav: np.ndarray,
    chunk_s: float = 0.5,
    **kw,
) -> Iterator[StreamEvent]:
    """Simulate real-time streaming over an in-memory waveform (demo/test
    helper): yields events as the audio is pushed chunk by chunk, then the
    flush event."""
    st = StreamingTranscriber(model, **kw)
    step = int(chunk_s * SAMPLE_RATE)
    for i in range(0, len(wav), step):
        for ev in st.push(wav[i: i + step]):
            yield ev
    yield st.flush()
