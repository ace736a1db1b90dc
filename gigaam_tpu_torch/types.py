"""Public result types + their JSON wire format (copy of
``gigaam_tpu/types.py``, kept so the port never imports the JAX package).

Covers the same API surface as the reference's result dataclasses
(``gigaam/types.py:8-68``) — ``Word``, ``TranscriptionResult``, ``Segment``,
``LongformTranscriptionResult``, ``AudioDatasetSample`` — and additionally
owns the JSON serialization contract used by the HTTP server
(``gigaam_tpu/serve.py``) and client (``gigaam_tpu/client.py``), so the wire
shape is defined exactly once.

Wire conventions: times are seconds rounded to milliseconds; ``words`` is
omitted (not null) when timestamps were not requested.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

_TIME_DECIMALS = 3  # wire times are milliseconds-precision seconds


def _t(seconds: float) -> float:
    return round(float(seconds), _TIME_DECIMALS)


@dataclass
class AudioDatasetSample:
    """One manifest entry: a path or a raw waveform, with optional labels."""

    item: Any                   # path str or np.ndarray waveform
    duration: float
    text: Optional[str] = None
    tokens: Optional[List[int]] = None


@dataclass
class Word:
    """A recognized word with its time span in seconds.

    ``confidence`` (extension over the reference's schema,
    ``gigaam/types.py:8-13``): exp of the mean per-token *acoustic*
    decoder log-prob of this word, in (0, 1] — populated by every live
    decode path (greedy CTC/RNNT, CTC prefix beam, RNNT device beam);
    ``None`` where unavailable (artifact-only inference).  The wire
    format omits the key when None, so existing consumers are unaffected.

    The underlying quantity differs per decode path, so confidences are
    comparable *within* one decode mode but not across modes (do not apply
    one threshold to mixed-decoder output):

    * RNNT (greedy/beam): pre-fusion joint log-prob of each emitted token;
    * CTC greedy: frame posterior of the token at its argmax frame;
    * CTC prefix beam: posterior of the token at its first-creation frame
      (can understate confidence — the beam's sum-over-alignments mass is
      not decomposed per token).
    """

    text: str
    start: float
    end: float
    confidence: Optional[float] = None

    @property
    def duration(self) -> float:
        return self.end - self.start

    def shifted(self, offset: float) -> "Word":
        """A copy moved by ``offset`` seconds (segment -> absolute time)."""
        return Word(text=self.text,
                    start=_t(self.start + offset),
                    end=_t(self.end + offset),
                    confidence=self.confidence)

    def to_dict(self) -> Dict[str, Any]:
        out = {"word": self.text, "start": _t(self.start),
               "end": _t(self.end)}
        if self.confidence is not None:
            out["confidence"] = round(float(self.confidence), 4)
        return out

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Word":
        conf = d.get("confidence")
        return Word(text=d["word"], start=float(d["start"]),
                    end=float(d["end"]),
                    confidence=None if conf is None else float(conf))


def _words_to_json(words: Optional[List[Word]]) -> List[Dict[str, Any]]:
    return [w.to_dict() for w in (words or [])]


def _words_from_json(items: Optional[List[Dict[str, Any]]]) -> Optional[List[Word]]:
    if items is None:
        return None
    return [Word.from_dict(d) for d in items]


@dataclass
class TranscriptionResult:
    """Shortform result: full text plus optional word timestamps."""

    text: str
    words: Optional[List[Word]] = None

    def __str__(self) -> str:
        return self.text

    @property
    def confidence(self) -> Optional[float]:
        """Mean word confidence, or None when words/confidences are absent."""
        if not self.words:
            return None
        vals = [w.confidence for w in self.words if w.confidence is not None]
        return sum(vals) / len(vals) if vals else None

    def to_dict(self, *, timestamps: Optional[bool] = None) -> Dict[str, Any]:
        """JSON body of ``POST /transcribe``.

        ``timestamps=None`` includes words iff they exist; an explicit bool
        forces them in (empty list if absent) or out.
        """
        out: Dict[str, Any] = {"text": self.text}
        include = (self.words is not None) if timestamps is None else timestamps
        if include:
            out["words"] = _words_to_json(self.words)
        return out

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TranscriptionResult":
        return TranscriptionResult(
            text=d["text"], words=_words_from_json(d.get("words")))


@dataclass
class Segment:
    """One VAD chunk of a longform result, in absolute (file) time."""

    text: str
    start: float
    end: float
    words: Optional[List[Word]] = None

    @property
    def duration(self) -> float:
        return self.end - self.start

    @property
    def confidence(self) -> Optional[float]:
        """Mean word confidence, or None when words/confidences are absent."""
        if not self.words:
            return None
        vals = [w.confidence for w in self.words if w.confidence is not None]
        return sum(vals) / len(vals) if vals else None

    def to_dict(self, *, timestamps: Optional[bool] = None) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "start": _t(self.start), "end": _t(self.end), "text": self.text}
        include = (self.words is not None) if timestamps is None else timestamps
        if include:
            out["words"] = _words_to_json(self.words)
        return out

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Segment":
        return Segment(text=d["text"], start=float(d["start"]),
                       end=float(d["end"]),
                       words=_words_from_json(d.get("words")))


@dataclass
class LongformTranscriptionResult:
    """Longform result: an ordered sequence of segments.

    Behaves like a sequence of ``Segment`` and stringifies to the joined
    text, matching the reference API (``gigaam/types.py:42-68``).
    """

    segments: List[Segment] = field(default_factory=list)

    # -- aggregate views ----------------------------------------------------
    @property
    def text(self) -> str:
        return " ".join(s.text for s in self.segments)

    @property
    def words(self) -> List[Word]:
        """All words across segments, in order (absolute times)."""
        return [w for s in self.segments for w in (s.words or [])]

    @property
    def has_word_timestamps(self) -> bool:
        return bool(self.segments) and self.segments[0].words is not None

    @property
    def duration(self) -> float:
        """Total speech time covered by segments (gaps excluded)."""
        return sum(s.duration for s in self.segments)

    # -- sequence protocol --------------------------------------------------
    def __str__(self) -> str:
        return self.text

    def __iter__(self) -> Iterator[Segment]:
        return iter(self.segments)

    def __len__(self) -> int:
        return len(self.segments)

    def __getitem__(self, i):
        return self.segments[i]

    # -- wire format --------------------------------------------------------
    def to_dict(self, *, timestamps: Optional[bool] = None) -> Dict[str, Any]:
        """JSON body of ``POST /transcribe_longform``."""
        return {
            "text": self.text,
            "segments": [s.to_dict(timestamps=timestamps)
                         for s in self.segments],
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "LongformTranscriptionResult":
        return LongformTranscriptionResult(
            segments=[Segment.from_dict(s) for s in d.get("segments", [])])
