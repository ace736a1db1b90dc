"""Token-frame -> word-level timestamps (reference
``gigaam/timestamps_utils.py``). Pure host-side text logic; a copy of
``gigaam_tpu/decode/timestamps.py``."""

from __future__ import annotations

import math
from typing import List, Optional

from ..config import SAMPLE_RATE
from ..types import Word
from .tokenizer import Tokenizer

_WORD_BOUNDARY = "▁"


def compute_frame_shift(audio_length_samples: int, seq_len: int) -> float:
    """Seconds per encoder frame (``timestamps_utils.py:8-10``).

    ``seq_len`` can be 0 for near-empty audio (fewer samples than one
    frontend hop); no tokens exist then either, so any finite shift works.
    """
    if seq_len <= 0:
        return 0.0
    return audio_length_samples / SAMPLE_RATE / seq_len


def frames_to_words(
    tokenizer: Tokenizer,
    token_ids: List[int],
    token_frames: List[int],
    frame_shift: float,
    token_logps: Optional[List[float]] = None,
) -> List[Word]:
    """Group tokens into words at '▁' prefixes or spaces; word span =
    [first_frame, last_frame + 1] x shift (``timestamps_utils.py:13-53``).

    ``token_logps`` (optional, aligned with ``token_ids``): per-token
    decoder log-probs; when given, each Word carries
    ``confidence = exp(mean logp)`` of its tokens (extension over the
    reference, which has no confidence surface).
    """
    words: List[Word] = []
    current_chars: List[str] = []
    current_frames: List[int] = []
    current_logps: List[float] = []

    def commit() -> None:
        if not current_chars:
            return
        text = "".join(current_chars).strip()
        if not text:
            current_chars.clear()
            current_frames.clear()
            current_logps.clear()
            return
        start = current_frames[0] * frame_shift
        end = (current_frames[-1] + 1) * frame_shift
        conf = (math.exp(sum(current_logps) / len(current_logps))
                if current_logps else None)
        words.append(Word(text=text, start=start, end=end, confidence=conf))
        current_chars.clear()
        current_frames.clear()
        current_logps.clear()

    lps = token_logps if token_logps is not None else [None] * len(token_ids)
    for token_id, frame, lp in zip(token_ids, token_frames, lps):
        char = tokenizer.id_to_str(token_id)
        if not char:  # control/unused piece: decode drops it from the text
            continue
        if char.startswith(_WORD_BOUNDARY):
            commit()
            char = char[1:]
        elif char == " ":
            commit()
            continue
        current_chars.append(char)
        current_frames.append(frame)
        if lp is not None:
            current_logps.append(float(lp))

    commit()
    return words
