"""WER / edit-distance metrics, dependency-free (copy of
``gigaam_tpu/metrics.py``, kept so the port never imports the JAX package).

Replaces the reference's C++ ``editdistance`` package
(``train_utils/module.py:5,185``, ``train_utils/utils.py:9,25-48``) — this
is eval-time host work, a pure-Python Levenshtein is plenty.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance between two sequences."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def wer_counts(hyps: List[str], refs: List[str]) -> Tuple[int, int]:
    """(total word errors, total reference words); words = max(len, 1)
    per sample as in the reference (``module.py:178-187``).  Uses the
    native C++ edit distance when built (``native/native.cpp``)."""
    from . import native

    if len(hyps) != len(refs):
        raise ValueError(
            f"hyps/refs length mismatch: {len(hyps)} vs {len(refs)} — "
            "a silent zip-truncation here would report a wrong WER")
    errors = words = 0
    for hyp, ref in zip(hyps, refs):
        rw, hw = ref.split(), hyp.split()
        errors += native.levenshtein_seqs(rw, hw)
        words += max(len(rw), 1)
    return errors, words


def wer(hyps: List[str], refs: List[str]) -> float:
    errors, words = wer_counts(hyps, refs)
    return errors / max(words, 1)


def normalize_raw_text(text: str) -> str:
    """Cyrillic-only lowercase normalization for the raw-WER metric
    (``train_utils/utils.py:17-22``)."""
    text = text.lower().replace("ё", "е")
    allowed = set(" абвгдежзийклмнопрстуфхцчшщъыьэюя")
    return " ".join("".join(c for c in text if c in allowed).split())


def compute_wer(hyps: List[str], refs: List[str]) -> Tuple[float, float]:
    """(e2e WER on verbatim text, WER on normalized Cyrillic-only text)
    — the dual metric of ``train_utils/utils.py:25-48``."""
    e2e = wer(hyps, refs)
    raw = wer([normalize_raw_text(h) for h in hyps],
              [normalize_raw_text(r) for r in refs])
    return e2e, raw
