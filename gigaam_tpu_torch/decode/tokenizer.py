"""Char-wise tokenizer (``gigaam/decoding.py:10-44``).

A copy of the char-wise half of ``gigaam_tpu/decode/tokenizer.py``; the
SentencePiece models (v1_rnnt, e2e) are not in this slice of the port.
"""

from __future__ import annotations

from typing import List, Optional


class Tokenizer:
    """Char-wise tokenizer: id ``i`` is ``vocab[i]``; the blank is
    ``len(vocab)`` and never reaches ``decode``."""

    def __init__(self, vocab: List[str], model_path: Optional[str] = None):
        if model_path is not None:
            raise NotImplementedError(
                "SentencePiece tokenizers are not ported yet; only the "
                "char-wise vocabularies (v1/v2/v3 ctc) are supported")
        self.charwise = True
        self.vocab = vocab
        self._c2i = {c: i for i, c in enumerate(vocab)}

    def encode(self, text: str) -> List[int]:
        """Characters outside the vocabulary are dropped."""
        return [self._c2i[c] for c in text if c in self._c2i]

    def decode(self, tokens: List[int]) -> str:
        return "".join(self.vocab[t] for t in tokens)

    def __len__(self) -> int:
        return len(self.vocab)

    def id_to_str(self, token_id: int) -> str:
        return self.vocab[token_id]
