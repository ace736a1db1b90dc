"""Tokenizer: char-wise or SentencePiece, with no sentencepiece package
(a copy of ``gigaam_tpu/decode/tokenizer.py``).

The reference wraps the sentencepiece C++ library (``gigaam/decoding.py:10-44``).
Tokenization is host-side text work, off the hot path, so the ``.model``
protobuf is parsed directly (a varint walk over ModelProto field 1) and
unigram Viterbi encoding runs in pure Python.  Decode concatenates pieces
with '▁' -> space, as SentencePiece's decoder does for the ASR
vocabularies involved.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

_WORD_BOUNDARY = "▁"  # '▁'

# SentencePiece ModelProto.SentencePiece.Type values
_TYPE_NORMAL = 1
_TYPE_UNKNOWN = 2
_TYPE_CONTROL = 3
_TYPE_USER_DEFINED = 4
_TYPE_BYTE = 6
_TYPE_UNUSED = 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        ln, pos = _read_varint(buf, pos)
        pos += ln
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError(f"Unsupported wire type {wire_type}")
    return pos


def _parse_sentencepiece(buf: bytes) -> Tuple[str, float, int]:
    """Parse one ModelProto.SentencePiece message."""
    pos = 0
    piece, score, ptype = "", 0.0, _TYPE_NORMAL
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:      # piece
            ln, pos = _read_varint(buf, pos)
            piece = buf[pos:pos + ln].decode("utf-8")
            pos += ln
        elif field == 2 and wire == 5:    # score (float)
            score = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif field == 3 and wire == 0:    # type
            ptype, pos = _read_varint(buf, pos)
        else:
            pos = _skip_field(buf, pos, wire)
    return piece, score, ptype


def parse_sp_model(path: str) -> List[Tuple[str, float, int]]:
    """Parse a SentencePiece .model file -> [(piece, score, type), ...]."""
    with open(path, "rb") as f:
        buf = f.read()
    pieces: List[Tuple[str, float, int]] = []
    pos = 0
    try:
        while pos < len(buf):
            tag, pos = _read_varint(buf, pos)
            field, wire = tag >> 3, tag & 7
            if field == 1 and wire == 2:      # repeated pieces
                ln, pos = _read_varint(buf, pos)
                pieces.append(_parse_sentencepiece(buf[pos:pos + ln]))
                pos += ln
            else:
                pos = _skip_field(buf, pos, wire)
    except (IndexError, ValueError, UnicodeDecodeError, struct.error) as exc:
        # truncated/corrupt file: surface a diagnosable error instead of a
        # bare parser traceback
        raise ValueError(
            f"invalid sentencepiece model file {path!r} "
            f"(truncated or corrupt at byte {pos}): {exc}") from exc
    if not pieces:
        raise ValueError(
            f"invalid sentencepiece model file {path!r}: no pieces found")
    return pieces


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        out += bytes([b7 | (0x80 if n else 0)])
        if not n:
            return out


def write_sp_model(path: str, pieces: Sequence[Tuple[str, float, int]]
                   ) -> None:
    """Write a minimal SentencePiece ``.model`` that ``parse_sp_model``
    reads: ModelProto field 1 repeated, each {piece: 1, score: 2, type: 3}.
    For synthetic vocabularies (a model with random weights has no
    tokenizer file); the writer of ``tests/test_export_serve.py``."""
    blob = b""
    for piece, score, ptype in pieces:
        pb = piece.encode("utf-8")
        msg = (bytes([0x0A]) + _varint(len(pb)) + pb        # field 1, wire 2
               + bytes([0x15]) + struct.pack("<f", score)   # field 2, wire 5
               + bytes([0x18]) + _varint(ptype))            # field 3, wire 0
        blob += bytes([0x0A]) + _varint(len(msg)) + msg
    with open(path, "wb") as f:
        f.write(blob)


class SentencePieceModel:
    """Pure-Python unigram SentencePiece: id<->piece, decode, Viterbi encode."""

    def __init__(self, path: str):
        self.pieces = parse_sp_model(path)
        self.piece_to_id: Dict[str, int] = {
            p: i for i, (p, _, _) in enumerate(self.pieces)
        }
        self.unk_id = next(
            (i for i, (_, _, t) in enumerate(self.pieces) if t == _TYPE_UNKNOWN), 0
        )
        self.max_piece_len = max((len(p) for p, _, _ in self.pieces), default=1)
        # byte-fallback table: models trained with --byte_fallback carry 256
        # pieces '<0x00>'..'<0xFF>' (type BYTE); real sentencepiece then
        # replaces every unknown-character span with its UTF-8 byte pieces
        # instead of emitting unk (normalizer_spec escapes nothing else)
        self._byte_ids: Optional[List[int]] = None
        byte_ids = []
        for b in range(256):
            pid = self.piece_to_id.get(f"<0x{b:02X}>")
            if pid is None or self.pieces[pid][2] != _TYPE_BYTE:
                break
            byte_ids.append(pid)
        if len(byte_ids) == 256:
            self._byte_ids = byte_ids

    def __len__(self) -> int:
        return len(self.pieces)

    def id_to_piece(self, idx: int) -> str:
        return self.pieces[idx][0]

    def decode(self, ids: List[int]) -> str:
        """Mirror of real sentencepiece's ``DecodeIds``.

        Per-piece surface rules (sentencepiece_processor.cc
        ``DecodeSentencePiece``): the word-boundary symbol becomes a space
        *within normal pieces only* — byte-decoded content stays literal
        (a byte run encoding U+2581 must decode to the character, not a
        space); while the accumulated text is still empty, each normal
        piece drops ONE leading word-boundary (the library's ``is_bos_ws``
        prefix-consume, not a blanket lstrip).
        """
        out: List[str] = []
        pending_bytes = bytearray()     # consecutive byte pieces -> UTF-8
        bos = True                      # no visible text emitted yet

        def flush_bytes() -> None:
            nonlocal bos
            if pending_bytes:
                # real sentencepiece decodes byte-piece runs as UTF-8 with
                # U+FFFD replacement for invalid sequences
                out.append(pending_bytes.decode("utf-8", errors="replace"))
                pending_bytes.clear()
                bos = False

        for i in ids:
            piece, _, ptype = self.pieces[i]
            if ptype == _TYPE_BYTE:
                pending_bytes.append(int(piece[1:-1], 16))
                continue
            flush_bytes()
            if ptype in (_TYPE_CONTROL, _TYPE_UNUSED):
                continue
            if ptype == _TYPE_UNKNOWN:
                out.append(" ⁇ ")
                bos = False
                continue
            if bos and piece.startswith(_WORD_BOUNDARY):
                piece = piece[len(_WORD_BOUNDARY):]
            piece = piece.replace(_WORD_BOUNDARY, " ")
            if piece:
                bos = False
            out.append(piece)
        flush_bytes()
        return "".join(out)

    def encode(self, text: str) -> List[int]:
        """Unigram Viterbi segmentation (max sum of piece log-probs).

        Matches real sentencepiece's unigram encoder: single-character unk
        arcs carry ``min_score - 10`` (its ``kUnkPenalty``), and on models
        trained with ``--byte_fallback`` each unk span is re-emitted as its
        UTF-8 byte pieces instead of the unk id (the library's
        byte-fallback post-step).  Exactness is pinned for the JAX
        package's copy by the gated ``tests/test_sp_parity.py`` against the
        real library; ``tests/test_torch_tokenizer.py`` holds this copy to
        that one.
        """
        s = _WORD_BOUNDARY + text.replace(" ", _WORD_BOUNDARY)
        n = len(s)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        best[0] = 0.0
        unk_penalty = min((sc for _, sc, _ in self.pieces), default=0.0) - 10.0
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            for j in range(i + 1, min(n, i + self.max_piece_len) + 1):
                pid = self.piece_to_id.get(s[i:j])
                if pid is not None and self.pieces[pid][2] in (
                    _TYPE_NORMAL, _TYPE_USER_DEFINED
                ):
                    sc = best[i] + self.pieces[pid][1]
                    if sc > best[j]:
                        best[j] = sc
                        back[j] = (i, pid)
            # unknown fallback: single char as unk
            sc = best[i] + unk_penalty
            if sc > best[i + 1]:
                best[i + 1] = sc
                back[i + 1] = (i, self.unk_id)
        segments: List[Tuple[int, int, int]] = []   # (start, end, pid)
        pos = n
        while pos > 0:
            prev, pid = back[pos]
            segments.append((prev, pos, pid))
            pos = prev
        segments.reverse()
        ids: List[int] = []
        for start, end, pid in segments:
            if pid == self.unk_id and self._byte_ids is not None:
                for byte in s[start:end].encode("utf-8"):
                    ids.append(self._byte_ids[byte])
            else:
                ids.append(pid)
        return ids


class Tokenizer:
    """Char-wise or SentencePiece tokenizer (``gigaam/decoding.py:10-44``)."""

    def __init__(self, vocab: List[str], model_path: Optional[str] = None):
        self.charwise = model_path is None
        if self.charwise:
            self.vocab = vocab
            self._c2i = {c: i for i, c in enumerate(vocab)}
        else:
            self.model = SentencePieceModel(model_path)

    def decode(self, tokens: List[int]) -> str:
        if self.charwise:
            return "".join(self.vocab[t] for t in tokens)
        return self.model.decode(tokens)

    def encode(self, text: str) -> List[int]:
        if self.charwise:
            return [self._c2i[c] for c in text if c in self._c2i]
        return self.model.encode(text)

    def __len__(self) -> int:
        return len(self.vocab) if self.charwise else len(self.model)

    def id_to_str(self, token_id: int) -> str:
        """Display text for one token, consistent with ``decode``: control/
        unused pieces render as '' (decode skips them) and unknown as the
        same '⁇' glyph decode emits — raw pieces like '<s>'/'<unk>' must
        never leak into word timestamps when decode drops/rewrites them."""
        if self.charwise:
            return self.vocab[token_id]
        piece, _, ptype = self.model.pieces[token_id]
        if ptype in (_TYPE_CONTROL, _TYPE_UNUSED):
            return ""
        if ptype == _TYPE_UNKNOWN:
            return "⁇"
        return piece
