"""Token-level n-gram language model for shallow fusion (a copy of
``gigaam_tpu/decode/lm.py``, numpy only: the port imports nothing of the
JAX package).  The reference decodes purely acoustically
(``gigaam/decoding.py``).

* The LM trains on the host from transcriptions and is deployed two ways,
  one per beam decoder:

  - **host scoring** (`logp`) for the CTC prefix beam, which runs on host
    numpy over the device posteriors (``decode/ctc_beam.py``);
  - a **dense [C, V] log-prob table** (`dense_table`) or a **sparse
    counted-contexts table** (`sparse_table`) for the RNNT beam on the
    card (``decode/rnnt_beam.py::lm_device_table``): the context is one
    packed integer (shift-in base ``V+1``), and a lookup is a row gather.

* Smoothing is interpolated Witten-Bell: parameter-free, well-behaved on
  the small corpora a fine-tuning manifest provides, and exactly
  reproducible between the host scorer and the tables.

Storage is a flat npz of packed (context, token, count) arrays per order,
with the same keys and format tag as the JAX package's, so that an LM saved
by either package loads in the other.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# Dense-table size guard: (V+1)^(order-1) rows of V floats.  64M elements
# (256 MB fp32) comfortably covers char 4-grams and SP bigrams; an SP
# trigram (513^2 x 512 = 539 MB) must stay host-side instead.
_MAX_DENSE_ELEMS = 1 << 26


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


class NGramLM:
    """Interpolated Witten–Bell backoff n-gram LM over token ids.

    ``order`` counts the full n-gram (3 = trigram).  Contexts at sequence
    start are padded with a BOS symbol (id ``vocab_size``) so that e.g. the
    first real token is scored by p(w | BOS, BOS) under a trigram.
    """

    def __init__(self, vocab_size: int, order: int = 3):
        if order < 1:
            raise ValueError("order must be >= 1")
        self.vocab_size = int(vocab_size)
        self.order = int(order)
        self.bos = self.vocab_size  # context-only symbol
        # per context length k (0..order-1):
        #   _counts[k]: {packed_ctx: {token: count}}
        self._counts: List[Dict[int, Dict[int, int]]] = [
            {} for _ in range(order)]
        self._logp_cache: Dict[Tuple[int, int], float] = {}
        # bumped on every mutation so table caches (e.g. the model's
        # on-device dense table) can detect staleness
        self.version = 0

    # -- context packing ---------------------------------------------------
    # base = V+1 (tokens + BOS); most recent token in the LOW digit:
    # ctx_id = c[-1] + c[-2]*base + c[-3]*base^2 ...

    @property
    def _base(self) -> int:
        return self.vocab_size + 1

    def pack_context(self, context: Sequence[int]) -> int:
        """Pack the last ``order-1`` tokens (BOS-padded) into one int."""
        k = self.order - 1
        ctx = list(context)[-k:] if k else []
        while len(ctx) < k:
            ctx.insert(0, self.bos)
        out = 0
        for c in ctx:
            out = out * self._base + int(c)
        return out

    def shift_context(self, packed: int, token: int) -> int:
        """packed ctx + newly emitted token -> next packed ctx."""
        k = self.order - 1
        if k == 0:
            return 0
        return (packed % (self._base ** (k - 1))) * self._base + int(token)

    # -- training ----------------------------------------------------------

    def add_sequence(self, tokens: Sequence[int]) -> None:
        toks = [int(t) for t in tokens]
        if any(t < 0 or t >= self.vocab_size for t in toks):
            raise ValueError("token id out of range for this LM's vocab")
        self._logp_cache.clear()
        self.version += 1
        for i, w in enumerate(toks):
            for k in range(self.order):
                ctx = toks[max(0, i - k):i]
                while len(ctx) < k:
                    ctx.insert(0, self.bos)
                packed = 0
                for c in ctx:
                    packed = packed * self._base + c
                by_tok = self._counts[k].setdefault(packed, {})
                by_tok[w] = by_tok.get(w, 0) + 1

    @classmethod
    def train(cls, token_seqs: Iterable[Sequence[int]], vocab_size: int,
              order: int = 3) -> "NGramLM":
        lm = cls(vocab_size, order)
        for seq in token_seqs:
            if len(seq):
                lm.add_sequence(seq)
        return lm

    # -- scoring -----------------------------------------------------------

    def _prob(self, token: int, packed_ctx: int, k: int) -> float:
        """Interpolated WB probability p(token | ctx of length k)."""
        if k == 0:
            by_tok = self._counts[0].get(0, {})
            total = sum(by_tok.values())
            distinct = len(by_tok)
            uniform = 1.0 / self.vocab_size
            if total == 0:
                return uniform
            lam = total / (total + distinct)
            return (lam * by_tok.get(token, 0) / total
                    + (1.0 - lam) * uniform)
        by_tok = self._counts[k].get(packed_ctx, {})
        total = sum(by_tok.values())
        distinct = len(by_tok)
        shorter = packed_ctx % (self._base ** (k - 1)) if k > 1 else 0
        backoff = self._prob(token, shorter, k - 1)
        if total == 0:
            return backoff
        lam = total / (total + distinct)
        return lam * by_tok.get(token, 0) / total + (1.0 - lam) * backoff

    def logp(self, token: int, context: Sequence[int]) -> float:
        """log p(token | last order-1 tokens of ``context``)."""
        packed = self.pack_context(context)
        return self.logp_packed(token, packed)

    def logp_packed(self, token: int, packed_ctx: int) -> float:
        key = (packed_ctx, int(token))
        hit = self._logp_cache.get(key)
        if hit is None:
            hit = float(np.log(self._prob(int(token), packed_ctx,
                                          self.order - 1)))
            self._logp_cache[key] = hit
        return hit

    def num_counted_ngrams(self) -> int:
        """Total distinct (context, token) pairs counted across orders."""
        return sum(sum(len(v) for v in level.values())
                   for level in self._counts)

    def score_sequence(self, tokens: Sequence[int]) -> float:
        """Sum log p over a sequence (BOS-padded start)."""
        total = 0.0
        ctx = self.pack_context([])
        for t in tokens:
            total += self.logp_packed(int(t), ctx)
            ctx = self.shift_context(ctx, int(t))
        return total

    # -- dense device table --------------------------------------------------

    def dense_table(self) -> np.ndarray:
        """[ (V+1)^(order-1), V ] fp32 log-prob table for on-device fusion.

        Row index is the packed context id (`pack_context`/`shift_context`
        arithmetic); unreachable contexts (those never counted) fall back
        through WB interpolation exactly like the host scorer, so table
        lookups equal ``logp`` for every (ctx, token).
        """
        k = self.order - 1
        rows = self._base ** k
        if rows * self.vocab_size > _MAX_DENSE_ELEMS:
            raise ValueError(
                f"dense table would need {rows}x{self.vocab_size} entries; "
                f"use a lower order (or a smaller vocab) for on-device "
                f"fusion")
        table = np.empty((rows, self.vocab_size), np.float32)
        uniform = np.full(self.vocab_size, 1.0 / self.vocab_size, np.float64)
        by_tok0 = self._counts[0].get(0, {})
        total0 = sum(by_tok0.values())
        if total0 == 0:
            base_row = uniform
        else:
            lam = total0 / (total0 + len(by_tok0))
            cnt = np.zeros(self.vocab_size, np.float64)
            for t, c in by_tok0.items():
                cnt[t] = c
            base_row = lam * cnt / total0 + (1.0 - lam) * uniform
        # Counted contexts get their interpolated row; uncounted contexts
        # back off recursively (pure WB: p == backoff when total==0).  The
        # cache makes this linear in distinct counted contexts.
        fill_cache: Dict[Tuple[int, int], np.ndarray] = {}

        def row(packed: int, kk: int) -> np.ndarray:
            if kk == 0:
                return base_row
            key = (packed, kk)
            hit = fill_cache.get(key)
            if hit is not None:
                return hit
            by_tok = self._counts[kk].get(packed)
            shorter = packed % (self._base ** (kk - 1)) if kk > 1 else 0
            back = row(shorter, kk - 1)
            if not by_tok:
                out = back
            else:
                total = sum(by_tok.values())
                lam = total / (total + len(by_tok))
                cnt = np.zeros(self.vocab_size, np.float64)
                for t, c in by_tok.items():
                    cnt[t] = c
                out = lam * cnt / total + (1.0 - lam) * back
            fill_cache[key] = out
            return out

        for packed in range(rows):
            table[packed] = np.log(row(packed, k))
        return table

    # -- sparse device table -------------------------------------------------

    def sparse_table(self) -> Dict[str, Any]:
        """Counted-contexts-only device table — lifts the dense guard so SP
        vocabs (V~512) get trigram+ fusion on the device.

        Witten–Bell backoff has the property that an *uncounted* context's
        distribution equals its backoff exactly (``_prob``: total==0 ->
        backoff), so p(t | ctx) is always the fully-interpolated row of the
        LONGEST COUNTED SUFFIX of ctx.  Storage is therefore one [V] row
        per counted context per level:

          row0            [V]        log p(t) (unigram WB row)
          levels[kk-1] =  (ctx_ids [n_kk] sorted int32 packed suffixes,
                           rows    [n_kk, V] fp32 log interpolated rows)

        Device lookup (``decode/rnnt_beam.py``): for each level ascending,
        ``searchsorted`` the packed suffix (packed % base^kk) and take the
        row of the deepest hit — O(order) gathers per expansion, no
        (V+1)^(order-1) materialization.  Context packing/shift arithmetic
        is unchanged from the dense path.
        """
        k = self.order - 1
        if float(self._base) ** k >= 2 ** 31:
            raise ValueError(
                f"packed context ids for order {self.order} over vocab "
                f"{self.vocab_size} exceed int32; use a lower order")
        uniform = np.full(self.vocab_size, 1.0 / self.vocab_size, np.float64)
        by_tok0 = self._counts[0].get(0, {})
        total0 = sum(by_tok0.values())
        if total0 == 0:
            base_row = uniform
        else:
            lam = total0 / (total0 + len(by_tok0))
            cnt = np.zeros(self.vocab_size, np.float64)
            for t, c in by_tok0.items():
                cnt[t] = c
            base_row = lam * cnt / total0 + (1.0 - lam) * uniform

        row_cache: Dict[Tuple[int, int], np.ndarray] = {}

        def row(packed: int, kk: int) -> np.ndarray:
            if kk == 0:
                return base_row
            key = (packed, kk)
            hit = row_cache.get(key)
            if hit is not None:
                return hit
            by_tok = self._counts[kk].get(packed)
            shorter = packed % (self._base ** (kk - 1)) if kk > 1 else 0
            back = row(shorter, kk - 1)
            if not by_tok:
                out = back
            else:
                total = sum(by_tok.values())
                lam = total / (total + len(by_tok))
                cnt = np.zeros(self.vocab_size, np.float64)
                for t, c in by_tok.items():
                    cnt[t] = c
                out = lam * cnt / total + (1.0 - lam) * back
            row_cache[key] = out
            return out

        levels = []
        for kk in range(1, k + 1):
            ids = np.fromiter(sorted(self._counts[kk].keys()), np.int64,
                              len(self._counts[kk]))
            rows = np.empty((len(ids), self.vocab_size), np.float32)
            for i, packed in enumerate(ids):
                rows[i] = np.log(row(int(packed), kk))
            levels.append((ids.astype(np.int32), rows))
        return {"row0": np.log(base_row).astype(np.float32),
                "levels": tuple(levels)}

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        arrays = {}
        meta = dict(vocab_size=self.vocab_size, order=self.order,
                    format="gigaam_tpu_ngram_v1")
        for k in range(self.order):
            ctxs, toks, cnts = [], [], []
            for packed, by_tok in sorted(self._counts[k].items()):
                for t, c in sorted(by_tok.items()):
                    ctxs.append(packed)
                    toks.append(t)
                    cnts.append(c)
            arrays[f"ctx_{k}"] = np.asarray(ctxs, np.int64)
            arrays[f"tok_{k}"] = np.asarray(toks, np.int32)
            arrays[f"cnt_{k}"] = np.asarray(cnts, np.int64)
        arrays["meta"] = np.frombuffer(
            json.dumps(meta).encode("utf-8"), np.uint8)
        # np.savez_compressed appends ".npz" when absent; normalize so
        # save(p) and load(p) always agree on the on-disk name.
        np.savez_compressed(_npz_path(path), **arrays)

    @classmethod
    def load(cls, path: str) -> "NGramLM":
        with np.load(_npz_path(path)) as z:
            meta = json.loads(bytes(z["meta"]).decode("utf-8"))
            if meta.get("format") != "gigaam_tpu_ngram_v1":
                raise ValueError(f"{path} is not a gigaam_tpu n-gram LM")
            lm = cls(meta["vocab_size"], meta["order"])
            for k in range(lm.order):
                ctxs = z[f"ctx_{k}"]
                toks = z[f"tok_{k}"]
                cnts = z[f"cnt_{k}"]
                level: Dict[int, Dict[int, int]] = {}
                for packed, t, c in zip(ctxs, toks, cnts):
                    level.setdefault(int(packed), {})[int(t)] = int(c)
                lm._counts[k] = level
        return lm


def train_lm_from_texts(texts: Iterable[str], tokenizer,
                        order: int = 3) -> NGramLM:
    """Train an LM over a tokenizer's id space from transcription strings."""
    seqs = []
    for text in texts:
        ids = tokenizer.encode(text)
        if ids:
            seqs.append(ids)
    if not seqs:
        raise ValueError("no trainable text (all lines empty after "
                         "tokenization)")
    return NGramLM.train(seqs, vocab_size=len(tokenizer), order=order)
