"""Dataset + batching for training and batched inference (copy of
``gigaam_tpu/data.py``, kept so the port never imports the JAX package).

Torch-free re-design of the reference ``AudioDataset``
(``gigaam/utils.py:180-392``): same manifest format (TSV with
``path\\tduration\\ttranscription``), duration filtering with a stats
printout, text normalization and pre-tokenization — but batch assembly is
shape-aware: batches are zero-padded to *bucketed* lengths (1 s audio buckets,
fixed token buckets), as the JAX package pads them, so both see the same
batches, and an optional length-sorted batching mode minimizes padding waste.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from .audio import load_audio
from .config import SAMPLE_RATE
from .types import AudioDatasetSample

Item = Union[str, np.ndarray]


def normalize_text(text: str, vocab: Optional[Sequence[str]],
                   raw_text: bool) -> str:
    """Reference normalization (``gigaam/utils.py:228-239``): applied only in
    raw-text mode — ё->е, whitespace squeeze, lowercase, vocab filter."""
    if not raw_text:
        return text
    text = text.replace("ё", "е").replace("Ё", "Е")
    text = " ".join(text.split())
    if vocab:
        vset = set(vocab)
        return "".join(c for c in text.lower() if c in vset)
    return text.lower()


class AudioDataset:
    """Manifest- or iterable-backed dataset of (waveform, tokens) samples."""

    def __init__(
        self,
        data: Union[str, Iterable[Item]],
        tokenizer=None,
        max_duration: Optional[float] = None,
        min_duration: float = 0.0,
        raw_text: bool = False,
        return_tokens: bool = False,
    ):
        if return_tokens and tokenizer is None:
            raise ValueError("tokenizer is required when return_tokens=True")
        self.tokenizer = tokenizer
        self.raw_text = raw_text
        self.return_tokens = return_tokens
        self.samples: List[AudioDatasetSample] = []

        if isinstance(data, str):
            self._load_manifest(data, min_duration, max_duration)
        elif isinstance(data, Iterable):
            self._load_iterable(data, min_duration, max_duration)
        else:
            raise TypeError(f"Unsupported data type: {type(data)}")
        if not self.samples:
            raise ValueError("No valid samples found after filtering")

    # -- construction ------------------------------------------------------

    def _vocab(self) -> Optional[Sequence[str]]:
        return getattr(self.tokenizer, "vocab", None) if (
            self.tokenizer is not None
            and getattr(self.tokenizer, "charwise", False)) else None

    def _add(self, item: Item, duration: float,
             text: Optional[str] = None) -> None:
        norm = tokens = None
        if text is not None:
            norm = normalize_text(text.strip(), self._vocab(), self.raw_text)
            if self.return_tokens:
                tokens = self.tokenizer.encode(norm)
        self.samples.append(AudioDatasetSample(
            item=item, duration=duration, text=norm, tokens=tokens))

    @staticmethod
    def _duration_of(item: Item) -> float:
        if isinstance(item, str):
            import wave

            try:
                with wave.open(item, "rb") as wf:
                    return wf.getnframes() / wf.getframerate()
            except Exception:
                # non-PCM WAV or another container (mp3/flac/...):
                # load_audio handles those via its ffmpeg fallback — decode
                # once for the duration (the header-only probe is just an
                # optimization for the common PCM-WAV case)
                from .audio import load_audio

                return len(load_audio(item)) / SAMPLE_RATE
        return len(np.asarray(item)) / SAMPLE_RATE

    def _load_manifest(self, manifest_path: str, min_d: float,
                       max_d: Optional[float]) -> None:
        data_dir = Path(manifest_path).resolve().parent
        n_total = n_filt = 0
        dur_total = dur_filt = 0.0
        with open(manifest_path) as f:
            for row in csv.DictReader(f, delimiter="\t"):
                duration = float(row["duration"])
                n_total += 1
                dur_total += duration
                if duration < min_d or (max_d is not None and duration > max_d):
                    n_filt += 1
                    dur_filt += duration
                    continue
                p = Path(row["path"])
                path = str((p if p.is_absolute() else data_dir / p).resolve())
                self._add(path, duration, row.get("transcription"))
        self._report(n_total, dur_total, n_filt, dur_filt)

    def _load_iterable(self, data: Iterable[Item], min_d: float,
                       max_d: Optional[float]) -> None:
        n_total = n_filt = 0
        dur_total = dur_filt = 0.0
        for item in data:
            if not isinstance(item, (str, np.ndarray)):
                item = np.asarray(item)
            duration = self._duration_of(item)
            n_total += 1
            dur_total += duration
            if duration < min_d or (max_d is not None and duration > max_d):
                n_filt += 1
                dur_filt += duration
                continue
            self._add(item, duration)
        self._report(n_total, dur_total, n_filt, dur_filt)

    @staticmethod
    def _report(n_total: int, dur_total: float, n_filt: int,
                dur_filt: float) -> None:
        if n_total == 0 or n_filt == 0:
            return
        pn = 100.0 * n_filt / n_total
        pd = 100.0 * dur_filt / dur_total if dur_total > 0 else 0.0
        print(f"filtered by duration: {n_filt}/{n_total} samples ({pn:.1f}%), "
              f"{dur_filt / 3600:.2f}/{dur_total / 3600:.2f} h ({pd:.1f}%)")

    # -- access ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.samples)

    def load_wav(self, idx: int) -> np.ndarray:
        item = self.samples[idx].item
        if isinstance(item, str):
            return load_audio(item)
        return np.asarray(item, dtype=np.float32)

    # -- batching ----------------------------------------------------------

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        sort_by_duration: bool = False,
        audio_bucket: int = SAMPLE_RATE,
        token_bucket: int = 16,
        drop_last: bool = False,
    ) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield zero-padded batches with bucketed static shapes.

        Returns (wavs [B, L], wav_lens [B]) or
        (wavs, wav_lens, tokens [B, U], tok_lens [B]) when return_tokens.
        """
        from .native import collate

        order = np.arange(len(self.samples))
        rng = np.random.default_rng(seed) if shuffle else None
        if sort_by_duration:
            order = order[np.argsort([s.duration for s in self.samples],
                                     kind="stable")]
            if shuffle and drop_last and len(order) % batch_size:
                # drop a random remainder: blocks are cut from the sorted
                # order, so skipping the ragged block would deterministically
                # exclude the same longest samples every epoch
                gone = rng.choice(len(order), size=len(order) % batch_size,
                                  replace=False)
                order = np.delete(order, gone)
        elif shuffle:
            rng.shuffle(order)
        # batches as index blocks: with sort_by_duration the blocks are cut
        # BEFORE any shuffle and iterated as units, so a ragged final block
        # can never misalign later batch boundaries and mix the longest
        # samples with the shortest
        n_b = (len(order) + batch_size - 1) // batch_size
        blocks = [order[i * batch_size:(i + 1) * batch_size]
                  for i in range(n_b)]
        if shuffle and sort_by_duration:
            rng.shuffle(blocks)  # keep within-batch length affinity

        for idx in blocks:
            if drop_last and len(idx) < batch_size:
                continue
            wavs = [self.load_wav(j) for j in idx]
            lens = np.array([len(w) for w in wavs], dtype=np.int32)
            max_len = int(np.ceil(max(1, lens.max()) / audio_bucket)
                          ) * audio_bucket
            batch = collate(wavs, max_len)
            if not self.return_tokens:
                yield batch, lens
                continue
            toks = [self.samples[j].tokens or [] for j in idx]
            tlens = np.array([len(t) for t in toks], dtype=np.int32)
            max_u = int(np.ceil(max(1, tlens.max()) / token_bucket)
                        ) * token_bucket
            tok_batch = np.zeros((len(idx), max_u), dtype=np.int32)
            for k, t in enumerate(toks):
                tok_batch[k, : len(t)] = t
            yield batch, lens, tok_batch, tlens


def prefetch_batches(it: Iterator, depth: int = 2) -> Iterator:
    """Run ``it`` in a background thread, keeping ``depth`` batches ready.

    The analogue of the reference's ``DataLoader(num_workers=...)``
    (``gigaam/utils.py`` dataset + Lightning loaders): wav reading and
    zero-pad collation overlap with the accelerator step instead of
    stalling it.  Preserves order; exceptions re-raise at the consumer.
    """
    import queue as _queue
    import threading

    q: "_queue.Queue" = _queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END = object()

    def _put(item) -> bool:
        # bounded put that gives up when the consumer went away — otherwise
        # an early `break` out of the consuming loop leaves this thread
        # blocked forever on the full queue, pinning `depth` batches and the
        # source iterator for the life of the process
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not _put(item):
                    return
            _put(_END)
        except BaseException as exc:  # propagate to the consuming thread
            _put(exc)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def write_manifest(path: str, rows: List[Tuple[str, float, str]]) -> None:
    """Write a TSV manifest (path, duration, transcription).

    csv-quoted with the same dialect ``_load_manifest``'s DictReader parses,
    so fields containing tabs, newlines, or quotes round-trip instead of
    shifting columns."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(["path", "duration", "transcription"])
        for p, d, t in rows:
            w.writerow([p, d, t])
