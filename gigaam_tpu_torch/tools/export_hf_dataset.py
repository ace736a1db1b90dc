"""Export a HuggingFace audio dataset to WAVs and a TSV manifest (port of
``tools/export_hf_dataset.py``, the mirror of the reference's ToneBooks
exporter, ``train_utils/utils.py:80-113``): 16 kHz mono WAVs and the
``path\\tduration\\ttranscription`` manifest that ``data.AudioDataset``
reads, its paths relative to the manifest.

Needs the ``datasets`` package (imported only by ``main``).

Usage:
  python -m gigaam_tpu_torch.tools.export_hf_dataset \\
      --dataset voxblink/ToneBooks --split train --audio-column audio \\
      --text-column text --out data/tonebooks
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np


def export_dataset(ds, out: str, audio_column: str = "audio",
                   text_column: str = "text", workers: int = 8,
                   limit: int = 0) -> str:
    """Write a dataset's rows as WAVs and a manifest; returns the manifest's
    path.  ``ds`` is anything indexable with ``__len__`` whose rows map
    column names to values, the audio column holding ``{"array": ...}`` at
    16 kHz (the shape of a ``datasets`` split cast to ``Audio``)."""
    from ..audio import save_wav
    from ..config import SAMPLE_RATE
    from ..data import write_manifest

    os.makedirs(os.path.join(out, "wavs"), exist_ok=True)
    n = min(limit, len(ds)) if limit else len(ds)

    def export(i):
        row = ds[i]
        wav = np.asarray(row[audio_column]["array"], dtype=np.float32)
        rel = os.path.join("wavs", f"{i:07d}.wav")
        save_wav(os.path.join(out, rel), wav)
        return (rel, len(wav) / SAMPLE_RATE, str(row[text_column]))

    with ThreadPoolExecutor(max_workers=workers) as ex:
        rows = list(ex.map(export, range(n)))
    manifest = os.path.join(out, "manifest.tsv")
    write_manifest(manifest, rows)
    hours = sum(r[1] for r in rows) / 3600
    print(f"exported {len(rows)} samples ({hours:.2f} h) -> {manifest}")
    return manifest


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--config", default=None)
    ap.add_argument("--split", default="train")
    ap.add_argument("--audio-column", default="audio")
    ap.add_argument("--text-column", default="text")
    ap.add_argument("--out", required=True)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--limit", type=int, default=0)
    args = ap.parse_args(argv)
    try:
        from datasets import Audio, load_dataset
    except ImportError:
        raise SystemExit("the 'datasets' package is required")

    from ..config import SAMPLE_RATE

    ds = load_dataset(args.dataset, args.config, split=args.split)
    ds = ds.cast_column(args.audio_column, Audio(sampling_rate=SAMPLE_RATE))
    export_dataset(ds, args.out, args.audio_column, args.text_column,
                   args.workers, args.limit)


if __name__ == "__main__":
    main()
