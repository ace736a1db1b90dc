"""Quickstart walkthrough of the port (the reference's
``colab_example.ipynb``; port of ``examples/quickstart.py``).

Runs offline: a model with random weights from a seed, synthetic WAVs, and
the API end to end: ``transcribe`` with word timestamps, forced alignment,
``transcribe_longform``, ``save_model``/``load_model``, a few fine-tuning
steps through the train CLI.  Swap the random model for a converted
artifact (``tools.convert_checkpoint``) or a model name for real text.

Usage:
  python -m gigaam_tpu_torch.examples.quickstart [--device cpu] [--full] \\
      [--out quickstart_data]

On the card by default (``--device cpu`` runs it here); ``--full`` takes
the full-width v3_ctc instead of a 2-layer, 64-wide one.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from ..audio import save_wav
from ..config import SAMPLE_RATE
from ..data import write_manifest
from .common import example_model


def make_audio(out: str) -> None:
    """A 3 s tone with noise, 4 x (8 s tone + 1 s silence), a manifest."""
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(0)
    t = np.arange(SAMPLE_RATE * 3) / SAMPLE_RATE
    save_wav(os.path.join(out, "short.wav"),
             (0.3 * np.sin(2 * np.pi * 440 * t)
              + 0.03 * rng.standard_normal(len(t))).astype(np.float32))
    tt = np.arange(SAMPLE_RATE * 8) / SAMPLE_RATE
    pieces = []
    for i in range(4):
        pieces += [(0.3 * np.sin(2 * np.pi * (300 + 40 * i) * tt)
                    ).astype(np.float32), np.zeros(SAMPLE_RATE, np.float32)]
    save_wav(os.path.join(out, "long.wav"), np.concatenate(pieces))
    write_manifest(os.path.join(out, "manifest.tsv"),
                   [(os.path.abspath(os.path.join(out, "short.wav")), 3.0,
                     "привет мир")])


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the card")
    ap.add_argument("--full", action="store_true",
                    help="the full-width v3_ctc (for the card)")
    ap.add_argument("--out", default="quickstart_data")
    args = ap.parse_args(argv)

    from .. import load_model
    from ..train.train import main as train_main
    from ..weights import save_model

    out = args.out
    make_audio(out)
    short = os.path.join(out, "short.wav")
    model = example_model("v3_ctc", args.device, args.full)
    print(f"== {model.cfg.model_name} on {model.device} (random weights)")

    print("== shortform transcribe + word timestamps")
    res = model.transcribe(short, word_timestamps=True)
    print("  text:", repr(res.text))
    for w in (res.words or [])[:3]:
        print(f"  word {w.text!r}  [{w.start:.2f}, {w.end:.2f}]"
              f"  conf {w.confidence:.2f}")
    if res.text.strip():
        print("== forced alignment of a known transcript")
        for w in (model.align(short, res.text).words or [])[:3]:
            print(f"  word {w.text!r}  [{w.start:.2f}, {w.end:.2f}]")

    print("== longform (VAD segmentation + batched decode)")
    for seg in model.transcribe_longform(os.path.join(out, "long.wav")):
        print(f"  [{seg.start:5.1f}-{seg.end:5.1f}] {seg.text[:40]!r}")

    print("== save / load a native artifact")
    save_model(model, os.path.join(out, "model"))
    again = load_model(os.path.join(out, "model"), device=args.device)
    assert again.transcribe(short).text == res.text
    print("  round trip OK")

    print("== a few fine-tuning steps (the train CLI)")
    manifest = os.path.join(out, "manifest.tsv")
    train_main(["--model_name", os.path.join(out, "model"),
                "--train_manifest", manifest, "--val_manifest", manifest,
                "--batch_size", "1", "--max_steps", "2",
                "--save_dir", os.path.join(out, "exp"),
                "--log_every_n_steps", "1"]
               + (["--device", args.device, "--precision", "fp32"]
                  if args.device == "cpu" else []))
    print("done: artifacts in", out)


if __name__ == "__main__":
    main()
