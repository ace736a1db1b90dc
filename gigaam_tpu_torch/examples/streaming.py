"""Streaming (incremental) transcription walkthrough of the port (port of
``examples/streaming.py``).

Pushes a waveform in 0.5 s chunks as a live microphone would: committed
text is stable (never retracted), the partial tail updates as audio
arrives.  Runs offline with a model of random weights.  Over HTTP: POST
chunked s16le PCM to the server's ``/transcribe_stream``
(``client.transcribe_stream``).

Usage:
  python -m gigaam_tpu_torch.examples.streaming [--device cpu] [--full]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from ..config import SAMPLE_RATE
from ..streaming import stream_file
from .common import example_model


def main(argv: Optional[List[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the card")
    ap.add_argument("--full", action="store_true",
                    help="the full-width v3_ctc (for the card)")
    ap.add_argument("--seconds", type=float, default=12.0)
    args = ap.parse_args(argv)

    model = example_model("v3_ctc", args.device, args.full)
    rng = np.random.default_rng(0)
    t = np.arange(int(args.seconds * SAMPLE_RATE)) / SAMPLE_RATE
    wav = (0.3 * np.sin(2 * np.pi * 300 * t)
           + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    events = []
    for ev in stream_file(model, wav, chunk_s=0.5, window_s=20.0,
                          stride_s=2.0):
        tag = "FINAL " if ev.kind == "committed" else "      "
        print(f"{tag}[{ev.kind}] {ev.text!r}")
        events.append(ev)
    return events


if __name__ == "__main__":
    main()
