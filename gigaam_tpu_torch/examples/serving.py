"""Serving walkthrough of the port: the dynamic-batching HTTP server and
its client (port of ``examples/serving.py``).

Runs offline with a model of random weights; ``python -m
gigaam_tpu_torch.serve --model_name v3_ctc`` serves a real model from the
CLI.

Usage:
  python -m gigaam_tpu_torch.examples.serving [--device cpu] [--full] \\
      [--out serving_data]
"""

from __future__ import annotations

import argparse
import os
import threading
from typing import List, Optional

import numpy as np

from ..audio import save_wav
from ..client import health, transcribe_files
from ..config import SAMPLE_RATE
from ..serve import ASRHTTPServer, BatchingASRServer, make_handler
from .common import example_model


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the card")
    ap.add_argument("--full", action="store_true",
                    help="the full-width v3_ctc (for the card)")
    ap.add_argument("--out", default="serving_data")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(0)
    # one short clip and one longform clip (the client routes each)
    t = np.arange(SAMPLE_RATE * 2) / SAMPLE_RATE
    short = os.path.join(args.out, "short.wav")
    save_wav(short, (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32))
    n = SAMPLE_RATE * 9
    burst = (0.3 * np.sin(2 * np.pi * 300 * np.arange(n) / SAMPLE_RATE)
             + 0.02 * rng.standard_normal(n)).astype(np.float32)
    long = os.path.join(args.out, "long.wav")
    save_wav(long, np.concatenate([burst, np.zeros(SAMPLE_RATE,
                                                   np.float32)] * 3))

    model = example_model("v3_ctc", args.device, args.full)
    server = BatchingASRServer(model, max_batch=8)
    server.warmup([5])
    httpd = ASRHTTPServer(("127.0.0.1", 0), make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    try:
        print("server:", health(url))
        results = transcribe_files(url, [short, long], timestamps=True)
        print("short:", results[0])
        print("long segments:", len(results[1]["segments"]))
    finally:
        httpd.shutdown()
        server.shutdown()
    print("done")
    return {"short": results[0], "long": results[1]}


if __name__ == "__main__":
    main()
