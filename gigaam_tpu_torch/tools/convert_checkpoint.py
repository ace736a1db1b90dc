"""Convert a reference GigaAM torch ``.ckpt`` into a ``save_model``
artifact pair (``<out>.npz`` + ``<out>.json``), which ``load_model`` of
either package reads.

Usage:
  python -m gigaam_tpu_torch.tools.convert_checkpoint /path/to/v3_ctc.ckpt \\
      --out ~/.cache/gigaam_tpu/v3_ctc [--model-name v3_ctc] \\
      [--tokenizer /path/to/tokenizer.model]

A SentencePiece model (v1_rnnt, the e2e models) is copied beside the
artifact.  The conversion runs on the CPU.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt", help="reference .ckpt path")
    ap.add_argument("--out", required=True, help="output artifact base path")
    ap.add_argument("--model-name", default=None)
    ap.add_argument("--tokenizer", default=None,
                    help="sentencepiece .model path (v1_rnnt / e2e models)")
    args = ap.parse_args(argv)

    from ..checkpoint import convert_reference_checkpoint
    from ..models.model import model_class_for
    from ..weights import params_from_jax, save_model

    t0 = time.perf_counter()
    cfg, tree = convert_reference_checkpoint(args.ckpt, args.model_name)
    if args.tokenizer and cfg.decoding is not None:
        cfg.decoding.model_path = args.tokenizer
    model = model_class_for(cfg)(cfg, state=params_from_jax(tree),
                                 device="cpu")
    save_model(model, args.out)
    print(f"Converted {args.ckpt} -> {args.out}.npz / {args.out}.json in "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"  model_class={cfg.model_class} encoder="
          f"{cfg.encoder.n_layers}x{cfg.encoder.d_model} "
          f"attention={cfg.encoder.self_attention_model} "
          f"subsampling={cfg.encoder.subsampling}")


if __name__ == "__main__":
    main()
