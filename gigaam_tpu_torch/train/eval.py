"""Evaluation CLI (port of ``gigaam_tpu/train/eval.py``, the mirror of the
reference ``train_utils/eval.py``).

Batch-decodes a manifest greedily, writes ``preds.jsonl``, reports dual WER:
e2e (verbatim) + raw (normalized Cyrillic-only), matching
``train_utils/utils.py:25-48``.  Beam search and LM fusion are not ported.

Usage:
  python -m gigaam_tpu_torch.train.eval --model_name <artifact> \\
      --manifest test.tsv [--batch_size 16] [--out preds.jsonl]
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(
        description="GigaAM evaluation (PyTorch/CUDA)")
    p.add_argument("--model_name", required=True,
                   help="native artifact, or a preset name with "
                        "--init random")
    p.add_argument("--init", choices=["weights", "random"], default="weights")
    p.add_argument("--device", default=None,
                   help="torch device; default: the card")
    p.add_argument("--manifest", required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--out", default="preds.jsonl")
    p.add_argument("--max_duration", type=float, default=None)
    args = p.parse_args(argv)

    import gigaam_tpu_torch
    from gigaam_tpu_torch.data import AudioDataset, prefetch_batches
    from gigaam_tpu_torch.metrics import compute_wer
    from gigaam_tpu_torch.models.model import GigaAMASR

    model = gigaam_tpu_torch.load_model(args.model_name, device=args.device,
                                        init=args.init)
    assert isinstance(model, GigaAMASR), "ASR model required"

    ds = AudioDataset(args.manifest, tokenizer=model.tokenizer,
                      max_duration=args.max_duration, return_tokens=False)

    hyps: List[str] = []
    for wavs_pad, lens in prefetch_batches(
            ds.batches(args.batch_size, sort_by_duration=False)):
        wav_list = [wavs_pad[i, : lens[i]] for i in range(len(lens))]
        hyps.extend(text for text, _ in model._decode_batch(
            wav_list, word_timestamps=False))
    refs = [s.text or "" for s in ds.samples]

    with open(args.out, "w") as f:
        for i, (h, r) in enumerate(zip(hyps, refs)):
            f.write(json.dumps(
                {"id": i, "prediction": h, "reference": r},
                ensure_ascii=False) + "\n")

    wer_e2e, wer_raw = compute_wer(hyps, refs)
    with open(args.out + ".summary.json", "w") as f:
        json.dump({"samples": len(hyps), "wer_e2e": wer_e2e,
                   "wer_raw": wer_raw}, f)
    print(f"samples: {len(hyps)}")
    print(f"WER (e2e):  {100 * wer_e2e:.2f}%")
    print(f"WER (raw):  {100 * wer_raw:.2f}%")
    print(f"predictions written to {args.out}")


if __name__ == "__main__":
    main()
