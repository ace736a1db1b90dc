"""Train an n-gram LM for shallow-fusion decoding from manifest text (port
of ``tools/train_lm.py``).

Usage:
  python -m gigaam_tpu_torch.tools.train_lm --manifest train.tsv \\
      --out lm.npz --order 3
  python -m gigaam_tpu_torch.tools.train_lm --text corpus.txt \\
      --sp_model tokenizer.model --out lm.npz --order 2

Then decode with it:
  model.transcribe(wav, beam_size=8, lm="lm.npz", lm_weight=0.5)
  python -m gigaam_tpu_torch.train.eval --model_name v3_ctc ... \\
      --beam_size 8 --lm lm.npz

The LM is an interpolated Witten-Bell n-gram over the model's token ids
(``decode/lm.py``), saved as the npz that either package loads.  The token
space must match the decoding model: by default the char-wise Russian
vocabulary (every model but the e2e ones and v1_rnnt); ``--sp_model`` for a
SentencePiece model, or ``--model`` to take the tokenizer of what
``load_model`` loads (on the CPU).
"""

from __future__ import annotations

import argparse
import csv
from typing import Iterator, List, Optional


def iter_texts(manifests: List[str], texts: List[str]) -> Iterator[str]:
    """The non-empty transcriptions of TSV manifests, then the non-empty
    lines of text files."""
    for path in manifests:
        with open(path, newline="") as f:
            reader = csv.DictReader(
                f, fieldnames=["path", "duration", "transcription"],
                delimiter="\t")
            for row in reader:
                text = (row.get("transcription") or "").strip()
                if text:
                    yield text
    for path in texts:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--manifest", action="append", default=[],
                    help="TSV manifest (path\\tduration\\ttranscription); "
                         "repeatable")
    ap.add_argument("--text", action="append", default=[],
                    help="plain text file, one sentence per line; repeatable")
    ap.add_argument("--out", required=True, help="output LM path (.npz)")
    ap.add_argument("--order", type=int, default=3,
                    help="n-gram order (3 = trigram)")
    ap.add_argument("--sp_model", default=None,
                    help="SentencePiece .model for e2e/v1_rnnt vocabularies")
    ap.add_argument("--model", default=None,
                    help="take the tokenizer of a model name, artifact or "
                         ".ckpt (downloads and converts as load_model does)")
    args = ap.parse_args(argv)
    if not args.manifest and not args.text:
        ap.error("need at least one --manifest or --text")

    from ..config import RU_VOCAB
    from ..data import normalize_text
    from ..decode.lm import train_lm_from_texts
    from ..decode.tokenizer import Tokenizer

    if args.model:
        from .. import load_model

        tokenizer = load_model(args.model, device="cpu").tokenizer
    elif args.sp_model:
        tokenizer = Tokenizer([], model_path=args.sp_model)
    else:
        tokenizer = Tokenizer(list(RU_VOCAB))
    vocab = tokenizer.vocab if tokenizer.charwise else None

    def texts() -> Iterator[str]:
        n = 0
        for text in iter_texts(args.manifest, args.text):
            n += 1
            yield normalize_text(text, vocab, raw_text=tokenizer.charwise)
        if n == 0:
            raise SystemExit("no text found in the given sources")

    lm = train_lm_from_texts(texts(), tokenizer, order=args.order)
    lm.save(args.out)
    print(f"saved order-{lm.order} LM over {lm.vocab_size} tokens "
          f"({lm.num_counted_ngrams()} counted n-grams) -> {args.out}")


if __name__ == "__main__":
    main()
