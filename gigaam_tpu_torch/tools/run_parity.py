"""The port's evidence bundle on the reference weights (port of
``tools/run_parity.py``; needs the network for the downloads and disk for
the checkpoints).

One run, one machine-readable ``PARITY_RESULTS.json``:

  1. the reference's example audio;
  2. the reference checkpoints downloaded (md5-pinned) and converted to
     ``save_model`` artifacts by ``load_model``, each loaded through the
     port, the ASR models transcribing the example clip;
  3. streaming against offline on the trained v3_ctc weights: the
     word error rate of ``stream_file``'s committed text against
     ``transcribe_longform``'s on the long example (LocalAgreement-2
     commits stable prefixes; above 0.15 the policy is broken);
  4. with ``--manifest``, the eval CLI's WER per model beside the
     reference's published averages.

Usage:
  python -m gigaam_tpu_torch.tools.run_parity              # 4 models
  python -m gigaam_tpu_torch.tools.run_parity --models all
  python -m gigaam_tpu_torch.tools.run_parity --manifest test.tsv

The models run on the card unless ``--device cpu`` is given.  Exit code 0
when everything that ran matched; nonzero on a failed download,
conversion, threshold or WER regression.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

# the reference's CI subset (tests/test_loading.py:82-86)
PARTIAL = ["emo", "v2_ssl", "v3_ctc", "v3_e2e_rnnt"]
ALL = ["emo", "v1_ctc", "v1_rnnt", "v1_ssl", "v2_ctc", "v2_rnnt", "v2_ssl",
       "v3_ctc", "v3_rnnt", "v3_e2e_ctc", "v3_e2e_rnnt", "v3_ssl"]
# the reference's WER averages over its 10 Russian test sets
# (evaluation.md:18), in percent
REF_WER = {"v3_ctc": 9.1, "v3_rnnt": 8.3, "v3_e2e_ctc": 12.0,
           "v3_e2e_rnnt": 11.2, "v2_ctc": 11.1, "v2_rnnt": 10.6,
           "v1_ctc": 14.2, "v1_rnnt": 13.8}
AUDIO = ("example.wav", "long_example.wav")
STREAMING_MAX_WER = 0.15


def streaming_vs_offline(model, wav) -> float:
    """WER of the streamed transcript against the offline one."""
    from ..metrics import wer
    from ..streaming import stream_file

    offline = " ".join(s.text for s in model.transcribe_longform(wav))
    streamed = " ".join(ev.text for ev in stream_file(model, wav)
                        if ev.kind == "committed" and ev.text)
    return wer([streamed], [offline])


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--models", default=",".join(PARTIAL),
                    help="comma list or 'all'")
    ap.add_argument("--root", default=os.path.expanduser(
        "~/.cache/gigaam_tpu"), help="download and conversion cache")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the card")
    ap.add_argument("--manifest", default=None,
                    help="TSV manifest (path\\tduration\\ttext) for WER")
    ap.add_argument("--wer_tolerance", type=float, default=0.5,
                    help="allowed WER regression (percentage points) against "
                         "the reference's published averages")
    ap.add_argument("--skip_streaming", action="store_true")
    ap.add_argument("--out", default="PARITY_RESULTS.json")
    args = ap.parse_args(argv)

    import gigaam_tpu_torch as gt
    from ..audio import load_audio
    from ..models.model import GigaAMASR

    models = ALL if args.models == "all" else args.models.split(",")
    os.makedirs(args.root, exist_ok=True)
    failures: List[str] = []
    results: Dict = {"device": args.device or "cuda", "models": {},
                     "sections": {}}

    def fail(what: str, exc) -> str:
        failures.append(f"{what}: {exc}")
        print(f"[{what}] FAILED ({exc})")
        return f"FAILED: {exc}"

    audio = {}
    for name in AUDIO:
        try:
            audio[name] = gt._download_file(f"{gt._URL_DIR}/{name}",
                                            os.path.join(args.root, name))
        except Exception as e:  # noqa: BLE001 - recorded in the bundle
            fail(f"audio {name}", e)

    loaded = {}
    for name in models:
        try:
            model = gt.load_model(name, device=args.device,
                                  download_root=args.root)
            row = {"status": "converted"}
            if isinstance(model, GigaAMASR) and "example.wav" in audio:
                row["text"] = model.transcribe(audio["example.wav"]).text
            results["models"][name] = row
            loaded[name] = model
            print(f"[model] {name}: {row}")
        except Exception as e:  # noqa: BLE001
            results["models"][name] = {"status": fail(f"model {name}", e)}

    if (not args.skip_streaming and "v3_ctc" in loaded
            and "long_example.wav" in audio):
        try:
            score = streaming_vs_offline(
                loaded["v3_ctc"], load_audio(audio["long_example.wav"]))
            ok = score <= STREAMING_MAX_WER
            if not ok:
                failures.append(f"streaming-vs-offline WER {score:.3f}")
            results["sections"]["streaming_wer"] = {
                "status": "ok" if ok else "FAILED",
                "streaming_vs_offline_wer": score}
        except Exception as e:  # noqa: BLE001
            results["sections"]["streaming_wer"] = {
                "status": fail("streaming wer", e)}

    if args.manifest:
        from ..train.eval import main as eval_main

        rows = {}
        for name in models:
            if name not in loaded or not isinstance(loaded[name], GigaAMASR):
                continue
            out = os.path.join(args.root, f"preds_{name}.jsonl")
            try:
                # the artifact load_model converted into the cache
                eval_main(["--model_name", os.path.join(args.root, name),
                           "--manifest", args.manifest, "--out", out]
                          + (["--device", args.device] if args.device
                             else []))
                with open(out + ".summary.json") as f:
                    score = 100.0 * json.load(f)["wer_e2e"]
            except Exception as e:  # noqa: BLE001
                fail(f"eval {name}", e)
                continue
            ref = REF_WER.get(name)
            rows[name] = {"wer": round(score, 2), "ref": ref,
                          "delta": None if ref is None
                          else round(score - ref, 2)}
            if ref is not None and score - ref > args.wer_tolerance:
                failures.append(f"WER regression {name}: {score:.1f} vs "
                                f"ref {ref:.1f}")
            print(f"[wer] {name}: {rows[name]}")
        results["sections"]["wer_table"] = rows

    results["pass"] = not failures
    results["failures"] = failures
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2, ensure_ascii=False)
    print(f"[bundle] wrote {args.out}: "
          f"{'FAIL' if failures else 'PASS'}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
