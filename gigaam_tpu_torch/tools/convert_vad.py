"""Convert a pyannote segmentation checkpoint (PyanNet) into a VAD
artifact pair (``<out>.npz`` + ``<out>.json``), which ``models.vad_net``
of either package reads.

Usage:
  python -m gigaam_tpu_torch.tools.convert_vad /path/to/pytorch_model.bin \\
      [--out ~/.cache/gigaam_tpu/vad_segmentation]

The default output is where ``transcribe_longform`` looks for a neural VAD,
which then becomes its default detector:

  fn = gigaam_tpu_torch.models.vad_net.load_vad_regions_fn(out)
  model.transcribe_longform("podcast.wav", speech_regions_fn=fn)

The sinc filterbank is baked into FIR taps (exactly, when
asteroid-filterbanks is installed).  The conversion runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt", help="pyannote PyanNet checkpoint "
                                 "(pytorch_model.bin / Lightning ckpt)")
    ap.add_argument(
        "--out",
        default=os.path.expanduser("~/.cache/gigaam_tpu/vad_segmentation"),
        help="output artifact base path (default: the location "
             "transcribe_longform finds by itself)")
    args = ap.parse_args(argv)

    from ..checkpoint import convert_pyannote_vad
    from ..models.vad_net import PyanNet, save_vad
    from ..weights import vad_params_from_jax

    cfg, tree = convert_pyannote_vad(args.ckpt)
    save_vad(args.out, PyanNet(cfg, vad_params_from_jax(tree)))
    print(f"Converted {args.ckpt} -> {args.out}.npz / {args.out}.json")
    print(f"  sinc_filters={cfg.sinc_filters} lstm={cfg.lstm_layers}x"
          f"{cfg.lstm_hidden} classes={cfg.n_classes}")


if __name__ == "__main__":
    main()
