"""What the examples share: a model, full-width or a 2-layer, 64-wide
one that runs on the CPU too, with random weights from a seed."""

from __future__ import annotations

from typing import Optional

from .. import load_model, make_preset
from ..models.model import GigaAM, model_class_for


def example_model(name: str, device: Optional[str], full: bool) -> GigaAM:
    """``name``'s preset with random weights: at full width (the card's
    size), or cut to 2 layers of width 64 (4 heads) with a kernel of 7."""
    if full:
        return load_model(name, device=device, init="random", seed=0)
    cfg = make_preset(name)
    cfg.encoder.n_layers = 2
    cfg.encoder.d_model = 64
    cfg.encoder.n_heads = 4
    cfg.encoder.ff_expansion_factor = 2
    cfg.encoder.conv_kernel_size = 7
    cfg.encoder.pos_emb_max_len = 512
    if cfg.head is not None:
        cfg.head.feat_in = 64
    return model_class_for(cfg)(cfg, seed=0, device=device)
