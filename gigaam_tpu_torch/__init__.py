"""GigaAM in PyTorch and CUDA: the port of ``gigaam_tpu`` to an NVIDIA
H100, with the attention kernels written by hand for Hopper.

It imports neither ``jax`` nor ``gigaam_tpu``.  Entry points run on the
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import torch

from .audio import load_audio
from .config import (
    RU_VOCAB,
    SAMPLE_RATE,
    CTCHeadConfig,
    ModelConfig,
    make_preset,
)
from .models.model import GigaAM, GigaAMASR, GigaAMEmo, model_class_for
from .types import TranscriptionResult, Word
from .weights import load_native, params_from_jax

__all__ = [
    "GigaAM",
    "GigaAMASR",
    "GigaAMEmo",
    "ModelConfig",
    "RU_VOCAB",
    "SAMPLE_RATE",
    "TranscriptionResult",
    "Word",
    "load_audio",
    "load_model",
    "load_native",
    "make_preset",
    "params_from_jax",
]


def load_model(name: str, device: Optional[Union[str, torch.device]] = None,
               init: str = "weights", seed: int = 0) -> GigaAM:
    """A model by preset name or from a ``save_model`` artifact.

    * ``init="random"`` with a preset name (``"v3_ctc"``, ``"ctc"``,
      ``"rnnt"``, ...): random weights from a ``torch.Generator`` seeded
      with ``seed``; a SentencePiece preset (v1_rnnt, the e2e models) gets
      placeholder pieces ``"<i>"`` sized to its head;
    * otherwise ``name`` is an artifact path (``model.npz`` or ``model``
      with its ``.json`` beside it), read by ``load_native``.

    ``device=None`` means the card; it raises on a host without CUDA.
    """
    if init not in ("weights", "random"):
        raise ValueError(f"init must be 'weights' or 'random', got {init!r}")
    if init == "random":
        cfg = _placeholder_vocabulary(make_preset(name))
        return model_class_for(cfg)(cfg, device=device, seed=seed)
    local = os.path.expanduser(name)
    if os.path.isfile(local) or os.path.isfile(local + ".npz"):
        return load_native(local, device=device)
    raise FileNotFoundError(
        f"no artifact at {name!r}: pass a save_model .npz/.json pair, or "
        f"init='random' with a preset name")


def _placeholder_vocabulary(cfg: ModelConfig) -> ModelConfig:
    """A SentencePiece preset resolves its vocabulary from its tokenizer
    file; without one, pieces ``"<i>"`` sized to the head stand in
    (``gigaam_tpu/__init__.py:313-323``)."""
    dec = cfg.decoding
    if dec is None or dec.vocabulary or dec.model_path is not None:
        return cfg
    n = (cfg.head.num_classes if isinstance(cfg.head, CTCHeadConfig)
         else cfg.head.joint.num_classes) - 1
    return dataclasses.replace(cfg, decoding=dataclasses.replace(
        dec, vocabulary=[f"<{i}>" for i in range(n)]))
