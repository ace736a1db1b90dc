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
from .decode.lm import NGramLM, train_lm_from_texts
from .models.model import GigaAM, GigaAMASR, GigaAMEmo, model_class_for
from .types import (
    LongformTranscriptionResult,
    Segment,
    TranscriptionResult,
    Word,
)
from .weights import load_native, params_from_jax

__all__ = [
    "GigaAM",
    "GigaAMASR",
    "GigaAMEmo",
    "LongformTranscriptionResult",
    "ModelConfig",
    "NGramLM",
    "RU_VOCAB",
    "SAMPLE_RATE",
    "Segment",
    "TranscriptionResult",
    "Word",
    "load_audio",
    "load_model",
    "load_native",
    "make_preset",
    "params_from_jax",
    "train_lm_from_texts",
]


def load_model(name: str, device: Optional[Union[str, torch.device]] = None,
               init: str = "weights", seed: int = 0,
               bf16_encoder: bool = False, **kw) -> GigaAM:
    """A model by preset name or from a ``save_model`` artifact.

    * ``init="random"`` with a preset name (``"v3_ctc"``, ``"ctc"``,
      ``"rnnt"``, ...): random weights from a ``torch.Generator`` seeded
      with ``seed``; a SentencePiece preset (v1_rnnt, the e2e models) gets
      placeholder pieces ``"<i>"`` sized to its head;
    * otherwise ``name`` is an artifact path (``model.npz`` or ``model``
      with its ``.json`` beside it), read by ``load_native``.

    ``device=None`` means the card; it raises on a host without CUDA.
    ``bf16_encoder`` casts the encoder weights to bfloat16 on a CUDA device
    (the reference's ``fp16_encoder``; the JAX package casts off the CPU);
    on the CPU it does nothing.  ``kw`` (``compute_dtype``,
    ``use_fused_attention``) go to the model class.
    """
    if init not in ("weights", "random"):
        raise ValueError(f"init must be 'weights' or 'random', got {init!r}")
    local = os.path.expanduser(name)
    if init == "random":
        cfg = _placeholder_vocabulary(make_preset(name))
        model = model_class_for(cfg)(cfg, device=device, seed=seed, **kw)
    elif os.path.isfile(local) or os.path.isfile(local + ".npz"):
        model = load_native(local, device=device, **kw)
    else:
        raise FileNotFoundError(
            f"no artifact at {name!r}: pass a save_model .npz/.json pair, "
            f"or init='random' with a preset name")
    if bf16_encoder and model.device.type == "cuda":
        model.cast_encoder()
    return model


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
