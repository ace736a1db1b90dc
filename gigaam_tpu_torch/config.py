"""Typed configuration for GigaAM models (copy of ``gigaam_tpu/config.py``).

The port keeps its own copy so that it never imports the JAX package.

The reference embeds Hydra/OmegaConf configs inside each checkpoint and
``_target_``-instantiates components at load time (reference
``gigaam/model.py:24-25,93-94``, ``gigaam/__init__.py:167-185``).  We replace
that reflection machinery with explicit typed dataclasses plus a small
registry of known presets.  The JSON form is the one ``save_model``
artifacts carry, so ``weights.load_native`` reads them unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

SAMPLE_RATE = 16000
LONGFORM_THRESHOLD_SEC = 25.0


@dataclass
class FeaturesConfig:
    """Log-mel frontend config (reference ``gigaam/preprocess.py:53-76``)."""

    sample_rate: int = SAMPLE_RATE
    features: int = 64               # n_mels
    win_length: int = SAMPLE_RATE // 40    # 400
    hop_length: int = SAMPLE_RATE // 100   # 160
    n_fft: int = SAMPLE_RATE // 40         # 400
    center: bool = True              # v3 uses center=False (triton README:26)
    dither: float = 0.0


@dataclass
class EncoderConfig:
    """Conformer encoder config (reference ``gigaam/encoder.py:510-525``)."""

    feat_in: int = 64
    n_layers: int = 16
    d_model: int = 768
    subsampling: str = "conv2d"          # "conv1d" | "conv2d"
    subs_kernel_size: int = 3
    subsampling_factor: int = 4
    ff_expansion_factor: int = 4
    self_attention_model: str = "rotary"  # "rotary" | "rel_pos"
    n_heads: int = 16
    pos_emb_max_len: int = 5000
    conv_norm_type: str = "batch_norm"    # "batch_norm" | "layer_norm"
    conv_kernel_size: int = 31
    flash_attn: bool = False              # fused Pallas attention path
    activation_checkpointing: bool = False
    # remat policy under activation checkpointing:
    #   "full" — save nothing, recompute the whole layer in backward
    #            (the reference semantics, ``gigaam/encoder.py:628-638``)
    #   "dots" — save matmul outputs (jax ``dots_with_no_batch_dims``
    #            policy): backward skips recomputing the MXU-heavy FFN /
    #            projection matmuls at the cost of holding their outputs
    #            (~1.6 GB bf16 at b8 x 20 s across 16 layers)
    remat_policy: str = "full"

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_ff(self) -> int:
        return self.d_model * self.ff_expansion_factor

    @property
    def num_subsampling_stages(self) -> int:
        import math

        return int(math.log(self.subsampling_factor, 2))


@dataclass
class CTCHeadConfig:
    """1x1 conv head (reference ``gigaam/decoder.py:7-21``)."""

    kind: str = "ctc"
    feat_in: int = 768
    num_classes: int = 34   # len(vocab) + 1 blank for charwise Russian


@dataclass
class RNNTDecoderConfig:
    pred_hidden: int = 320
    pred_rnn_layers: int = 1
    num_classes: int = 34


@dataclass
class RNNTJointConfig:
    enc_hidden: int = 768
    pred_hidden: int = 320
    joint_hidden: int = 320
    num_classes: int = 34


@dataclass
class RNNTHeadConfig:
    """Prediction network + joint (reference ``gigaam/decoder.py:140-150``)."""

    kind: str = "rnnt"
    decoder: RNNTDecoderConfig = field(default_factory=RNNTDecoderConfig)
    joint: RNNTJointConfig = field(default_factory=RNNTJointConfig)


@dataclass
class EmoHeadConfig:
    """Mean-pool + linear classifier (reference ``gigaam/model.py:262-293``)."""

    kind: str = "emo"
    feat_in: int = 768
    num_classes: int = 4


@dataclass
class DecodingConfig:
    """Greedy decoding config (reference ``gigaam/decoding.py``)."""

    kind: str = "ctc_greedy"   # "ctc_greedy" | "rnnt_greedy"
    vocabulary: List[str] = field(default_factory=list)
    model_path: Optional[str] = None   # sentencepiece model for v1_rnnt / e2e
    max_symbols_per_step: int = 10


# Char-wise Russian vocabulary used by all non-e2e, non-v1_rnnt models
# (embedded in reference checkpoints; space + 32 Cyrillic letters, ё folded
# into е by text normalization, reference ``gigaam/utils.py:228-239``).
RU_VOCAB: List[str] = [" "] + [chr(c) for c in range(ord("а"), ord("я") + 1)]


@dataclass
class ModelConfig:
    model_name: str = "v3_ctc"
    model_class: str = "asr"  # "ssl" | "asr" | "emo"
    preprocessor: FeaturesConfig = field(default_factory=FeaturesConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    head: Optional[Any] = None          # CTCHeadConfig | RNNTHeadConfig | EmoHeadConfig
    decoding: Optional[DecodingConfig] = None
    id2name: Optional[List[str]] = None  # emo label names

    # --- serialization -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), ensure_ascii=False, indent=2)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ModelConfig":
        d = dict(d)
        d["preprocessor"] = FeaturesConfig(**d.get("preprocessor", {}))
        d["encoder"] = EncoderConfig(**d.get("encoder", {}))
        head = d.get("head")
        if head is not None:
            kind = head.get("kind")
            if kind == "ctc":
                d["head"] = CTCHeadConfig(**head)
            elif kind == "rnnt":
                head = dict(head)
                head["decoder"] = RNNTDecoderConfig(**head["decoder"])
                head["joint"] = RNNTJointConfig(**head["joint"])
                d["head"] = RNNTHeadConfig(**head)
            elif kind == "emo":
                d["head"] = EmoHeadConfig(**head)
            else:
                raise ValueError(f"Unknown head kind: {kind}")
        dec = d.get("decoding")
        if dec is not None:
            d["decoding"] = DecodingConfig(**dec)
        return ModelConfig(**d)

    @staticmethod
    def from_json(s: str) -> "ModelConfig":
        return ModelConfig.from_dict(json.loads(s))


def _v3_features() -> FeaturesConfig:
    # v3 preprocessing uses center=False STFT (reference
    # ``triton_scripts/run_convert_onnx.py:111-116``, ``preprocess.py:65,78-92``)
    return FeaturesConfig(center=False)


def _encoder(attention: str) -> EncoderConfig:
    return EncoderConfig(self_attention_model=attention)


def make_preset(name: str) -> ModelConfig:
    """Build a ModelConfig for a known model family.

    Mirrors the reference model zoo (``gigaam/__init__.py:28-41``): v{1,2,3}
    x {ssl, ctc, rnnt}, v3_e2e_{ctc,rnnt}, emo.  Hyperparameters that the
    reference stores inside checkpoints are reproduced from the encoder
    defaults (``gigaam/encoder.py:510-525``) and head defaults.
    """
    short = {"ctc": "v3_ctc", "rnnt": "v3_rnnt", "ssl": "v3_ssl",
             "e2e_ctc": "v3_e2e_ctc", "e2e_rnnt": "v3_e2e_rnnt"}
    name = short.get(name, name)

    version = "v3" if name == "emo" else name.split("_")[0]
    attention = "rotary" if version == "v3" else "rel_pos"
    feats = _v3_features() if version == "v3" and name != "emo" else FeaturesConfig()
    enc = _encoder(attention)

    if "ssl" in name:
        return ModelConfig(model_name=name, model_class="ssl",
                           preprocessor=feats, encoder=enc)
    if name == "emo":
        return ModelConfig(
            model_name=name, model_class="emo",
            preprocessor=FeaturesConfig(), encoder=_encoder("rel_pos"),
            head=EmoHeadConfig(),
            id2name=["angry", "sad", "neutral", "positive"])

    needs_sp = name == "v1_rnnt" or "e2e" in name
    vocab = [] if needs_sp else list(RU_VOCAB)
    nc = (len(vocab) + 1) if vocab else 512 + 1  # sp vocab resolved at load

    if "ctc" in name:
        return ModelConfig(
            model_name=name, model_class="asr", preprocessor=feats, encoder=enc,
            head=CTCHeadConfig(num_classes=nc),
            decoding=DecodingConfig(kind="ctc_greedy", vocabulary=vocab))
    if "rnnt" in name:
        return ModelConfig(
            model_name=name, model_class="asr", preprocessor=feats, encoder=enc,
            head=RNNTHeadConfig(
                decoder=RNNTDecoderConfig(num_classes=nc),
                joint=RNNTJointConfig(num_classes=nc)),
            decoding=DecodingConfig(kind="rnnt_greedy", vocabulary=vocab))
    raise ValueError(f"Unknown model preset: {name}")
