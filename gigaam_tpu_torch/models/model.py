"""User-facing model classes: GigaAM (encoder), GigaAMASR (CTC or RNNT
head) and GigaAMEmo (emotion head), ported from
``gigaam_tpu/models/model.py``.

* Audio is padded to 1-second buckets, as in the JAX package.
* Activations run in bfloat16 on CUDA and float32 on the CPU; the RNNT head
  runs in float32.
* Everything from the log-mel to the greedy CTC mask runs on the device
  with no host sync in between (only shapes steer control flow); one
  transfer then brings labels, mask, per-frame log-probs and lengths back.
  The RNNT label loop reads one flag per chunk of steps
  (``decode/rnnt_greedy.py``), then one transfer brings tokens, frames,
  counts, log-probs and lengths back.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..audio import load_audio
from ..config import (
    LONGFORM_THRESHOLD_SEC,
    SAMPLE_RATE,
    CTCHeadConfig,
    EmoHeadConfig,
    ModelConfig,
    RNNTHeadConfig,
)
from ..decode.ctc_greedy import ctc_extract, ctc_greedy_mask
from ..decode.rnnt_greedy import RNNTGreedyDecoder, rnnt_extract
from ..decode.timestamps import compute_frame_shift, frames_to_words
from ..decode.tokenizer import Tokenizer
from ..frontend import LogMelFrontend, num_frames
from ..ops.conformer_ops import static_subsampled_length
from ..types import TranscriptionResult, Word
from . import heads as heads_lib
from .encoder import (
    ConformerEncoder,
    Pos,
    PosTables,
    as_module,
    init_encoder_state,
    init_linear,
)

BUCKET_SAMPLES = SAMPLE_RATE  # pad waveforms to 1 s buckets


def bucket_length(n: int) -> int:
    return max(BUCKET_SAMPLES,
               ((n + BUCKET_SAMPLES - 1) // BUCKET_SAMPLES) * BUCKET_SAMPLES)


def pad_wav_batch(wavs: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad a list of waveforms to a common bucketed length."""
    from ..native import collate

    lens = np.array([len(w) for w in wavs], dtype=np.int32)
    max_len = bucket_length(int(lens.max()))
    return collate(wavs, max_len), lens


def resolve_device(device: Optional[Union[str, torch.device]]
                   ) -> torch.device:
    """``None`` means the card: raise rather than fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class GigaAM(nn.Module):
    """Encoder model (reference ``gigaam/model.py:16-83``)."""

    def __init__(self, cfg: ModelConfig, state: Optional[Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.device = device
        self.compute_dtype = (torch.bfloat16 if device.type == "cuda"
                              else torch.float32)
        if state is None:
            state = init_state(cfg, seed)
        self.frontend = LogMelFrontend(cfg.preprocessor)
        self.encoder = ConformerEncoder(cfg.encoder, state["encoder"])
        self.pos_tables = PosTables(cfg.encoder)
        if "head" in state:
            self.head = as_module(state["head"])
        self.to(device)

    def cast_encoder(self, dtype: torch.dtype = torch.bfloat16) -> None:
        """Cast the encoder weights in place (reference ``fp16_encoder``,
        ``gigaam/__init__.py:188-189``); the head stays fp32."""
        self.encoder.to(dtype)
        for layer in self.encoder.layers:
            layer.clear_prepared()

    # -- forward -----------------------------------------------------------

    def _encode(self, wavs: torch.Tensor, lengths: torch.Tensor, pos: Pos
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        feats, feat_lens = self.frontend(wavs, lengths)
        return self.encoder(feats.transpose(1, 2), feat_lens, pos,
                            self.compute_dtype)

    def _pos_for(self, padded_samples: int) -> Pos:
        """The positional input for a padded batch: (cos, sin) for rotary,
        the [2T'-1, D] table for rel-pos (``_pos_for_tfeat``)."""
        t_sub = static_subsampled_length(
            num_frames(padded_samples, self.cfg.preprocessor),
            self.cfg.encoder.num_subsampling_stages,
            self.cfg.encoder.subs_kernel_size)
        if self.cfg.encoder.self_attention_model == "rotary":
            return self.pos_tables.rotary(t_sub, self.device)
        return self.pos_tables.relpos(t_sub, self.device)

    def _device_batch(self, wavs: List[np.ndarray]):
        batch, lens = pad_wav_batch(wavs)
        return (torch.from_numpy(batch).to(self.device),
                torch.from_numpy(lens).to(self.device), lens,
                self._pos_for(batch.shape[1]))

    @torch.inference_mode()
    def encode_batch(self, wavs: List[np.ndarray]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Waveforms -> (encoded [B, T', D], enc_lens [B]) on the device."""
        dev_batch, dev_lens, _, pos = self._device_batch(wavs)
        return self._encode(dev_batch, dev_lens, pos)

    def prepare_wav(self, wav_file: Union[str, np.ndarray]) -> np.ndarray:
        """Path -> 16 kHz float waveform; arrays pass through."""
        if isinstance(wav_file, np.ndarray):
            return np.asarray(wav_file, dtype=np.float32)
        return load_audio(wav_file)

    def embed_audio(self, wav_file: Union[str, np.ndarray],
                    layout: str = "btd") -> Tuple[torch.Tensor, torch.Tensor]:
        """Encoder representations (``gigaam/model.py:57-63``): ``"btd"``
        gives [1, T', D] (time-major, the default), ``"bdt"`` gives
        [1, D, T'] as the reference returns them."""
        if layout not in ("btd", "bdt"):
            raise ValueError(f"layout must be 'btd' or 'bdt', got {layout!r}")
        encoded, enc_len = self.encode_batch([self.prepare_wav(wav_file)])
        if layout == "bdt":
            encoded = encoded.transpose(1, 2)
        return encoded, enc_len


class GigaAMASR(GigaAM):
    """ASR model with a CTC or RNNT head (reference
    ``gigaam/model.py:86-259``); greedy decoding."""

    def __init__(self, cfg: ModelConfig, **kw):
        if (not isinstance(cfg.head, (CTCHeadConfig, RNNTHeadConfig))
                or cfg.decoding is None):
            raise ValueError("GigaAMASR needs a CTC or RNNT head and a "
                             "decoding config")
        self.tokenizer = Tokenizer(cfg.decoding.vocabulary or [],
                                   cfg.decoding.model_path)
        super().__init__(cfg, **kw)
        self.blank_id = len(self.tokenizer)
        self.rnnt = (RNNTGreedyDecoder()
                     if isinstance(cfg.head, RNNTHeadConfig) else None)

    def _ctc_forward(self, wavs: torch.Tensor, lengths: torch.Tensor,
                     pos: Pos):
        encoded, enc_lens = self._encode(wavs, lengths, pos)
        log_probs = heads_lib.ctc_log_probs(self.head, encoded)
        labels, keep = ctc_greedy_mask(log_probs, enc_lens)
        # argmax token's log-prob per frame: feeds per-word confidence
        tok_lp = log_probs.amax(dim=-1)
        return labels, keep, tok_lp, enc_lens

    def _ctc_decode(self, dev_batch, dev_lens, pos):
        """-> per sample (ids, frames, token log-probs), enc_lens (host)."""
        labels, keep, tok_lp, enc_lens = (
            t.cpu().numpy() for t in self._ctc_forward(dev_batch, dev_lens, pos))
        return [(ids, frames, [float(tok_lp[i, f]) for f in frames])
                for i, (ids, frames) in enumerate(ctc_extract(labels, keep))
                ], enc_lens

    def _rnnt_decode(self, dev_batch, dev_lens, pos):
        """Encode, run the greedy label loop on the device, then bring
        tokens, frames, counts, log-probs and lengths back in one
        transfer."""
        encoded, enc_lens = self._encode(dev_batch, dev_lens, pos)
        tokens, frames, counts, logps = self.rnnt.decode(
            self.head, encoded, enc_lens,
            max_symbols=self.cfg.decoding.max_symbols_per_step,
            with_logps=True)
        u = tokens.shape[1]
        host = torch.cat([tokens, frames, logps.view(torch.int32),
                          counts[:, None], enc_lens[:, None].int()],
                         dim=1).cpu().numpy()
        logps_np = np.ascontiguousarray(host[:, 2 * u:3 * u]).view(np.float32)
        counts_np = host[:, 3 * u]
        pairs = rnnt_extract(host[:, :u], host[:, u:2 * u], counts_np)
        return [(ids, fr, logps_np[i, :len(ids)].tolist())
                for i, (ids, fr) in enumerate(pairs)], host[:, 3 * u + 1]

    @torch.inference_mode()
    def _decode_batch(self, wavs: List[np.ndarray], word_timestamps: bool
                      ) -> List[Tuple[str, Optional[List[Word]]]]:
        """Batched greedy transcription (reference ``model.py:96-124``)."""
        dev_batch, dev_lens, lens, pos = self._device_batch(wavs)
        decode = self._ctc_decode if self.rnnt is None else self._rnnt_decode
        decoded, enc_lens = decode(dev_batch, dev_lens, pos)
        out: List[Tuple[str, Optional[List[Word]]]] = []
        for i, (ids, frames, logps) in enumerate(decoded):
            words = None
            if word_timestamps:
                shift = compute_frame_shift(int(lens[i]), int(enc_lens[i]))
                words = frames_to_words(self.tokenizer, ids, frames, shift,
                                        token_logps=logps)
            out.append((self.tokenizer.decode(ids), words))
        return out

    def transcribe(self, wav_file: Union[str, np.ndarray],
                   word_timestamps: bool = False) -> TranscriptionResult:
        """Transcribe a short (<25 s) clip (``model.py:126-140``)."""
        wav = self.prepare_wav(wav_file)
        if len(wav) > LONGFORM_THRESHOLD_SEC * SAMPLE_RATE:
            raise ValueError(
                "Too long wav file, use 'transcribe_longform' method.")
        text, words = self._decode_batch([wav], word_timestamps)[0]
        return TranscriptionResult(text=text, words=words)


class GigaAMEmo(GigaAM):
    """Emotion recognition model (reference ``gigaam/model.py:262-317``)."""

    def __init__(self, cfg: ModelConfig, **kw):
        if not isinstance(cfg.head, EmoHeadConfig):
            raise ValueError("GigaAMEmo needs an emo head")
        super().__init__(cfg, **kw)
        self.id2name = cfg.id2name or [
            str(i) for i in range(cfg.head.num_classes)]

    @torch.inference_mode()
    def get_probs(self, wav_file: Union[str, np.ndarray]) -> Dict[str, float]:
        """Class probabilities of one clip, ``{label: prob}`` in ``id2name``
        order."""
        dev_batch, dev_lens, _, pos = self._device_batch(
            [self.prepare_wav(wav_file)])
        encoded, enc_lens = self._encode(dev_batch, dev_lens, pos)
        probs = heads_lib.emo_probs(self.head, encoded, enc_lens)[0].cpu()
        return {name: float(p) for name, p in zip(self.id2name, probs)}


def init_state(cfg: ModelConfig, seed: int = 0) -> Dict[str, Any]:
    """Random weights for ``cfg`` from a ``torch.Generator`` seeded with
    ``seed`` (CPU tensors, fp32)."""
    gen = torch.Generator().manual_seed(seed)
    state: Dict[str, Any] = {"encoder": init_encoder_state(gen, cfg.encoder)}
    if isinstance(cfg.head, (CTCHeadConfig, EmoHeadConfig)):
        state["head"] = {"proj": init_linear(gen, cfg.head.feat_in,
                                             cfg.head.num_classes)}
    elif isinstance(cfg.head, RNNTHeadConfig):
        state["head"] = heads_lib.init_rnnt_head(gen, cfg.head)
    return state


def model_class_for(cfg: ModelConfig):
    if cfg.model_class == "asr":
        return GigaAMASR
    if cfg.model_class == "ssl":
        return GigaAM
    if cfg.model_class == "emo":
        return GigaAMEmo
    raise NotImplementedError(f"model class {cfg.model_class!r} is not ported")
