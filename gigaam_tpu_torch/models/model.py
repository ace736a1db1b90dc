"""User-facing model classes: GigaAM (encoder), GigaAMASR (CTC or RNNT
head) and GigaAMEmo (emotion head), ported from
``gigaam_tpu/models/model.py``.

* Audio is padded to 1-second buckets (``bucket``), as in the JAX package.
* Activations run in bfloat16 on CUDA and float32 on the CPU unless the
  caller names a ``compute_dtype``; the RNNT head runs in float32.
* Everything from the log-mel to the greedy CTC mask runs on the device
  with no host sync in between (only shapes steer control flow).  The
  padded batch goes to the card from pinned memory without blocking the
  host; the results come back the same way into pinned buffers, followed
  by a CUDA event, and ``finalize`` waits on that event only
  (``_host_copies``).  So ``transcribe_longform`` keeps two chunk batches
  in flight: batch i+1's forward is queued before batch i's results are
  read.  The RNNT label loop reads one flag per chunk of steps
  (``decode/rnnt_greedy.py``), so an RNNT submit returns only after its
  loop ends (the JAX package's contract too): there, only batch i's host
  decode overlaps batch i+1's encoder.
* ``align``/``align_batch``: CTC forced alignment, one encoder forward for
  the batch and the Viterbi DP on the device (``decode/align.py``).
* ``beam_size > 1``: RNNT models run the beam on the device
  (``decode/rnnt_beam.py``, one flag read per chunk of expansions, like the
  greedy loop); CTC models copy the full posteriors to the host and run
  the prefix beam there (``decode/ctc_beam.py``) inside ``finalize``, so
  that in ``transcribe_longform`` batch i's beam overlaps batch i+1's
  device work.  ``lm`` adds n-gram shallow fusion to either
  (``decode/lm.py``): the CTC beam scores through the ``NGramLM`` object,
  the RNNT beam through its table on the device (``_resolve_lm``).
* Threads: a model may be called from several threads at once (the
  server's batch loop beside its longform and stream handlers).  One
  reentrant device lock per model serializes the calls' device work:
  ``_decode_batch_submit`` holds it up to the return of ``finalize`` (so the
  RNNT loops' host reads, which steer their launches, run under it),
  ``encode_batch``, ``get_probs`` and ``align_batch`` while they launch,
  ``transcribe_longform`` around its VAD; the host waits for results
  (``finalize``, ``_host_copies``) run after it is released.  Everything
  runs on one stream, so stream order keeps the shared state of the
  decoders' CUDA graphs, their lazy captures, the folded-weight caches and
  ``_resolve_lm``'s tables safe.
* ``set_mesh``: data-parallel inference, one process per device, each
  holding a whole replica (JAX ``model.py:115-140``).  ``encode_batch``,
  ``_decode_batch_submit`` (and so ``transcribe_longform``) and
  ``align_batch`` pad the rows to a multiple of the data size
  (``_dp_pad``), run this rank's contiguous block of them and gather the
  results in rank order, so that every rank returns what one process
  returns.  Every rank must make the same calls.  The gathers run after
  the device lock is released (``finalize``), so that no collective waits
  while another thread holds the lock.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

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
from ..data import normalize_text
from ..decode.align import ViterbiAligner, backtrack, pad_targets
from ..decode.ctc_beam import ctc_beam_batch
from ..decode.ctc_greedy import ctc_extract, ctc_greedy_mask
from ..decode.lm import NGramLM
from ..decode.rnnt_beam import RNNTBeamDecoder, lm_device_table
from ..decode.rnnt_greedy import RNNTGreedyDecoder, rnnt_extract
from ..decode.timestamps import compute_frame_shift, frames_to_words
from ..decode.tokenizer import Tokenizer
from ..frontend import LogMelFrontend, num_frames
from ..ops.conformer_ops import static_subsampled_length
from ..parallel.collectives import all_gather_rows
from ..parallel.mesh import axis_group, axis_size, data_rows
from ..types import (
    LongformTranscriptionResult,
    Segment,
    TranscriptionResult,
    Word,
)
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


def bucket_length(n: int, bucket: int = BUCKET_SAMPLES) -> int:
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def pad_wav_batch(wavs: List[np.ndarray], bucket: int = BUCKET_SAMPLES
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad a list of waveforms to a common bucketed length."""
    from ..native import collate

    lens = np.array([len(w) for w in wavs], dtype=np.int32)
    max_len = bucket_length(int(lens.max()), bucket)
    return collate(wavs, max_len), lens


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to the card from pinned memory without
    blocking the host (a pageable copy waits for the whole stream, the
    forward queued before it included)."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _host_copies(*tensors: torch.Tensor) -> Callable[[], List[np.ndarray]]:
    """Queue the copies of ``tensors`` to the host; returns a function that
    waits for them and gives them as numpy arrays.

    On CUDA each copy goes, without blocking, into a pinned buffer, and a
    CUDA event is recorded after them: the wait is on that event only, not
    on what is queued behind it (the next chunk batch's forward).  On the
    CPU the arrays are the tensors' own."""
    if not tensors[0].is_cuda:
        arrays = [t.numpy() for t in tensors]
        return lambda: arrays
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait() -> List[np.ndarray]:
        done.synchronize()
        return [h.numpy() for h in host]

    return wait


def _holds_device_lock(fn):
    """Run the method with its model's device lock held."""
    @functools.wraps(fn)
    def locked(self, *args, **kwargs):
        with self._device_lock:
            return fn(self, *args, **kwargs)
    return locked


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
    """Encoder model (reference ``gigaam/model.py:16-83``).

    ``compute_dtype`` (None: bfloat16 on CUDA, float32 on the CPU) is the
    activations' dtype.  ``use_fused_attention`` (None: True) routes the
    attention through the hand-written kernels (K1/K2/K3, K5); False runs
    it composed of PyTorch ops, on every device: the caller's choice,
    never a fallback.  It is kept on the model, not in ``cfg``, so that a
    config shared by several models is never modified.  ``_int16_wire``
    (off) sends the padded batch to the device as int16 and dequantizes
    it there: half the host-to-device bytes, at most 1.5e-5 of amplitude
    error (none for audio read from 16-bit files)."""

    def __init__(self, cfg: ModelConfig, state: Optional[Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0, compute_dtype: Optional[torch.dtype] = None,
                 use_fused_attention: Optional[bool] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.device = device
        if compute_dtype is None:
            compute_dtype = (torch.bfloat16 if device.type == "cuda"
                             else torch.float32)
        self.compute_dtype = compute_dtype
        self.use_fused_attention = (True if use_fused_attention is None
                                    else bool(use_fused_attention))
        self._int16_wire = False
        self._device_lock = threading.RLock()
        self.mesh = None
        self._data_group = None
        if state is None:
            state = init_state(cfg, seed)
        self.frontend = LogMelFrontend(cfg.preprocessor)
        self.encoder = ConformerEncoder(cfg.encoder, state["encoder"])
        self.pos_tables = PosTables(cfg.encoder)
        if "head" in state:
            self.head = as_module(state["head"])
        self.to(device)

    def set_mesh(self, mesh) -> None:
        """Data-parallel inference over a ("data", "model") ``DeviceMesh``
        (``parallel.mesh.make_mesh``): this process keeps its whole replica
        on its own device; every batch's rows are split over "data" (the
        "model" ranks of one data block run the same rows).  The weights
        must be the same on every rank (the same artifact or seed)."""
        self.mesh = mesh
        self._data_group = axis_group(mesh, "data")

    def _dp_pad(self, wavs: List[np.ndarray]
                ) -> Tuple[List[np.ndarray], int]:
        """Pad the row count to a multiple of the data size with filler
        rows (zeros of the shortest length); returns (rows, fillers)."""
        if self.mesh is None:
            return wavs, 0
        pad = (-len(wavs)) % axis_size(self.mesh, "data")
        if pad:
            filler = np.zeros(min(len(w) for w in wavs), dtype=np.float32)
            wavs = list(wavs) + [filler] * pad
        return wavs, pad

    def _gather(self, local: List[Any], n: int) -> List[Any]:
        """Every rank's per-row results in rank order (one process: its
        own), cut to the first ``n``."""
        return all_gather_rows(self._data_group, local)[:n]

    def cast_encoder(self, dtype: torch.dtype = torch.bfloat16) -> None:
        """Cast the encoder weights in place (reference ``fp16_encoder``,
        ``gigaam/__init__.py:188-189``); the head stays fp32."""
        self.encoder.to(dtype)
        for layer in self.encoder.layers:
            layer.clear_prepared()

    # -- forward -----------------------------------------------------------

    def _encode(self, wavs: torch.Tensor, lengths: torch.Tensor, pos: Pos
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if wavs.dtype == torch.int16:           # the int16 wire
            wavs = wavs.float() * (1.0 / 32768.0)
        feats, feat_lens = self.frontend(wavs, lengths)
        return self.encoder(feats.transpose(1, 2), feat_lens, pos,
                            self.compute_dtype, self.use_fused_attention)

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

    def _device_batch(self, wavs: List[np.ndarray],
                      bucket: int = BUCKET_SAMPLES):
        """(padded batch and lengths on the device, host lengths, pos).
        Under a mesh, of this rank's rows only, padded to the whole batch's
        length (as one process pads them)."""
        batch, lens = pad_wav_batch(wavs, bucket)
        pos = self._pos_for(batch.shape[1])
        if self.mesh is not None:
            rows = data_rows(self.mesh, len(wavs))
            batch, lens = batch[rows], lens[rows]
        if self._int16_wire:
            batch = np.clip(np.rint(batch * 32768.0), -32768,
                            32767).astype(np.int16)
        return (_to_device(batch, self.device),
                _to_device(lens, self.device), lens, pos)

    @torch.inference_mode()
    def encode_batch(self, wavs: List[np.ndarray]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Waveforms -> (encoded [B, T', D], enc_lens [B]) on the device."""
        n = len(wavs)
        with self._device_lock:
            dev_batch, dev_lens, _, pos = self._device_batch(
                self._dp_pad(wavs)[0])
            encoded, enc_lens = self._encode(dev_batch, dev_lens, pos)
        if self.mesh is None:
            return encoded, enc_lens
        rows = self._gather(list(zip(encoded.cpu(), enc_lens.cpu())), n)
        return (torch.stack([e for e, _ in rows]).to(self.device),
                torch.stack([l for _, l in rows]).to(self.device))

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

    def to_exported(self, out_dir: str, **kw) -> Dict[str, Any]:
        """Write this model's serving graphs (``torch.export`` programs) to
        ``out_dir``: the analogue of the reference's ``model.to_onnx``
        (``gigaam/model.py:65-71``).  ``kw`` go to ``export.export_model``
        (the buckets); ``exported_infer`` runs inference off the artifacts
        alone."""
        from ..export import export_model

        return export_model(self, out_dir, **kw)


class GigaAMASR(GigaAM):
    """ASR model with a CTC or RNNT head (reference
    ``gigaam/model.py:86-259``); greedy and beam decoding with optional
    n-gram fusion, longform transcription and, for CTC heads, forced
    alignment."""

    def __init__(self, cfg: ModelConfig, **kw):
        if (not isinstance(cfg.head, (CTCHeadConfig, RNNTHeadConfig))
                or cfg.decoding is None):
            raise ValueError("GigaAMASR needs a CTC or RNNT head and a "
                             "decoding config")
        self.tokenizer = Tokenizer(cfg.decoding.vocabulary or [],
                                   cfg.decoding.model_path)
        super().__init__(cfg, **kw)
        self.blank_id = len(self.tokenizer)
        is_ctc = isinstance(cfg.head, CTCHeadConfig)
        self.rnnt = None if is_ctc else RNNTGreedyDecoder()
        self.rnnt_beam = None if is_ctc else RNNTBeamDecoder()
        self.aligner = ViterbiAligner() if is_ctc else None
        # (path, NGramLM) of the last LM loaded from a path, and (NGramLM,
        # its version, its device table) of the last RNNT fusion
        self._lm_path: Optional[Tuple[str, NGramLM]] = None
        self._lm_dev: Optional[Tuple[NGramLM, int, tuple]] = None

    def _ctc_forward(self, wavs: torch.Tensor, lengths: torch.Tensor,
                     pos: Pos):
        encoded, enc_lens = self._encode(wavs, lengths, pos)
        log_probs = heads_lib.ctc_log_probs(self.head, encoded)
        labels, keep = ctc_greedy_mask(log_probs, enc_lens)
        # argmax token's log-prob per frame: feeds per-word confidence
        tok_lp = log_probs.amax(dim=-1)
        return labels, keep, tok_lp, enc_lens

    def _ctc_logprobs(self, wavs: torch.Tensor, lengths: torch.Tensor,
                      pos: Pos) -> Tuple[torch.Tensor, torch.Tensor]:
        """The full posteriors [B, T', V] in fp32 and enc_lens: the
        alignment's and the prefix beam's input."""
        encoded, enc_lens = self._encode(wavs, lengths, pos)
        return heads_lib.ctc_log_probs(self.head, encoded), enc_lens

    def _ctc_submit(self, dev_batch, dev_lens, pos, n: int):
        """Queue the CTC forward and its results' copy to the host; returns
        the host half: per sample (ids, frames, token log-probs), and
        enc_lens, for the first ``n`` rows."""
        labels, keep, tok_lp, enc_lens = self._ctc_forward(dev_batch,
                                                           dev_lens, pos)
        wait = _host_copies(labels[:n], keep[:n], tok_lp[:n], enc_lens[:n])

        def decode_host():
            labels, keep, tok_lp, enc_lens = wait()
            return [(ids, frames, [float(tok_lp[i, f]) for f in frames])
                    for i, (ids, frames) in enumerate(ctc_extract(labels,
                                                                  keep))
                    ], enc_lens

        return decode_host

    def _ctc_beam_submit(self, dev_batch, dev_lens, pos, n: int,
                         beam_size: int, lm: Optional[NGramLM],
                         lm_weight: float, token_bonus: float):
        """Queue the CTC forward and the copy of its full posteriors to the
        host; returns the host half, which runs the prefix beam over the
        first ``n`` rows (JAX ``model.py:380-401``)."""
        log_probs, enc_lens = self._ctc_logprobs(dev_batch, dev_lens, pos)
        wait = _host_copies(log_probs[:n], enc_lens[:n])

        def decode_host():
            lp, enc_lens = wait()
            pairs = ctc_beam_batch(lp, enc_lens, beam_size=beam_size, lm=lm,
                                   lm_weight=lm_weight,
                                   token_bonus=token_bonus)
            # confidence proxy: the chosen token's posterior at its emit
            # frame (the beam's sum over alignments has no per-token
            # decomposition)
            return [(ids, frames, [float(lp[i, f, tok])
                                   for tok, f in zip(ids, frames)])
                    for i, (ids, frames) in enumerate(pairs)], enc_lens

        return decode_host

    def _rnnt_submit(self, dev_batch, dev_lens, pos, n: int, beam_size: int,
                     lm_spec: Optional[tuple], lm_weight: float,
                     token_bonus: float):
        """Encode and run the greedy label loop, or at ``beam_size > 1`` the
        beam (with the LM's device table ``lm_spec``), on the device (each
        reads one flag per chunk of steps, so this returns after the loop),
        then queue tokens, frames, counts, log-probs and lengths of the
        first ``n`` rows to the host as one tensor; returns the host half."""
        encoded, enc_lens = self._encode(dev_batch, dev_lens, pos)
        max_symbols = self.cfg.decoding.max_symbols_per_step
        if beam_size > 1:
            tokens, frames, counts, logps = self.rnnt_beam.decode(
                self.head, encoded, enc_lens, beam_size=beam_size,
                max_symbols=max_symbols, lm=lm_spec, lm_weight=lm_weight,
                token_bonus=token_bonus, with_logps=True)
        else:
            tokens, frames, counts, logps = self.rnnt.decode(
                self.head, encoded, enc_lens, max_symbols=max_symbols,
                with_logps=True)
        u = tokens.shape[1]
        wait = _host_copies(torch.cat(
            [tokens, frames, logps.view(torch.int32), counts[:, None],
             enc_lens[:, None].int()], dim=1)[:n])

        def decode_host():
            host = wait()[0]
            logps_np = np.ascontiguousarray(
                host[:, 2 * u:3 * u]).view(np.float32)
            pairs = rnnt_extract(host[:, :u], host[:, u:2 * u],
                                 host[:, 3 * u])
            return [(ids, fr, logps_np[i, :len(ids)].tolist())
                    for i, (ids, fr) in enumerate(pairs)], host[:, 3 * u + 1]

        return decode_host

    def _resolve_lm(self, lm: Union[None, str, NGramLM]
                    ) -> Tuple[Optional[NGramLM], Optional[tuple]]:
        """``lm``: an ``NGramLM``, an npz path or None -> (the LM, its
        (table, base, ctx_len) on the device for the RNNT beam, or None for
        a CTC model, whose beam scores on the host through the object).  A
        path is loaded once; the table is built once per LM object and
        version (JAX ``model.py:304-343``)."""
        if lm is None:
            return None, None
        if isinstance(lm, str):
            if self._lm_path is None or self._lm_path[0] != lm:
                self._lm_path = (lm, NGramLM.load(lm))
            lm = self._lm_path[1]
        if lm.vocab_size != len(self.tokenizer):
            raise ValueError(
                f"LM vocab_size {lm.vocab_size} != tokenizer vocab "
                f"{len(self.tokenizer)}: train the LM with this model's "
                f"tokenizer (train_lm_from_texts)")
        if self.rnnt is None:
            return lm, None
        cached = self._lm_dev
        if cached is None or cached[0] is not lm or cached[1] != lm.version:
            # ordinary tensors: the beam's graphs are stamped with their
            # versions, which inference tensors do not keep
            with torch.inference_mode(False):
                cached = (lm, lm.version, lm_device_table(lm, self.device))
            self._lm_dev = cached
        return lm, cached[2]

    @_holds_device_lock
    @torch.inference_mode()
    def _decode_batch_submit(
        self, wavs: List[np.ndarray], word_timestamps: bool,
        beam_size: int = 1, pad_rows_to: int = 0,
        bucket: int = BUCKET_SAMPLES, lm=None, lm_weight: float = 0.5,
        token_bonus: float = 0.0,
    ) -> Callable[[], List[Tuple[str, Optional[List[Word]]]]]:
        """Queue the device work of a batch; returns ``finalize()``
        (``gigaam_tpu/models/model.py:345-466``).

        A caller may submit the next batch before finalizing this one:
        ``finalize()`` waits for this batch's results only (a CUDA event
        after their copy to pinned host buffers) and returns the
        ``_decode_batch`` list.  ``pad_rows_to`` pads the row count with
        filler rows (zeros of the shortest length), dropped before any host
        decode; ``bucket`` is the padding granularity in samples (padded
        frames are masked: the results do not change).  ``beam_size > 1``
        runs the RNNT beam on the device or the CTC prefix beam on the host
        (in ``finalize``); ``lm`` (an ``NGramLM`` or an npz path) adds
        shallow fusion with weight ``lm_weight`` and a per-token
        ``token_bonus``, and requires ``beam_size > 1``.  Under a mesh
        ``finalize()`` gathers every rank's rows (a collective)."""
        if lm is not None and beam_size <= 1:
            raise ValueError("LM shallow fusion requires beam_size > 1")
        lm, lm_spec = self._resolve_lm(lm)
        n = len(wavs)
        if pad_rows_to > n:
            filler = np.zeros(min(len(w) for w in wavs), np.float32)
            wavs = list(wavs) + [filler] * (pad_rows_to - n)
        wavs, _ = self._dp_pad(wavs)
        dev_batch, dev_lens, lens, pos = self._device_batch(wavs, bucket)
        # the rows to bring back: every row of this rank's block under a
        # mesh (the fillers go after the gather)
        keep = n if self.mesh is None else len(lens)
        if self.rnnt is not None:
            decode_host = self._rnnt_submit(dev_batch, dev_lens, pos, keep,
                                            beam_size, lm_spec, lm_weight,
                                            token_bonus)
        elif beam_size > 1:
            decode_host = self._ctc_beam_submit(dev_batch, dev_lens, pos,
                                                keep, beam_size, lm,
                                                lm_weight, token_bonus)
        else:
            decode_host = self._ctc_submit(dev_batch, dev_lens, pos, keep)

        def finalize() -> List[Tuple[str, Optional[List[Word]]]]:
            decoded, enc_lens = decode_host()
            out: List[Tuple[str, Optional[List[Word]]]] = []
            for i, (ids, frames, logps) in enumerate(decoded):
                words = None
                if word_timestamps:
                    shift = compute_frame_shift(int(lens[i]),
                                                int(enc_lens[i]))
                    words = frames_to_words(self.tokenizer, ids, frames,
                                            shift, token_logps=logps)
                out.append((self.tokenizer.decode(ids), words))
            return self._gather(out, n)

        return finalize

    def _decode_batch(
        self, wavs: List[np.ndarray], word_timestamps: bool,
        beam_size: int = 1, pad_rows_to: int = 0,
        bucket: int = BUCKET_SAMPLES, lm=None, lm_weight: float = 0.5,
        token_bonus: float = 0.0,
    ) -> List[Tuple[str, Optional[List[Word]]]]:
        """Batched transcription (reference ``model.py:96-124``):
        ``_decode_batch_submit`` with the same keywords, finalized."""
        return self._decode_batch_submit(
            wavs, word_timestamps, beam_size=beam_size,
            pad_rows_to=pad_rows_to, bucket=bucket, lm=lm,
            lm_weight=lm_weight, token_bonus=token_bonus)()

    def transcribe(self, wav_file: Union[str, np.ndarray],
                   word_timestamps: bool = False, beam_size: int = 1,
                   lm: Union[None, str, NGramLM] = None,
                   lm_weight: float = 0.5, token_bonus: float = 0.0
                   ) -> TranscriptionResult:
        """Transcribe a short (<25 s) clip (``model.py:126-140``; JAX
        ``model.py:497-518``).  ``beam_size > 1`` decodes with a beam;
        ``lm`` (an ``NGramLM`` or a saved-LM path) adds n-gram shallow
        fusion with weight ``lm_weight`` and per-token insertion bonus
        ``token_bonus``."""
        wav = self.prepare_wav(wav_file)
        if len(wav) > LONGFORM_THRESHOLD_SEC * SAMPLE_RATE:
            raise ValueError(
                "Too long wav file, use 'transcribe_longform' method.")
        text, words = self._decode_batch([wav], word_timestamps,
                                         beam_size=beam_size, lm=lm,
                                         lm_weight=lm_weight,
                                         token_bonus=token_bonus)[0]
        return TranscriptionResult(text=text, words=words)

    def transcribe_longform(
        self, wav_file: Union[str, np.ndarray],
        word_timestamps: bool = False, fr_batch_size: int = 16,
        beam_size: int = 1, bucket: int = BUCKET_SAMPLES, lm=None,
        lm_weight: float = 0.5, token_bonus: float = 0.0, **kwargs,
    ) -> LongformTranscriptionResult:
        """VAD-segmented batched transcription (reference
        ``model.py:195-259``; JAX ``model.py:616-669``).

        ``vad.segment_audio_file`` (``**kwargs`` go to it; a neural VAD
        artifact runs on this model's device) cuts the audio into 15-22 s
        chunks; batches of ``fr_batch_size`` chunks, their rows padded to
        ``fr_batch_size``, go through ``_decode_batch_submit`` with two
        batches in flight: batch i+1 is submitted before batch i is
        finalized.  Word times are shifted by their segment's start."""
        from collections import deque

        from ..vad import segment_audio_file

        with self._device_lock:        # a neural VAD runs on the card
            segments, boundaries = segment_audio_file(
                wav_file, SAMPLE_RATE, device=self.device, **kwargs)
        if not segments:
            return LongformTranscriptionResult(segments=[])

        def submit(i: int):
            return i, self._decode_batch_submit(
                segments[i:i + fr_batch_size], word_timestamps,
                beam_size=beam_size, pad_rows_to=fr_batch_size,
                bucket=bucket, lm=lm, lm_weight=lm_weight,
                token_bonus=token_bonus)

        starts = list(range(0, len(segments), fr_batch_size))
        inflight = deque([submit(starts[0])])
        result: List[Segment] = []
        for k in range(len(starts)):
            if k + 1 < len(starts):
                inflight.append(submit(starts[k + 1]))
            i, finalize = inflight.popleft()
            for j, (text, words) in enumerate(finalize()):
                start, end = boundaries[i + j]
                if word_timestamps:
                    result.append(Segment(
                        text=text, start=start, end=end,
                        words=[w.shifted(start) for w in words or []]))
                else:
                    result.append(Segment(text=text, start=start, end=end))
        return LongformTranscriptionResult(segments=result)

    def align(self, wav_file: Union[str, np.ndarray],
              text: str) -> TranscriptionResult:
        """CTC forced alignment: word timestamps for a KNOWN transcript
        (JAX ``model.py:518-534``), the most probable CTC path that emits
        exactly ``text``; each word's confidence is exp(mean frame
        posterior) over the frames the path spends on it.  CTC models only.
        Raises ``ValueError`` when the transcript cannot fit the audio."""
        return self.align_batch([wav_file], [text])[0]

    @torch.inference_mode()
    def align_batch(self, wav_files: List[Union[str, np.ndarray]],
                    texts: List[str]) -> List[TranscriptionResult]:
        """Batched :meth:`align`: one encoder forward for the batch, then
        the Viterbi DP on the device over all samples, the targets padded
        to a shared bucket (JAX ``model.py:536-614``)."""
        if self.aligner is None:
            raise ValueError("align() requires a CTC model "
                             "(v*_ctc / e2e_ctc); RNNT has no frame-level "
                             "alignment lattice")
        if len(wav_files) != len(texts):
            raise ValueError(f"{len(wav_files)} wavs vs {len(texts)} texts")
        if not wav_files:
            return []
        wavs = [self.prepare_wav(w) for w in wav_files]
        for i, w in enumerate(wavs):
            if len(w) > LONGFORM_THRESHOLD_SEC * SAMPLE_RATE:
                raise ValueError(
                    f"wav {i} too long for align(): VAD-segment it first "
                    "(transcribe_longform covers unknown-transcript audio)")
        # the training pipeline's normalization: char models filter to the
        # vocabulary, SentencePiece models do not
        vocab = (self.cfg.decoding.vocabulary if self.tokenizer.charwise
                 else None)
        ids_list = [self.tokenizer.encode(normalize_text(t, vocab,
                                                         raw_text=True))
                    for t in texts]

        n = len(wavs)
        wavs, pad = self._dp_pad(wavs)
        # this rank's rows (fillers align an empty transcript)
        rows = data_rows(self.mesh, len(wavs))
        ids_mine = (ids_list + [[]] * pad)[rows]
        per_sample = [pad_targets(ids) for ids in ids_mine]
        targets = np.zeros((len(ids_mine),
                            max(t.shape[0] for t in per_sample)), np.int32)
        for i, t in enumerate(per_sample):
            targets[i, :t.shape[0]] = t
        tlens = np.asarray([len(ids) for ids in ids_mine], np.int32)
        with self._device_lock:
            dev_batch, dev_lens, lens, pos = self._device_batch(wavs)
            log_probs, enc_lens = self._ctc_logprobs(dev_batch, dev_lens, pos)
            bp, final_state, scores = self.aligner.align(
                log_probs, enc_lens, _to_device(targets, self.device),
                _to_device(tlens, self.device), self.blank_id)
            wait = _host_copies(bp, final_state, scores, enc_lens, log_probs)
        bp, final_state, scores, enc_lens, log_probs = wait()
        # per row: its result, or (tokens, frames) of a transcript that
        # cannot fit (enc_len 0, a clip shorter than one frontend hop, would
        # read frame 0's alphas: no path exists, whatever the score says)
        out: List[Any] = []
        for i, ids in enumerate(ids_mine):
            enc_len = int(enc_lens[i])
            if not ids:
                out.append(TranscriptionResult(text="", words=[]))
            elif (enc_len <= 0 or not np.isfinite(scores[i])
                    or scores[i] <= -1e29):
                out.append((len(ids), enc_len))
            else:
                frames, logps = backtrack(bp[i], int(final_state[i]), enc_len,
                                          len(ids), log_probs[i], targets[i])
                shift = compute_frame_shift(int(lens[i]), enc_len)
                out.append(TranscriptionResult(
                    text=self.tokenizer.decode(ids),
                    words=frames_to_words(self.tokenizer, ids, frames, shift,
                                          token_logps=logps)))
        out = self._gather(out, n)
        bad = [i for i, r in enumerate(out) if isinstance(r, tuple)]
        if bad:
            raise ValueError(
                f"transcript does not fit the audio for sample(s) {bad}: no "
                f"CTC path emits it within the encoder frames "
                f"({[out[i] for i in bad]} as (tokens, frames))")
        return out


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
        wav = self.prepare_wav(wav_file)
        with self._device_lock:
            dev_batch, dev_lens, _, pos = self._device_batch([wav])
            encoded, enc_lens = self._encode(dev_batch, dev_lens, pos)
            wait = _host_copies(
                heads_lib.emo_probs(self.head, encoded, enc_lens)[0])
        probs = wait()[0]
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
