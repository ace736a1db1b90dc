"""Batch inference driven purely by exported ``torch.export`` artifacts (port
of ``gigaam_tpu/exported_infer.py``).

The analogue of the reference's onnxruntime path
(``gigaam/onnx_utils.py:164-331``): restore the serving graphs with
``load_exported`` and run a dataset through them with no model code on the
hot path: the port's ``LogMelFrontend`` on the graphs' device -> the exported
encoder/CTC graph -> host greedy CTC, or the RNNT label loop driven through
the exported ``decoder``/``joint`` graphs.  If ``infer_exported`` can
transcribe, the artifact dir is self-contained.

* CTC: one fused graph emits log-probs; the greedy dedup runs on host
  numpy (reference ``_decode_ctc_batch``, ``onnx_utils.py:39-54``).
* RNNT: frame-synchronous greedy over the ``decoder``/``joint`` graphs
  with the model's own ``max_symbols_per_step`` (as the JAX runner,
  ``gigaam_tpu/exported_infer.py:198-205``).  The labels and the LSTM state
  stay on the device; the host reads one flag per step (whether any row
  emitted) and copies the steps' emissions once at the end.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import SAMPLE_RATE, ModelConfig
from .decode.tokenizer import Tokenizer
from .export import ExportedGraph, _resolve_device, load_exported
from .frontend import LogMelFrontend, num_frames

MAX_LETTERS_PER_FRAME = 3  # reference gigaam/onnx_utils.py:19


def _decode_ctc_batch(
    log_probs: np.ndarray, lengths: np.ndarray, tokenizer: Tokenizer
) -> List[str]:
    """Greedy CTC on host numpy (reference ``onnx_utils.py:39-54``)."""
    blank = log_probs.shape[-1] - 1
    labels = log_probs.argmax(axis=-1)  # [B, T]
    texts = []
    for b in range(labels.shape[0]):
        row = labels[b, : int(lengths[b])]
        prev = np.concatenate([[-1], row[:-1]])
        ids = row[(row != blank) & (row != prev)]
        texts.append(tokenizer.decode(ids.tolist()))
    return texts


def _rnnt_label_loop(
    encoded: torch.Tensor,
    enc_lens: np.ndarray,
    decoder: ExportedGraph,
    joint: ExportedGraph,
    blank: int,
    state_shape: Tuple[int, int, int],
    max_letters: int = MAX_LETTERS_PER_FRAME,
) -> List[Tuple[List[int], List[int]]]:
    """Frame-synchronized greedy label loop over exported decoder/joint
    graphs (reference ``onnx_utils.py:73-161``) -> per row (token ids,
    their frames).

    ``encoded`` [B, T, D] fp32 on the graphs' device, already padded to the
    decoder graph's batch; ``enc_lens`` [B] on the host.  The predictor's
    zero state + blank label reproduces torch's ``predict(None, None)``
    start (the blank embedding row is zero).  Per step the host reads one
    flag, whether any row emitted; the emissions ([steps, B] labels and
    masks) come to the host once, after the loop."""
    b = encoded.shape[0]
    dev = encoded.device
    labels = torch.full((b,), blank, dtype=torch.int32, device=dev)
    h = torch.zeros(state_shape, dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    lens = torch.from_numpy(np.asarray(enc_lens, np.int64)).to(dev)
    steps: List[Tuple[int, torch.Tensor, torch.Tensor]] = []

    for t in range(int(np.max(enc_lens, initial=0))):
        enc_t = encoded[:, t, :].contiguous()
        emitting = lens > t
        for _ in range(max_letters):
            pred, h_new, c_new = decoder(labels, h, c)
            k = joint(enc_t, pred).argmax(dim=-1).to(torch.int32)
            emit = emitting & (k != blank)
            steps.append((t, emit, k))
            if not bool(emit.any()):
                break
            # predictor state/label advance only on emission
            labels = torch.where(emit, k, labels)
            m = emit[None, :, None]
            h = torch.where(m, h_new, h)
            c = torch.where(m, c_new, c)
            emitting = emit
    out: List[Tuple[List[int], List[int]]] = [([], []) for _ in range(b)]
    if steps:
        emits = torch.stack([e for _, e, _ in steps]).cpu().numpy()
        ks = torch.stack([k for _, _, k in steps]).cpu().numpy()
        for s, (t, _, _) in enumerate(steps):
            for i in np.nonzero(emits[s])[0]:
                out[i][0].append(int(ks[s, i]))
                out[i][1].append(t)
    return out


def _decode_rnnt_batch(
    encoded: torch.Tensor,
    enc_lens: np.ndarray,
    decoder: ExportedGraph,
    joint: ExportedGraph,
    tokenizer: Tokenizer,
    state_shape: Tuple[int, int, int],
    max_letters: int = MAX_LETTERS_PER_FRAME,
) -> List[str]:
    """Texts of ``_rnnt_label_loop`` (the blank is ``len(tokenizer)``)."""
    return [tokenizer.decode(ids) for ids, _ in _rnnt_label_loop(
        encoded, enc_lens, decoder, joint, len(tokenizer), state_shape,
        max_letters)]


def _pick_graph(graphs: Sequence[ExportedGraph], n: int,
                t_feat: int) -> ExportedGraph:
    """Smallest exported bucket that fits (batch n, t_feat frames)."""
    fitting = [g for g in graphs
               if g.meta["batch"] >= n and g.meta["t_feat"] >= t_feat]
    if not fitting:
        raise ValueError(
            f"no exported bucket fits batch={n}, t_feat={t_feat}; "
            f"available: {[(g.meta['batch'], g.meta['t_feat']) for g in graphs]}")
    return min(fitting, key=lambda g: (g.meta["t_feat"], g.meta["batch"]))


def _pick_graph_by_batch(graphs: Sequence[ExportedGraph],
                         n: int) -> ExportedGraph:
    fitting = [g for g in graphs if g.meta["batch"] >= n]
    if not fitting:
        raise ValueError(f"no exported graph with batch >= {n}")
    return min(fitting, key=lambda g: g.meta["batch"])


def _pad_batch_dim(x: Union[np.ndarray, torch.Tensor], b: int):
    """Zero rows appended up to ``b`` (numpy array or tensor)."""
    if x.shape[0] == b:
        return x
    if isinstance(x, torch.Tensor):
        out = x.new_zeros((b,) + tuple(x.shape[1:]))
    else:
        out = np.zeros((b,) + x.shape[1:], x.dtype)
    out[: x.shape[0]] = x
    return out


class _ExportedBase:
    """Shared frontend/bucketing over an exported artifact dir, on
    ``device`` (None: the card)."""

    def __init__(self, artifact_dir: str,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = _resolve_device(device)
        self.cfg: ModelConfig
        self.cfg, self.graphs = load_exported(artifact_dir, self.device)
        self.frontend = LogMelFrontend(self.cfg.preprocessor).to(self.device)

    @torch.inference_mode()
    def _bucketed(self, kind: str, wavs: List[np.ndarray]):
        """The graph of the smallest bucket that fits the batch (its audio
        padded to 1 s, as the live model pads it), and the log-mel features
        [gb, t_feat, F] and lengths of the batch padded to that bucket's
        rows and samples, on the device.  The frontend sees what the live
        ``_decode_batch(..., pad_rows_to=gb, bucket=<the bucket's
        seconds>)`` gives it, so that both encoders get the same features."""
        from .native import collate

        pre = self.cfg.preprocessor
        n = len(wavs)
        lens = np.zeros((n,), np.int32)
        lens[:] = [len(w) for w in wavs]
        top = max(SAMPLE_RATE, -(-int(lens.max()) // SAMPLE_RATE)
                  * SAMPLE_RATE)
        g = _pick_graph(self.graphs[kind], n, num_frames(top, pre))
        gb, gt = g.meta["batch"], g.meta["t_feat"]
        batch = np.zeros((gb, _bucket_samples(gt, pre)), np.float32)
        batch[:n] = collate(wavs, batch.shape[1])
        feats, feat_lens = self.frontend(
            torch.from_numpy(batch).to(self.device),
            torch.from_numpy(_pad_batch_dim(lens, gb)).to(self.device))
        return g, feats.transpose(1, 2), feat_lens


def _bucket_samples(t_feat: int, pre) -> int:
    """The fewest samples that give ``t_feat`` frames (``num_frames``)."""
    if pre.center:
        return (t_feat - 1) * pre.hop_length
    return (t_feat - 1) * pre.hop_length + max(pre.n_fft, pre.win_length)


class ExportedClassifier(_ExportedBase):
    """Emo probs / SSL embeddings from artifacts alone (the reference's
    non-ASR ``infer_onnx`` families, ``gigaam/onnx_utils.py:204-242``)."""

    @torch.inference_mode()
    def infer_batch(self, wavs: List[np.ndarray]) -> List[np.ndarray]:
        n = len(wavs)
        kind = "probs" if "probs" in self.graphs else "encoder"
        g, pad, pad_lens = self._bucketed(kind, wavs)
        if kind == "probs":  # emo: [B, n_classes]
            probs = g(pad, pad_lens).cpu().numpy()
            return [probs[i] for i in range(n)]
        encoded, enc_lens = (x.cpu().numpy() for x in g(pad, pad_lens))
        # ssl embeddings, time-major [T', D] per item; copied so a kept
        # embedding doesn't pin the whole padded [gb, T', D] batch buffer
        return [encoded[i, : int(enc_lens[i])].copy() for i in range(n)]


class ExportedASR(_ExportedBase):
    """Callable ASR over an exported artifact dir (no model params/code)."""

    def __init__(self, artifact_dir: str,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(artifact_dir, device)
        dec = self.cfg.decoding
        assert dec is not None, "exported artifact has no decoding config"
        self.tokenizer = Tokenizer(dec.vocabulary or [], dec.model_path)
        self.is_ctc = "ctc" in self.graphs

    @torch.inference_mode()
    def transcribe_batch(self, wavs: List[np.ndarray]) -> List[str]:
        n = len(wavs)
        kind = "ctc" if self.is_ctc else "encoder"
        g, pad, pad_lens = self._bucketed(kind, wavs)
        gb = g.meta["batch"]

        if self.is_ctc:
            log_probs, enc_lens = (x.cpu().numpy() for x in g(pad, pad_lens))
            return _decode_ctc_batch(log_probs[:n], enc_lens[:n],
                                     self.tokenizer)

        encoded, enc_lens = g(pad, pad_lens)
        enc_lens = enc_lens.cpu().numpy().astype(np.int32)
        dec_g = _pick_graph_by_batch(self.graphs["decoder"], gb)
        joint_g = _pick_graph_by_batch(self.graphs["joint"], gb)
        db = dec_g.meta["batch"]
        if db != gb:  # decoder bucket batch may differ from encoder's
            encoded = _pad_batch_dim(encoded, db)
            enc_lens = _pad_batch_dim(enc_lens, db)
        head = self.cfg.head
        state_shape = (head.decoder.pred_rnn_layers, db,
                       head.decoder.pred_hidden)
        enc_lens[n:] = 0  # padding rows decode nothing
        # the model's own per-frame symbol cap, so that artifact-only
        # decoding follows the live decoder (the reference's ONNX path pins
        # MAX_LETTERS_PER_FRAME=3, ``onnx_utils.py:19``)
        max_letters = self.cfg.decoding.max_symbols_per_step
        texts = _decode_rnnt_batch(encoded.float(), enc_lens, dec_g, joint_g,
                                   self.tokenizer, state_shape, max_letters)
        return texts[:n]


def infer_exported(
    artifact_dir: str,
    items: Sequence,
    batch_size: int = 8,
    refs: Optional[List[str]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, object]:
    """Transcribe ``items`` (paths or float arrays) with exported graphs
    only, on ``device`` (None: the card).

    Mirrors the reference's ``infer_onnx`` dataset loop
    (``onnx_utils.py:164-279``): batches items, returns hypotheses and,
    when references are given, the dual WER metric."""
    import json
    import os
    import warnings

    from .audio import load_audio

    # only the manifest is needed to pick the family
    with open(os.path.join(artifact_dir, "export_manifest.json")) as f:
        model_class = json.load(f).get("model_class", "asr")

    def _load(it) -> np.ndarray:
        return it if isinstance(it, np.ndarray) else load_audio(str(it))

    runner = (ExportedClassifier(artifact_dir, device)
              if model_class in ("ssl", "emo")
              else ExportedASR(artifact_dir, device))
    # clamp to the largest exported row bucket: chunking at a smaller batch
    # keeps every item (unlike truncation) and still fails loudly inside
    # _pick_graph if no bucket exists at all
    kind = ("ctc" if "ctc" in runner.graphs
            else "probs" if "probs" in runner.graphs else "encoder")
    max_rows = max(g.meta["batch"] for g in runner.graphs[kind])
    if batch_size > max_rows:
        warnings.warn(f"batch_size={batch_size} exceeds the largest "
                      f"exported bucket ({max_rows}); running at {max_rows}")
        batch_size = max_rows

    results: List = []
    # audio decodes per mini-batch: loading the whole dataset up front would
    # hold hours of float32 audio in RAM before the first batch runs
    for i in range(0, len(items), batch_size):
        wavs = [_load(it) for it in items[i: i + batch_size]]
        if isinstance(runner, ExportedClassifier):
            results.extend(runner.infer_batch(wavs))
        else:
            results.extend(runner.transcribe_batch(wavs))
    if isinstance(runner, ExportedClassifier):
        return {"hypotheses": results}
    hyps: List[str] = results
    out: Dict[str, object] = {"hypotheses": hyps}
    if refs is not None:
        from .metrics import compute_wer

        wer_e2e, wer_raw = compute_wer(hyps, list(refs))
        out.update(wer_e2e=wer_e2e, wer_raw=wer_raw)
    return out
