"""Model export: ``torch.export`` programs saved as ``.pt2`` files (port of
``gigaam_tpu/export.py``).

The counterpart of the reference's ONNX story (``gigaam/model.py:65-71,
151-193``, ``gigaam/onnx_utils.py``), with its artifact decomposition:

* ssl -> one encoder graph, emo -> one probs graph;
* CTC -> one fused graph: features -> (log_probs, encoded_len);
* RNNT -> the encoder graph and, per batch, a ``decoder`` step (labels, h,
  c) -> (pred, h', c') and a ``joint`` step (enc_t, pred) -> log-probs, so
  that a serving runtime can drive the label loop.

Every graph is exported per padded-shape bucket (batch x seconds; the JAX
package's static shapes), with ``torch.export.export`` (non-strict), and
written with ``torch.export.save`` next to ``export_manifest.json`` and the
config JSON (the JAX manifest's keys and files; a SentencePiece model is
bundled as ``tokenizer.model`` with a relative path).

What becomes of the hand-written kernels: the attention goes through the
``torch.library`` ops of ``ops/custom_ops.py`` (K1 at batch >= 2 and K2 at
batch 1 up to T' 3000, K3 past it, K5 for the rel-pos encoder), which the
program keeps as single nodes; the dispatch is fixed per bucket by its
shape, as in the live encoder.  The folded weights that K1/K2 read are
prepared once at export and held as the graph's own buffers (the live
layers' cache and its ``data_ptr`` stamp are bypassed); the attention
projections they replace, and for K1 the LayerNorm they absorb, are left
out of the graph.  The positional tables enter as buffers per bucket (the
JAX graphs close over them).  Each graph embeds its weights.

``load_exported`` imports ``ops/custom_ops.py`` (which registers the ops)
and no model module; a program exported on one device loads onto the
device it is asked for (``torch.export.passes.move_to_device_pass``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from .config import CTCHeadConfig, EmoHeadConfig, ModelConfig, RNNTHeadConfig
from .frontend import num_frames
from .ops import custom_ops  # noqa: F401  (registers the gigaam ops)
from .ops.conformer_ops import static_subsampled_length
from .ops.fused_attention import FoldedWeights
from .ops.precision import full_fp32

_FOLDED = tuple(f.name for f in dataclasses.fields(FoldedWeights))


class _EncoderGraph(nn.Module):
    """features [B, T_feat, F] fp32 and lengths [B] int32 -> the bucket's
    outputs: (log_probs, enc_lens) for ``ctc``, probs for ``probs``,
    (encoded fp32, enc_lens) for ``encoder``.  Holds the encoder weights
    this bucket's path reads, the head's, the folded weights as buffers
    (when the path folds) and the positional tables."""

    def __init__(self, model, batch: int, t_feat: int, kind: str):
        super().__init__()
        from .models.encoder import _LNRES_MIN_BATCH, _MAX_FOLD_T
        from .ops.fused_attention import prepare_folded_weights

        if model.encoder.tp_group is not None:
            raise ValueError("a tensor-parallel shard does not export: "
                             "gather the model first (save_model, then "
                             "load_model)")
        cfg = model.cfg.encoder
        self.cfg, self.kind = cfg, kind
        self.tp_group = None         # conformer_forward's: one process
        self.compute_dtype = model.compute_dtype
        self.use_fused = model.use_fused_attention
        t_sub = static_subsampled_length(t_feat, cfg.num_subsampling_stages,
                                         cfg.subs_kernel_size)
        self.rotary = cfg.self_attention_model == "rotary"
        self.fold = self.rotary and self.use_fused and t_sub <= _MAX_FOLD_T
        lnres = self.fold and batch >= _LNRES_MIN_BATCH
        # what the folded path does not read stays out of the graph
        drop = (({"self_attn", "norm_self_att"} if lnres else {"self_attn"})
                if self.fold else set())
        names = [n for n in _FOLDED if lnres or not n.startswith("ln_")]
        self.pre_encode = model.encoder.pre_encode
        layers = []
        with torch.no_grad():
            for lp in model.encoder.layers:
                layer = nn.ModuleDict(
                    {k: v for k, v in lp.items() if k not in drop})
                if self.fold:
                    w = prepare_folded_weights(
                        lp["self_attn"], lp["norm_self_att"], cfg.n_heads,
                        self.compute_dtype)
                    for name in names:
                        layer.register_buffer(name, getattr(w, name))
                layers.append(layer)
        self.layers = nn.ModuleList(layers)
        # copies: on the CPU a table is a view of the longer host table,
        # whose storage the saved program would otherwise hold whole
        if self.rotary:
            cos, sin = model.pos_tables.rotary(t_sub, model.device)
            self.register_buffer("pos_cos", cos.clone())
            self.register_buffer("pos_sin", sin.clone())
        else:
            self.register_buffer(
                "pos_rel", model.pos_tables.relpos(t_sub, model.device).clone())
        if kind != "encoder":
            self.head = model.head

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor):
        from .models import heads as heads_lib
        from .models.encoder import conformer_forward

        pos = (self.pos_cos, self.pos_sin) if self.rotary else self.pos_rel
        folded = None
        if self.fold:
            folded = [FoldedWeights(**{n: getattr(layer, n, None)
                                       for n in _FOLDED})
                      for layer in self.layers]
        enc, enc_lens, _ = conformer_forward(
            self, feats, lengths, self.cfg, pos, self.compute_dtype,
            use_fused=self.use_fused, folded=folded)
        if self.kind == "ctc":
            return heads_lib.ctc_log_probs(self.head, enc), enc_lens
        if self.kind == "probs":
            return heads_lib.emo_probs(self.head, enc, enc_lens)
        return enc.float(), enc_lens


class _DecoderStep(nn.Module):
    """RNNT prediction step: labels [B] int32, h/c [L, B, H] fp32 ->
    (pred [B, H], h', c')."""

    def __init__(self, head):
        super().__init__()
        self.decoder = head["decoder"]

    def forward(self, labels, h, c):
        from .models.heads import rnnt_predict_step

        return rnnt_predict_step({"decoder": self.decoder}, labels, h, c)


class _JointStep(nn.Module):
    """RNNT joint step: enc_t [B, D], pred [B, H] fp32 -> log-probs [B, V]
    (the encoder frame projected here, per step, as in the JAX graph)."""

    def __init__(self, head):
        super().__init__()
        self.joint = head["joint"]

    def forward(self, enc_t, pred):
        from .models.heads import rnnt_joint_step

        return rnnt_joint_step({"joint": self.joint}, enc_t, pred)


def _save(module: nn.Module, args: Tuple[torch.Tensor, ...],
          path: str) -> None:
    program = torch.export.export(module, args)
    # the archive stores storages: a tensor that is a view into a larger
    # one (the weights bridge slices stacked JAX leaves) would load as the
    # wrong slice, so each such tensor is saved as a copy of its own
    state = program.state_dict
    for key, t in state.items():
        if (t.storage_offset() or t.untyped_storage().nbytes()
                != t.numel() * t.element_size()):
            copy = t.detach().clone()
            state[key] = (nn.Parameter(copy, requires_grad=False)
                          if isinstance(t, nn.Parameter) else copy)
    torch.export.save(program, path)


def export_model(
    model,
    out_dir: str,
    batch_sizes: Sequence[int] = (1, 8),
    audio_seconds: Sequence[int] = (5, 10, 20),
) -> Dict[str, Any]:
    """Export a model's serving graphs for a set of shape buckets.

    Graph inputs are *features* [B, T_feat, F] fp32 + lengths [B] int32
    (time-major), the contract of the reference's exported encoders
    (``encoder.py:597-603``); the frontend runs outside the graph
    (``exported_infer``).  Traced outside ``inference_mode``, on the
    model's device, in its compute dtype.  Returns the manifest."""
    os.makedirs(out_dir, exist_ok=True)
    cfg = model.cfg
    name = cfg.model_name
    dev = model.device
    manifest: Dict[str, Any] = {
        "model_name": name,
        "model_class": cfg.model_class,
        "graphs": {},
    }
    t_feats = sorted({
        num_frames(s * cfg.preprocessor.sample_rate, cfg.preprocessor)
        for s in audio_seconds
    })
    head = getattr(cfg, "head", None)
    kind = ("ctc" if isinstance(head, CTCHeadConfig)
            else "probs" if isinstance(head, EmoHeadConfig) else "encoder")

    def write(fname: str, module: nn.Module, args, meta: Dict[str, Any]):
        _save(module, args, os.path.join(out_dir, fname))
        manifest["graphs"].setdefault(meta.pop("graph"), []).append(
            dict(meta, file=fname))

    with torch.inference_mode(False):
        for b in batch_sizes:
            for t_feat in t_feats:
                t_sub = static_subsampled_length(
                    t_feat, cfg.encoder.num_subsampling_stages,
                    cfg.encoder.subs_kernel_size)
                feats = torch.zeros((b, t_feat, cfg.preprocessor.features),
                                    device=dev)
                lengths = torch.full((b,), t_feat, dtype=torch.int32,
                                     device=dev)
                write(f"{name}_{kind}_b{b}_t{t_feat}.pt2",
                      _EncoderGraph(model, b, t_feat, kind), (feats, lengths),
                      {"graph": kind, "batch": b, "t_feat": t_feat,
                       "t_sub": t_sub})

        if isinstance(head, RNNTHeadConfig):
            dec_cfg = head.decoder
            for b in batch_sizes:
                labels = torch.zeros((b,), dtype=torch.int32, device=dev)
                # h and c as two tensors: inputs that alias one another
                # would be traced as one
                h, c = (torch.zeros((dec_cfg.pred_rnn_layers, b,
                                     dec_cfg.pred_hidden), device=dev)
                        for _ in range(2))
                write(f"{name}_decoder_b{b}.pt2", _DecoderStep(model.head),
                      (labels, h, c), {"graph": "decoder", "batch": b})
                enc_t = torch.zeros((b, head.joint.enc_hidden), device=dev)
                pred = torch.zeros((b, head.joint.pred_hidden), device=dev)
                write(f"{name}_joint_b{b}.pt2", _JointStep(model.head),
                      (enc_t, pred), {"graph": "joint", "batch": b})

    # self-contained artifacts: bundle the sentencepiece model (if any) and
    # store its path relative to the artifact dir
    if (getattr(cfg, "decoding", None) is not None
            and cfg.decoding.model_path):
        shutil.copyfile(cfg.decoding.model_path,
                        os.path.join(out_dir, "tokenizer.model"))
        cfg = dataclasses.replace(
            cfg, decoding=dataclasses.replace(
                cfg.decoding, model_path="tokenizer.model"))

    with open(os.path.join(out_dir, "export_manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        f.write(cfg.to_json())
    return manifest


def _resolve_device(device: Optional[Union[str, torch.device]]
                    ) -> torch.device:
    """``None`` means the card, as for the models: raise rather than fall
    back to the CPU.  A bare ``cuda`` names the current card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class ExportedGraph:
    """A loaded ``torch.export`` program on ``device``, callable with
    tensors or numpy arrays (moved to its device); returns what the program
    returns, on its device.  The RNNT ``decoder`` and ``joint`` programs run
    under ``full_fp32`` (TF32 off): a flag set at trace time is not part of
    the graph."""

    def __init__(self, path: str, meta: Dict[str, Any], kind: str = "",
                 device: Optional[Union[str, torch.device]] = None):
        program = torch.export.load(path)
        here = next(iter(program.state_dict.values())).device
        self.device = here if device is None else _resolve_device(device)
        if self.device != here:
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, self.device)
        self._module = program.module()
        self.meta = meta
        self.fp32 = kind in ("decoder", "joint")

    def __call__(self, *args):
        args = tuple((a if isinstance(a, torch.Tensor)
                      else torch.from_numpy(np.asarray(a))).to(self.device)
                     for a in args)
        if self.fp32:
            with full_fp32():
                return self._module(*args)
        return self._module(*args)


def load_exported(out_dir: str,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> Tuple[ModelConfig, Dict[str, List[ExportedGraph]]]:
    """Load an exported artifact dir onto ``device`` (None: the card) ->
    (config, {graph_kind: [graphs]})."""
    device = _resolve_device(device)
    with open(os.path.join(out_dir, "export_manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(out_dir, f"{manifest['model_name']}.json")) as f:
        cfg = ModelConfig.from_dict(json.load(f))
    # bundled tokenizer paths are relative to the artifact dir
    if (getattr(cfg, "decoding", None) is not None and cfg.decoding.model_path
            and not os.path.isabs(cfg.decoding.model_path)):
        cfg = dataclasses.replace(
            cfg, decoding=dataclasses.replace(
                cfg.decoding,
                model_path=os.path.join(out_dir, cfg.decoding.model_path)))
    graphs: Dict[str, List[ExportedGraph]] = {}
    for kind, entries in manifest["graphs"].items():
        graphs[kind] = [
            ExportedGraph(os.path.join(out_dir, e["file"]), e, kind, device)
            for e in entries
        ]
    return cfg, graphs
