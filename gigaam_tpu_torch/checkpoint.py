"""Reference-checkpoint ingestion: a reference torch ``.ckpt`` -> the
``ModelConfig`` and the JAX-layout parameter tree, as numpy (port of
``gigaam_tpu/checkpoint.py``).

The reference stores ``{"cfg": OmegaConf DictConfig, "state_dict": ...}``
(``gigaam/__init__.py:167,185``).  This module:

* unpickles such checkpoints **without** omegaconf or hydra installed
  (stub classes capture the pickled state; ``_content`` trees are
  unwrapped, ``${...}`` interpolations resolved);
* translates the cfg into the typed ``ModelConfig``;
* maps every reference parameter onto the JAX package's layout, exactly the
  tree its converter builds but with numpy leaves, so that one bridge
  (``weights.params_from_jax``) serves both the ``save_model`` artifacts and
  the reference checkpoints.

Layout mapping (reference -> JAX layout):
  Linear            w [out, in]           -> [in, out] (transpose)
  Conv1d (subsamp)  w [Cout, Cin, K]      -> [K, Cin, Cout]
  Conv2d (subsamp)  w [Cout, Cin, Kh, Kw] -> [Kh, Kw, Cin, Cout]
  pointwise Conv1d  w [Cout, Cin, 1]      -> [Cin, Cout]; the GLU's
                    [2C, C, 1] split into value and gate leaves
  depthwise Conv1d  w [C, 1, K]           -> [K, 1, C]
  LSTM              weight_ih/hh [4H, in] -> [in, 4H]; b = b_ih + b_hh
  BatchNorm         weight/bias/running_mean/running_var ->
                    scale/bias/mean/var
Per-layer leaves are stacked on a leading layer axis.  Every leaf is a
C-contiguous float32 array.

``reference_cfg`` and ``reference_state_dict`` are the inverse: they write a
model's config and JAX-layout tree back into the reference's layout.
"""

from __future__ import annotations

import re
import sys
import types
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .config import (
    CTCHeadConfig,
    DecodingConfig,
    EmoHeadConfig,
    EncoderConfig,
    FeaturesConfig,
    ModelConfig,
    RNNTDecoderConfig,
    RNNTHeadConfig,
    RNNTJointConfig,
)

Tree = Dict[str, Any]


# ---------------------------------------------------------------------------
# Torch checkpoint loading without omegaconf/hydra
# ---------------------------------------------------------------------------

class _StubObject:
    """Catch-all unpickle target: records ctor args and state."""

    def __init__(self, *args, **kwargs):
        self._args = args
        self._kwargs = kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state

    def __call__(self, *args, **kwargs):  # some reduces call the object
        return self


_STUB_MODULES = ("omegaconf", "omegaconf.dictconfig", "omegaconf.listconfig",
                 "omegaconf.base", "omegaconf.nodes")


def _install_stub_modules() -> List[str]:
    """Register stub modules for the pickle targets that are not importable;
    returns the names registered, for the caller to remove."""
    created = []
    for name in _STUB_MODULES:
        if name not in sys.modules:
            mod = types.ModuleType(name)
            mod.__getattr__ = lambda attr: _StubObject  # type: ignore
            sys.modules[name] = mod
            created.append(name)
    return created


def _unwrap(node: Any) -> Any:
    """Stubbed (or real) OmegaConf containers -> plain dicts and lists.

    Value nodes carry their payload in ``_val`` (checked first: they never
    have ``_content``), containers in ``_content``; ``_parent``
    back-references are never followed.  When omegaconf is importable the
    nodes are its real classes, so this duck-types on those two names."""
    d = getattr(node, "__dict__", None) if not isinstance(node, dict) else None
    if isinstance(node, _StubObject) or (
            isinstance(d, dict) and ("_val" in d or "_content" in d)):
        if "_val" in d:
            return _unwrap(d["_val"])
        content = d.get("_content", d.get("_state"))
        if content is None and d.get("_args"):
            content = d["_args"][0]
        return _unwrap(content)
    if isinstance(node, dict):
        # keep hydra's "_target_" (``_head_kind`` reads it), drop the other
        # OmegaConf bookkeeping keys
        return {k: _unwrap(v) for k, v in node.items()
                if k == "_target_" or not str(k).startswith("_")}
    if isinstance(node, (list, tuple)):
        return [_unwrap(v) for v in node]
    if hasattr(node, "_val"):
        return _unwrap(node._val)
    return node


_INTERP_RE = re.compile(r"\$\{([A-Za-z0-9_.]+)\}")


def _resolve_interpolations(tree: Any) -> Any:
    """Resolve OmegaConf ``${dotted.path}`` interpolations in an unwrapped
    cfg tree, in place.

    A pickled cfg carries them unresolved (OmegaConf resolves at access
    time).  Absolute dotted paths, whole-value (the referenced value keeps
    its type) or inside a string; unknown paths stay verbatim; chained
    references resolve by a bounded fixpoint."""
    def lookup(path: str):
        cur = tree
        for part in path.split("."):
            if isinstance(cur, dict) and part in cur:
                cur = cur[part]
            elif (isinstance(cur, list) and part.isdigit()
                  and int(part) < len(cur)):
                cur = cur[int(part)]
            else:
                return None, False
        return cur, True

    def subst(val):
        if not isinstance(val, str):
            return val, False
        m = _INTERP_RE.fullmatch(val)
        if m:
            target, ok = lookup(m.group(1))
            return (target, True) if ok else (val, False)
        changed = False

        def repl(mm):
            nonlocal changed
            target, ok = lookup(mm.group(1))
            if ok and not isinstance(target, (dict, list)):
                changed = True
                return str(target)
            return mm.group(0)

        return _INTERP_RE.sub(repl, val), changed

    def walk(node) -> bool:
        changed = False
        items = (node.items() if isinstance(node, dict)
                 else enumerate(node) if isinstance(node, list) else ())
        for k, v in list(items):
            if isinstance(v, (dict, list)):
                changed |= walk(v)
            else:
                nv, ch = subst(v)
                if ch:
                    node[k] = nv
                    changed = True
        return changed

    for _ in range(8):
        if not walk(tree):
            break
    return tree


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """``torch.load`` a reference checkpoint on the CPU, with omegaconf
    stubbed where it is not installed.  ``weights_only=False`` is explicit:
    PyTorch's default since 2.6 refuses the OmegaConf globals.  Unpickling
    can run code: load only checkpoints from a source you trust."""
    import torch

    created = _install_stub_modules()
    try:
        with open(path, "rb") as f:
            return torch.load(f, map_location="cpu", weights_only=False)
    finally:
        for name in created:
            sys.modules.pop(name, None)


def state_dict_to_numpy(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        if hasattr(v, "detach"):
            out[k] = v.detach().to("cpu").float().numpy()
        else:
            out[k] = np.asarray(v, dtype=np.float32)
    return out


# ---------------------------------------------------------------------------
# Config translation
# ---------------------------------------------------------------------------

def _head_kind(head_cfg: Dict[str, Any]) -> str:
    target = str(head_cfg.get("_target_", ""))
    if "CTCHead" in target:
        return "ctc"
    if "RNNTHead" in target:
        return "rnnt"
    if "decoder" in head_cfg and "joint" in head_cfg:
        return "rnnt"
    if "num_classes" in head_cfg and "feat_in" in head_cfg:
        return "ctc"
    return "emo"


def config_from_reference(cfg: Dict[str, Any], model_name: str) -> ModelConfig:
    """An unwrapped, resolved reference cfg tree -> ``ModelConfig``."""
    pre = cfg.get("preprocessor", {}) or {}
    sr = int(pre.get("sample_rate", 16000))
    feats = FeaturesConfig(
        sample_rate=sr,
        features=int(pre.get("features", 64)),
        win_length=int(pre.get("win_length", sr // 40)),
        hop_length=int(pre.get("hop_length", sr // 100)),
        n_fft=int(pre.get("n_fft", sr // 40)),
        center=bool(pre.get("center", True)),
        dither=float(pre.get("dither", 0.0) or 0.0),
    )
    e = cfg.get("encoder", {}) or {}
    enc = EncoderConfig(
        feat_in=int(e.get("feat_in", 64)),
        n_layers=int(e.get("n_layers", 16)),
        d_model=int(e.get("d_model", 768)),
        subsampling=str(e.get("subsampling", "conv2d")),
        subs_kernel_size=int(e.get("subs_kernel_size", 3)),
        subsampling_factor=int(e.get("subsampling_factor", 4)),
        ff_expansion_factor=int(e.get("ff_expansion_factor", 4)),
        self_attention_model=str(e.get("self_attention_model", "rotary")),
        n_heads=int(e.get("n_heads", 16)),
        pos_emb_max_len=int(e.get("pos_emb_max_len", 5000)),
        conv_norm_type=str(e.get("conv_norm_type", "batch_norm")),
        conv_kernel_size=int(e.get("conv_kernel_size", 31)),
    )

    head_cfg = cfg.get("head")
    dec_cfg = cfg.get("decoding")
    head: Any = None
    decoding: Optional[DecodingConfig] = None
    model_class = "ssl"
    if head_cfg:
        kind = _head_kind(head_cfg)
        if kind == "ctc":
            model_class = "asr"
            head = CTCHeadConfig(
                feat_in=int(head_cfg.get("feat_in", enc.d_model)),
                num_classes=int(head_cfg["num_classes"]))
        elif kind == "rnnt":
            model_class = "asr"
            d = head_cfg.get("decoder", {})
            j = head_cfg.get("joint", {})
            head = RNNTHeadConfig(
                decoder=RNNTDecoderConfig(
                    pred_hidden=int(d.get("pred_hidden", 320)),
                    pred_rnn_layers=int(d.get("pred_rnn_layers", 1)),
                    num_classes=int(d["num_classes"])),
                joint=RNNTJointConfig(
                    enc_hidden=int(j.get("enc_hidden", enc.d_model)),
                    pred_hidden=int(j.get("pred_hidden", 320)),
                    joint_hidden=int(j.get("joint_hidden", 320)),
                    num_classes=int(j["num_classes"])))
        else:
            model_class = "emo"
            head = EmoHeadConfig(
                feat_in=int(head_cfg.get(
                    "in_features", head_cfg.get("feat_in", enc.d_model))),
                num_classes=int(head_cfg.get("out_features",
                                             head_cfg.get("num_classes", 4))))

    if dec_cfg:
        decoding = DecodingConfig(
            kind=("rnnt_greedy" if isinstance(head, RNNTHeadConfig)
                  else "ctc_greedy"),
            vocabulary=[str(v) for v in dec_cfg.get("vocabulary") or []],
            model_path=dec_cfg.get("model_path"),
            max_symbols_per_step=int(
                dec_cfg.get("max_symbols_per_step", 10)))

    id2name = cfg.get("id2name")
    if isinstance(id2name, dict):
        # numeric order: a lexicographic sort puts '10' before '2'
        id2name = [id2name[k] for k in sorted(id2name, key=lambda k: int(k))]

    return ModelConfig(
        model_name=model_name, model_class=model_class,
        preprocessor=feats, encoder=enc, head=head, decoding=decoding,
        id2name=id2name)


# ---------------------------------------------------------------------------
# State-dict mapping
# ---------------------------------------------------------------------------

def _convert_subsampling(sd: Dict[str, np.ndarray], enc: EncoderConfig,
                         prefix: str) -> Tree:
    out: Tree = {}
    # the reference Sequential interleaves ReLU: convs sit at 0, 2, 4 ...
    for i in range(enc.num_subsampling_stages):
        w = sd[f"{prefix}conv.{2 * i}.weight"]
        b = sd[f"{prefix}conv.{2 * i}.bias"]
        if enc.subsampling == "conv2d":
            out[f"conv_{i}"] = {"w": w.transpose(2, 3, 1, 0), "b": b}
        else:
            out[f"conv_{i}"] = {"w": w.transpose(2, 1, 0), "b": b}
    if enc.subsampling == "conv2d":
        out["out"] = {"w": sd[f"{prefix}out.weight"].T,
                      "b": sd[f"{prefix}out.bias"]}
    return out


def _linear(sd, name) -> Dict[str, np.ndarray]:
    p = {"w": sd[f"{name}.weight"].T}
    if f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _norm(sd, name) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _convert_layer(sd: Dict[str, np.ndarray], enc: EncoderConfig,
                   prefix: str) -> Tree:
    attn: Tree = {name: _linear(sd, f"{prefix}self_attn.{name}")
                  for name in ("linear_q", "linear_k", "linear_v",
                               "linear_out")}
    if enc.self_attention_model == "rel_pos":
        attn["linear_pos"] = _linear(sd, f"{prefix}self_attn.linear_pos")
        attn["pos_bias_u"] = sd[f"{prefix}self_attn.pos_bias_u"]
        attn["pos_bias_v"] = sd[f"{prefix}self_attn.pos_bias_v"]

    bn_name = f"{prefix}conv.batch_norm"
    if enc.conv_norm_type == "batch_norm":
        bn = {"scale": sd[f"{bn_name}.weight"], "bias": sd[f"{bn_name}.bias"],
              "mean": sd[f"{bn_name}.running_mean"],
              "var": sd[f"{bn_name}.running_var"]}
    else:
        bn = _norm(sd, bn_name)

    # the GLU projection's value and gate halves are separate leaves
    pc1_w = sd[f"{prefix}conv.pointwise_conv1.weight"][:, :, 0].T
    pc1_b = sd[f"{prefix}conv.pointwise_conv1.bias"]
    half = pc1_w.shape[1] // 2
    conv = {
        "pointwise_conv1": {
            "w_value": pc1_w[:, :half], "b_value": pc1_b[:half],
            "w_gate": pc1_w[:, half:], "b_gate": pc1_b[half:]},
        "depthwise_conv": {
            "w": sd[f"{prefix}conv.depthwise_conv.weight"].transpose(2, 1, 0),
            "b": sd[f"{prefix}conv.depthwise_conv.bias"]},
        "batch_norm": bn,
        "pointwise_conv2": {
            "w": sd[f"{prefix}conv.pointwise_conv2.weight"][:, :, 0].T,
            "b": sd[f"{prefix}conv.pointwise_conv2.bias"]},
    }
    ffn = lambda name: {  # noqa: E731
        "linear1": _linear(sd, f"{prefix}{name}.linear1"),
        "linear2": _linear(sd, f"{prefix}{name}.linear2")}
    return {
        "norm_feed_forward1": _norm(sd, f"{prefix}norm_feed_forward1"),
        "feed_forward1": ffn("feed_forward1"),
        "norm_self_att": _norm(sd, f"{prefix}norm_self_att"),
        "self_attn": attn,
        "norm_conv": _norm(sd, f"{prefix}norm_conv"),
        "conv": conv,
        "norm_feed_forward2": _norm(sd, f"{prefix}norm_feed_forward2"),
        "feed_forward2": ffn("feed_forward2"),
        "norm_out": _norm(sd, f"{prefix}norm_out"),
    }


def _stack(trees: List[Tree]) -> Tree:
    """Per-layer trees of equal structure -> one tree whose leaves are
    stacked on a leading layer axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def convert_encoder(sd: Dict[str, np.ndarray], enc: EncoderConfig,
                    prefix: str = "encoder.") -> Tree:
    return {
        "pre_encode": _convert_subsampling(sd, enc, f"{prefix}pre_encode."),
        "layers": _stack([_convert_layer(sd, enc, f"{prefix}layers.{i}.")
                          for i in range(enc.n_layers)]),
    }


def convert_head(sd: Dict[str, np.ndarray], head: Any,
                 prefix: str = "head.") -> Tree:
    if isinstance(head, CTCHeadConfig):
        w = sd[f"{prefix}decoder_layers.0.weight"][:, :, 0].T
        return {"proj": {"w": w, "b": sd[f"{prefix}decoder_layers.0.bias"]}}
    if isinstance(head, RNNTHeadConfig):
        layers = [{
            "w_ih": sd[f"{prefix}decoder.lstm.weight_ih_l{li}"].T,
            "w_hh": sd[f"{prefix}decoder.lstm.weight_hh_l{li}"].T,
            "b": (sd[f"{prefix}decoder.lstm.bias_ih_l{li}"]
                  + sd[f"{prefix}decoder.lstm.bias_hh_l{li}"]),
        } for li in range(head.decoder.pred_rnn_layers)]
        return {
            "decoder": {"embed": sd[f"{prefix}decoder.embed.weight"],
                        "lstm": layers},
            "joint": {
                "enc": _linear(sd, f"{prefix}joint.enc"),
                "pred": _linear(sd, f"{prefix}joint.pred"),
                "out": _linear(sd, f"{prefix}joint.joint_net.1"),
            },
        }
    if isinstance(head, EmoHeadConfig):
        # a single Linear, under a bare or a nested name
        for cand in (f"{prefix}weight", f"{prefix}linear.weight",
                     f"{prefix}0.weight"):
            if cand in sd:
                base = cand[: -len("weight")]
                return {"proj": {"w": sd[f"{base}weight"].T,
                                 "b": sd[f"{base}bias"]}}
        raise KeyError(f"emo head weights not found under prefix {prefix!r}")
    raise ValueError(f"Unknown head config: {type(head)}")


def _contiguous(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _contiguous(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_contiguous(v) for v in tree]
    return np.ascontiguousarray(tree, dtype=np.float32)


def convert_state_dict(sd: Dict[str, np.ndarray], cfg: ModelConfig) -> Tree:
    """Reference state dict (numpy) -> the JAX-layout tree, numpy leaves:
    the JAX converter's tree before its ``jnp.asarray``."""
    params: Tree = {"encoder": convert_encoder(sd, cfg.encoder)}
    if cfg.head is not None:
        params["head"] = convert_head(sd, cfg.head)
    return _contiguous(params)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def is_lightning_checkpoint(ckpt: Dict[str, Any]) -> bool:
    """A fine-tuned Lightning checkpoint (``gigaam/__init__.py:139-156``)
    carries ``hyper_parameters`` and no ``cfg``."""
    return "hyper_parameters" in ckpt and "cfg" not in ckpt


def convert_reference_checkpoint(
    path: str, model_name: Optional[str] = None,
    ckpt: Optional[Dict[str, Any]] = None,
) -> Tuple[ModelConfig, Tree]:
    """Load and convert a reference ``.ckpt``: (config, JAX-layout numpy
    tree).  ``ckpt`` may carry the already loaded checkpoint, to avoid a
    second deserialization."""
    if ckpt is None:
        ckpt = load_torch_checkpoint(path)
    if is_lightning_checkpoint(ckpt):
        raise ValueError(
            "Fine-tuned Lightning checkpoints need the base model's cfg; "
            "convert the base checkpoint first and use "
            "apply_finetuned_state_dict().")
    cfg_tree = _unwrap(ckpt["cfg"])
    if not isinstance(cfg_tree, dict):
        raise ValueError(f"Could not unwrap checkpoint cfg from {path}")
    cfg_tree = _resolve_interpolations(cfg_tree)
    name = model_name or str(cfg_tree.get("model_name", "converted"))
    cfg = config_from_reference(cfg_tree, name)
    return cfg, convert_state_dict(state_dict_to_numpy(ckpt["state_dict"]),
                                   cfg)


def apply_finetuned_state_dict(
    cfg: ModelConfig, path: str, ckpt: Optional[Dict[str, Any]] = None,
) -> Tree:
    """A fine-tuned Lightning checkpoint's state dict, under a known cfg ->
    the JAX-layout numpy tree.  The whole wrapped model is in it
    (``preprocessor.``/``encoder.``/``head.`` keys), so the tree is rebuilt
    from it alone: a missing key fails loudly, never keeping base weights."""
    if ckpt is None:
        ckpt = load_torch_checkpoint(path)
    sd = state_dict_to_numpy({
        k: v for k, v in ckpt["state_dict"].items()
        if k.startswith(("preprocessor.", "encoder.", "head."))})
    return convert_state_dict(sd, cfg)


# ---------------------------------------------------------------------------
# The inverse: config and JAX-layout tree -> the reference's layout
# ---------------------------------------------------------------------------

def reference_cfg(cfg: ModelConfig) -> Dict[str, Any]:
    """``ModelConfig`` -> a reference cfg tree (plain dicts), with the
    reference's hydra targets and its ``${...}`` interpolations for the
    widths that repeat (``feat_in``, the heads' encoder width)."""
    e = cfg.encoder

    def width(value: int, path: str, target: int):
        return f"${{{path}}}" if value == target else value

    tree: Dict[str, Any] = {
        "model_name": cfg.model_name,
        "preprocessor": {
            "_target_": "gigaam.preprocess.FeatureExtractor",
            **{k: getattr(cfg.preprocessor, k) for k in (
                "sample_rate", "features", "win_length", "hop_length",
                "n_fft", "center", "dither")}},
        "encoder": {
            "_target_": "gigaam.encoder.ConformerEncoder",
            "feat_in": width(e.feat_in, "preprocessor.features",
                             cfg.preprocessor.features),
            **{k: getattr(e, k) for k in (
                "n_layers", "d_model", "subsampling", "subs_kernel_size",
                "subsampling_factor", "ff_expansion_factor",
                "self_attention_model", "n_heads", "pos_emb_max_len",
                "conv_norm_type", "conv_kernel_size")}},
    }
    head = cfg.head
    if isinstance(head, CTCHeadConfig):
        tree["head"] = {"_target_": "gigaam.decoder.CTCHead",
                        "feat_in": width(head.feat_in, "encoder.d_model",
                                         e.d_model),
                        "num_classes": head.num_classes}
    elif isinstance(head, RNNTHeadConfig):
        tree["head"] = {
            "_target_": "gigaam.decoder.RNNTHead",
            "decoder": dict(vars(head.decoder)),
            "joint": dict(vars(head.joint), enc_hidden=width(
                head.joint.enc_hidden, "encoder.d_model", e.d_model))}
    elif isinstance(head, EmoHeadConfig):
        tree["head"] = {"_target_": "torch.nn.Linear",
                        "in_features": width(head.feat_in, "encoder.d_model",
                                             e.d_model),
                        "out_features": head.num_classes}
    if cfg.decoding is not None:
        d = cfg.decoding
        tree["decoding"] = {
            "_target_": ("gigaam.decoding.RNNTGreedyDecoding"
                         if isinstance(head, RNNTHeadConfig)
                         else "gigaam.decoding.CTCGreedyDecoding"),
            "vocabulary": list(d.vocabulary), "model_path": d.model_path,
            "max_symbols_per_step": d.max_symbols_per_step}
    if cfg.id2name is not None:
        tree["id2name"] = {str(i): n for i, n in enumerate(cfg.id2name)}
    return tree


def _linear_back(sd: Dict[str, np.ndarray], name: str, p: Tree) -> None:
    sd[f"{name}.weight"] = p["w"].T
    if "b" in p:
        sd[f"{name}.bias"] = p["b"]


def reference_state_dict(tree: Tree,
                         cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The inverse of ``convert_state_dict``: a JAX-layout numpy tree ->
    reference names and layouts (C-contiguous float32).  The LSTM's summed
    bias goes to ``bias_ih`` and a zero ``bias_hh``."""
    sd: Dict[str, np.ndarray] = {}
    enc = tree["encoder"]
    pre = "encoder.pre_encode."
    for i in range(cfg.encoder.num_subsampling_stages):
        p = enc["pre_encode"][f"conv_{i}"]
        axes = ((3, 2, 0, 1) if cfg.encoder.subsampling == "conv2d"
                else (2, 1, 0))
        sd[f"{pre}conv.{2 * i}.weight"] = p["w"].transpose(axes)
        sd[f"{pre}conv.{2 * i}.bias"] = p["b"]
    if cfg.encoder.subsampling == "conv2d":
        _linear_back(sd, f"{pre}out", enc["pre_encode"]["out"])
    layers = enc["layers"]
    for li in range(cfg.encoder.n_layers):
        lp = _index(layers, li)
        prefix = f"encoder.layers.{li}."
        for name in ("norm_feed_forward1", "norm_self_att", "norm_conv",
                     "norm_feed_forward2", "norm_out"):
            sd[f"{prefix}{name}.weight"] = lp[name]["scale"]
            sd[f"{prefix}{name}.bias"] = lp[name]["bias"]
        for name in ("feed_forward1", "feed_forward2"):
            for lin in ("linear1", "linear2"):
                _linear_back(sd, f"{prefix}{name}.{lin}", lp[name][lin])
        attn = lp["self_attn"]
        for name in ("linear_q", "linear_k", "linear_v", "linear_out",
                     "linear_pos"):
            if name in attn:
                _linear_back(sd, f"{prefix}self_attn.{name}", attn[name])
        for name in ("pos_bias_u", "pos_bias_v"):
            if name in attn:
                sd[f"{prefix}self_attn.{name}"] = attn[name]
        conv = lp["conv"]
        pc1 = conv["pointwise_conv1"]
        sd[f"{prefix}conv.pointwise_conv1.weight"] = np.concatenate(
            [pc1["w_value"], pc1["w_gate"]], axis=1).T[:, :, None]
        sd[f"{prefix}conv.pointwise_conv1.bias"] = np.concatenate(
            [pc1["b_value"], pc1["b_gate"]])
        sd[f"{prefix}conv.depthwise_conv.weight"] = (
            conv["depthwise_conv"]["w"].transpose(2, 1, 0))
        sd[f"{prefix}conv.depthwise_conv.bias"] = conv["depthwise_conv"]["b"]
        bn = conv["batch_norm"]
        sd[f"{prefix}conv.batch_norm.weight"] = bn["scale"]
        sd[f"{prefix}conv.batch_norm.bias"] = bn["bias"]
        if "mean" in bn:
            sd[f"{prefix}conv.batch_norm.running_mean"] = bn["mean"]
            sd[f"{prefix}conv.batch_norm.running_var"] = bn["var"]
        sd[f"{prefix}conv.pointwise_conv2.weight"] = (
            conv["pointwise_conv2"]["w"].T[:, :, None])
        sd[f"{prefix}conv.pointwise_conv2.bias"] = conv["pointwise_conv2"]["b"]
    head = tree.get("head")
    if isinstance(cfg.head, CTCHeadConfig):
        sd["head.decoder_layers.0.weight"] = head["proj"]["w"].T[:, :, None]
        sd["head.decoder_layers.0.bias"] = head["proj"]["b"]
    elif isinstance(cfg.head, RNNTHeadConfig):
        sd["head.decoder.embed.weight"] = head["decoder"]["embed"]
        for li, layer in enumerate(head["decoder"]["lstm"]):
            sd[f"head.decoder.lstm.weight_ih_l{li}"] = layer["w_ih"].T
            sd[f"head.decoder.lstm.weight_hh_l{li}"] = layer["w_hh"].T
            sd[f"head.decoder.lstm.bias_ih_l{li}"] = layer["b"]
            sd[f"head.decoder.lstm.bias_hh_l{li}"] = np.zeros_like(layer["b"])
        for name, ref in (("enc", "enc"), ("pred", "pred"),
                          ("out", "joint_net.1")):
            _linear_back(sd, f"head.joint.{ref}", head["joint"][name])
    elif isinstance(cfg.head, EmoHeadConfig):
        _linear_back(sd, "head", head["proj"])
    return {k: np.ascontiguousarray(v, dtype=np.float32)
            for k, v in sd.items()}


def _index(tree: Tree, i: int) -> Tree:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# pyannote segmentation (the neural VAD)
# ---------------------------------------------------------------------------

def _sinc_taps_fallback(low_hz_: np.ndarray, band_hz_: np.ndarray,
                        kernel_size: int, sample_rate: int = 16000,
                        min_low_hz: float = 50.0,
                        min_band_hz: float = 50.0) -> np.ndarray:
    """asteroid's ``ParamSincFB`` FIR taps from its parameters, for when
    asteroid-filterbanks is not importable: the SincNet band-pass bank and
    its Hilbert (sine) pair, ``n_filters = 2 * len(low_hz_)``, a Hamming
    half-window.  Returns [n_filters, kernel_size]."""
    low = min_low_hz + np.abs(low_hz_.reshape(-1, 1))
    high = np.clip(low + min_band_hz + np.abs(band_hz_.reshape(-1, 1)),
                   min_low_hz, sample_rate / 2)
    band = (high - low)[:, 0]

    half = int(kernel_size / 2)
    n_lin = np.linspace(0, kernel_size / 2 - 1, num=half)
    window = 0.54 - 0.46 * np.cos(2 * np.pi * n_lin / kernel_size)
    n_ = (2 * np.pi
          * np.arange(-(kernel_size - 1) / 2.0, 0).reshape(1, -1)
          / sample_rate)
    ft_low = low @ n_
    ft_high = high @ n_

    cos_left = ((np.sin(ft_high) - np.sin(ft_low)) / (n_ / 2)) * window
    cos_center = 2 * band.reshape(-1, 1)
    cos_f = np.concatenate([cos_left, cos_center, cos_left[:, ::-1]], axis=1)
    sin_left = ((np.cos(ft_low) - np.cos(ft_high)) / (n_ / 2)) * window
    sin_f = np.concatenate([sin_left, np.zeros_like(cos_center),
                            -sin_left[:, ::-1]], axis=1)

    taps = np.concatenate([cos_f, sin_f], axis=0)
    norm = 2 * np.concatenate([band, band]).reshape(-1, 1)
    return (taps / norm).astype(np.float32)


def _materialize_sinc_taps(sd: Dict[str, np.ndarray], kernel_size: int,
                           sample_rate: int) -> np.ndarray:
    """[n_filters, kernel] taps from ``low_hz_``/``band_hz_``: the real
    filterbank construction when asteroid-filterbanks is installed."""
    low = sd["sincnet.conv1d.0.filterbank.low_hz_"]
    band = sd["sincnet.conv1d.0.filterbank.band_hz_"]
    try:
        import torch
        from asteroid_filterbanks import ParamSincFB

        fb = ParamSincFB(2 * low.shape[0], kernel_size, stride=1,
                         sample_rate=sample_rate)
        with torch.no_grad():
            fb.low_hz_.copy_(torch.from_numpy(low.reshape(-1, 1)))
            fb.band_hz_.copy_(torch.from_numpy(band.reshape(-1, 1)))
            return fb.filters().squeeze(1).numpy().astype(np.float32)
    except ImportError:
        return _sinc_taps_fallback(low, band, kernel_size, sample_rate)


def convert_pyannote_vad(path: str, kernel_size: int = 251):
    """A pyannote ``segmentation-3.0`` checkpoint (PyanNet: a raw state
    dict, a Lightning ckpt or a ``pytorch_model.bin``) -> (VADNetConfig,
    the JAX-layout numpy tree), for ``weights.vad_params_from_jax`` and
    ``models.vad_net.save_vad``.  The sinc filterbank is baked into plain
    FIR taps."""
    from .models.vad_net import VADNetConfig

    ckpt = load_torch_checkpoint(path)
    sd_raw = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    sd = state_dict_to_numpy(
        {k[len("model."):] if k.startswith("model.") else k: v
         for k, v in sd_raw.items() if hasattr(v, "detach")})

    def module_index(k: str) -> int:
        return int(k.split(".")[-2])

    # numeric module order ('10' after '2')
    conv_keys = sorted((k for k in sd if k.startswith("sincnet.conv1d.")
                        and k.endswith(".weight")), key=module_index)
    n_conv_blocks = len(conv_keys)
    lstm_layers = len({k.split("weight_ih_l")[1].split("_reverse")[0]
                       for k in sd if "weight_ih_l" in k})
    lin_keys = sorted((k for k in sd
                       if k.startswith("linear.") and k.endswith(".weight")),
                      key=module_index)
    cfg = VADNetConfig(
        sinc_filters=2 * sd["sincnet.conv1d.0.filterbank.low_hz_"].shape[0],
        sinc_kernel=kernel_size,
        conv_channels=sd[conv_keys[0]].shape[0] if conv_keys else 60,
        conv_kernel=sd[conv_keys[0]].shape[2] if conv_keys else 5,
        n_conv_blocks=n_conv_blocks,
        lstm_hidden=sd["lstm.weight_hh_l0"].shape[1],
        lstm_layers=lstm_layers,
        linear_hidden=sd[lin_keys[0]].shape[0] if lin_keys else 128,
        linear_layers=len(lin_keys),
        n_classes=sd["classifier.weight"].shape[0],
    )
    taps = _materialize_sinc_taps(sd, kernel_size, cfg.sample_rate)

    def lstm_dir(li: int, suffix: str) -> Dict[str, np.ndarray]:
        return {"w_ih": sd[f"lstm.weight_ih_l{li}{suffix}"].T,
                "w_hh": sd[f"lstm.weight_hh_l{li}{suffix}"].T,
                "b": (sd[f"lstm.bias_ih_l{li}{suffix}"]
                      + sd[f"lstm.bias_hh_l{li}{suffix}"])}

    params = {
        "wav_norm": {"w": sd["sincnet.wav_norm1d.weight"],
                     "b": sd["sincnet.wav_norm1d.bias"]},
        "sinc": {"taps": taps.T[:, None, :]},          # [K, 1, F]
        "norms": [{"w": sd[f"sincnet.norm1d.{i}.weight"],
                   "b": sd[f"sincnet.norm1d.{i}.bias"]}
                  for i in range(n_conv_blocks + 1)],
        # conv weight [out, in, k] -> [k, in, out]
        "convs": [{"w": sd[f"sincnet.conv1d.{i + 1}.weight"]
                   .transpose(2, 1, 0),
                   "b": sd[f"sincnet.conv1d.{i + 1}.bias"]}
                  for i in range(n_conv_blocks)],
        "lstm": [{"fwd": lstm_dir(li, ""), "bwd": lstm_dir(li, "_reverse")}
                 for li in range(lstm_layers)],
        "linear": [{"w": sd[f"linear.{i}.weight"].T,
                    "b": sd[f"linear.{i}.bias"]}
                   for i in range(len(lin_keys))],
        "classifier": {"w": sd["classifier.weight"].T,
                       "b": sd["classifier.bias"]},
    }
    return cfg, _contiguous(params)
