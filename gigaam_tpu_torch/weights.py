"""Weights bridge: the JAX package's parameter tree and ``save_model``
artifacts -> the port's state, and back (``params_to_jax``, ``save_model``),
so that a model fine-tuned by the port loads in the JAX package.

A ``save_model`` artifact is a pair: ``<base>.npz`` holding the flattened
parameter tree under ``/``-joined keys, and ``<base>.json`` holding the
``ModelConfig`` (``gigaam_tpu/models/model.py:702-848``).  Both are read with
numpy and json only.

Layouts (JAX -> port):
* Linear ``w`` [in, out]: unchanged, so the bridge is a plain copy.
* conv2d [Kh, Kw, Cin, Cout] -> torch [Cout, Cin, Kh, Kw]; the conv1d
  subsampling's [K, Cin, Cout] -> torch [Cout, Cin, K].
* depthwise conv [K, 1, C] -> torch [C, 1, K].
* per-layer leaves stacked on a leading layer axis -> one dict per layer.
* GLU value/gate leaves stay separate; legacy artifacts that fused them
  into one ``pointwise_conv1 {w, b}`` are split by ``migrate_params``.
* list-valued subtrees (the RNNT predictor's LSTM layers) are saved under
  digit keys (``decoder/lstm/0/w_ih``) and read back as lists, as the JAX
  package does (``listify``).
* a SentencePiece tokenizer travels beside the artifact, under a path
  relative to it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .config import ModelConfig

Tree = Dict[str, Any]


def _unflatten(flat: Dict[str, np.ndarray]) -> Tree:
    root: Tree = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def migrate_params(params: Tree) -> Tree:
    """Split legacy fused GLU leaves ``pointwise_conv1 {w [.., d, 2d],
    b [.., 2d]}`` into the current value/gate leaves."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k == "pointwise_conv1" and isinstance(v, dict) and "w" in v:
                w = v["w"]
                c = w.shape[-1] // 2
                nv = {"w_value": w[..., :c], "w_gate": w[..., c:]}
                if "b" in v:
                    nv["b_value"] = v["b"][..., :c]
                    nv["b_gate"] = v["b"][..., c:]
                out[k] = nv
            else:
                out[k] = walk(v)
        return out

    return walk(params)


def load_params_npz(path: str) -> Tree:
    """A ``save_model`` .npz -> the JAX-layout tree of numpy arrays."""
    with np.load(path) as z:
        return migrate_params(_unflatten({k: z[k] for k in z.files}))


def _tensor(a: np.ndarray) -> torch.Tensor:
    # a writable C-contiguous copy: a transposed leaf would otherwise keep
    # its strides, and a library kernel may pick another algorithm for them
    return torch.from_numpy(np.array(a, order="C"))


def _layer_leaf(path: Tuple[str, ...], a: np.ndarray) -> torch.Tensor:
    if path[-2:] == ("depthwise_conv", "w"):
        a = a.transpose(2, 1, 0)                       # [K, 1, C] -> [C, 1, K]
    return _tensor(a)


def _map(tree: Any, fn, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` on every leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def sub_block_from_jax(tree: Tree) -> Tree:
    """One layer's sub-block tree in the JAX layout (numpy leaves without
    the layer axis, e.g. ``{"pointwise_conv1": ..., "depthwise_conv": ...}``
    or a LayerNorm's ``{"scale", "bias"}``) -> the port's layout (CPU torch
    tensors, dtypes kept)."""
    return _map(tree, _layer_leaf)


def params_from_jax(tree: Tree) -> Tree:
    """The JAX package's parameter tree (numpy leaves) -> the port's state
    (nested dicts of CPU torch tensors, dtypes kept)."""
    enc = tree["encoder"]
    pre = {}
    for name, p in enc["pre_encode"].items():
        if name.startswith("conv_"):
            w = np.asarray(p["w"])
            axes = (3, 2, 0, 1) if w.ndim == 4 else (2, 1, 0)
            pre[name] = {"w": _tensor(w.transpose(axes)),
                         "b": _tensor(p["b"])}
        else:
            pre[name] = _map(p, lambda _, a: _tensor(a))
    stacked = enc["layers"]
    n_layers = len(next(iter(_leaves(stacked))))
    layers = [_map(stacked, lambda path, a, i=i: _layer_leaf(path, a[i]))
              for i in range(n_layers)]
    state: Tree = {"encoder": {"pre_encode": pre, "layers": layers}}
    if "head" in tree:
        state["head"] = _map(tree["head"], lambda _, a: _tensor(a))
    return state


def _leaves(tree: Any):
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, (dict, list, tuple)):
            yield from _leaves(v)
        else:
            yield v


def read_artifact(path: str) -> Tuple[ModelConfig, Tree]:
    """A ``save_model`` pair (``model.npz`` or ``model``) -> (config, state).
    A tokenizer path stored relative to the artifact is rebased onto its
    directory."""
    base = path[:-4] if path.endswith(".npz") else path
    with open(base + ".json") as f:
        cfg = ModelConfig.from_dict(json.load(f))
    dec = cfg.decoding
    if dec is not None and dec.model_path and not os.path.isabs(
            dec.model_path):
        cfg = dataclasses.replace(cfg, decoding=dataclasses.replace(
            dec, model_path=os.path.join(os.path.dirname(base) or ".",
                                         dec.model_path)))
    return cfg, params_from_jax(load_params_npz(base + ".npz"))


def load_native(path: str, device=None, **kw):
    """Load a ``save_model`` artifact into the port's model class."""
    from .models.model import model_class_for

    cfg, state = read_artifact(path)
    return model_class_for(cfg)(cfg, state=state, device=device, **kw)


# ---------------------------------------------------------------------------
# The inverse: the port's modules -> the JAX layout
# ---------------------------------------------------------------------------

def module_tree(module: torch.nn.Module) -> Any:
    """A module built by ``models.encoder.as_module`` -> nested dicts of its
    tensors (parameters first, then child nodes); a ``ModuleList`` -> a
    list."""
    if isinstance(module, torch.nn.ModuleList):
        return [module_tree(child) for child in module]
    tree: Tree = dict(module._parameters)
    for name, child in module._modules.items():
        tree[name] = module_tree(child)
    return tree


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy() if x.dtype == torch.bfloat16 \
        else x.detach().cpu().numpy()


def _layer_leaf_to_jax(path: Tuple[str, ...], a: np.ndarray) -> np.ndarray:
    if path[-2:] == ("depthwise_conv", "w"):
        a = a.transpose(0, 3, 2, 1)           # [L, C, 1, K] -> [L, K, 1, C]
    return a


def params_to_jax(model) -> Tree:
    """The inverse of ``params_from_jax``: a port model -> the JAX package's
    parameter tree as numpy arrays (the layers stacked again on a leading
    axis, conv layouts transposed back, linear layouts unchanged)."""
    pre = {}
    for name, p in module_tree(model.encoder.pre_encode).items():
        if name.startswith("conv_"):
            w = _numpy(p["w"])
            axes = (2, 3, 1, 0) if w.ndim == 4 else (2, 1, 0)
            pre[name] = {"w": w.transpose(axes), "b": _numpy(p["b"])}
        else:
            pre[name] = _map(p, lambda _, a: _numpy(a))
    per_layer = [_map(module_tree(layer), lambda _, a: _numpy(a))
                 for layer in model.encoder.layers]

    def stack(nodes, path=()):
        return {k: stack([n[k] for n in nodes], path + (k,))
                if isinstance(v, dict)
                else _layer_leaf_to_jax(path + (k,),
                                        np.stack([n[k] for n in nodes]))
                for k, v in nodes[0].items()}

    tree: Tree = {"encoder": {"pre_encode": pre, "layers": stack(per_layer)}}
    if hasattr(model, "head"):
        tree["head"] = _map(module_tree(model.head), lambda _, a: _numpy(a))
    return tree


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts and lists -> ``/``-joined keys (list items under their
    index)."""
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def save_model(model, path: str) -> None:
    """Save a port model as the JAX package's native artifact pair: params
    (``<base>.npz``, ``/``-joined keys of the JAX tree) and config
    (``<base>.json``), readable by ``load_native`` of either package.  A
    SentencePiece tokenizer is copied next to the npz as
    ``<name>_tokenizer.model`` and stored by that relative path, so the
    artifact can move (``gigaam_tpu/models/model.py:777-792``).

    In a ``torch.distributed`` run every rank calls it: a tensor-parallel
    encoder's shards are gathered (a collective), rank 0 alone writes the
    same pair one process writes (JAX ``model.py:759-771``), and every rank
    returns once it is written."""
    from .parallel.mesh import gather_params

    tree = gather_params(model)
    ranks = torch.distributed.is_initialized()
    if not ranks or torch.distributed.get_rank() == 0:
        _write_artifact(model, tree, path)
    if ranks:
        torch.distributed.barrier()  # the pair exists when any rank returns


def _write_artifact(model, tree: Tree, path: str) -> None:
    base = path[:-4] if path.endswith(".npz") else path
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    np.savez(base + ".npz", **_flatten(tree))
    cfg = model.cfg
    dec = cfg.decoding
    if dec is not None and dec.model_path:
        tok_name = os.path.basename(base) + "_tokenizer.model"
        tok_dst = os.path.join(os.path.dirname(base) or ".", tok_name)
        # model_path is cwd-relative or absolute (read_artifact rebased an
        # artifact's own), never relative to the destination
        src = os.path.abspath(dec.model_path)
        if src != os.path.abspath(tok_dst):
            shutil.copyfile(src, tok_dst)
        cfg = dataclasses.replace(
            cfg, decoding=dataclasses.replace(dec, model_path=tok_name))
    with open(base + ".json", "w") as f:
        f.write(cfg.to_json())


def load_state_into(module: torch.nn.Module, tree: Tree) -> None:
    """Copy a nested dict of tensors (or numpy arrays) into a module built
    by ``as_module``, in place; the structures must match."""
    if isinstance(module, torch.nn.ModuleList):
        if len(module) != len(tree):
            raise ValueError(f"{len(tree)} list items for {len(module)} "
                             f"modules")
        for child, sub in zip(module, tree):
            load_state_into(child, sub)
        return
    have = module_tree(module)
    if set(have) != set(tree):
        raise ValueError(f"parameter tree mismatch: {sorted(have)} vs "
                         f"{sorted(tree)}")
    with torch.no_grad():
        for k, dst in have.items():
            if isinstance(dst, (dict, list)):
                load_state_into(module._modules[k], tree[k])
            else:
                src = torch.as_tensor(tree[k])
                if src.shape != dst.shape:
                    raise ValueError(f"{k}: shape {tuple(src.shape)} does "
                                     f"not match {tuple(dst.shape)}")
                dst.copy_(src)


def init_encoder_from_artifact(model, path: str) -> None:
    """SSL -> ASR handoff: replace ``model``'s encoder weights with those of
    another native artifact, leaving the head untouched.  Raises ValueError
    on an encoder-config mismatch (anything but runtime flags) or a
    different parameter tree."""
    src_cfg, state = read_artifact(path)
    ours = dataclasses.asdict(model.cfg.encoder)
    theirs = dataclasses.asdict(src_cfg.encoder)
    for runtime_flag in ("flash_attn", "activation_checkpointing",
                         "remat_policy", "pos_emb_max_len"):
        ours.pop(runtime_flag, None)
        theirs.pop(runtime_flag, None)
    if ours != theirs:
        diff = {k: (theirs.get(k), ours.get(k)) for k in set(ours) | set(theirs)
                if theirs.get(k) != ours.get(k)}
        raise ValueError(
            f"encoder architecture mismatch between {path} and "
            f"{model.cfg.model_name} (artifact vs model): {diff}")
    enc = state["encoder"]
    load_state_into(model.encoder.pre_encode, enc["pre_encode"])
    if len(enc["layers"]) != len(model.encoder.layers):
        raise ValueError(f"{path}: {len(enc['layers'])} layers, the model "
                         f"has {len(model.encoder.layers)}")
    for layer, tree in zip(model.encoder.layers, enc["layers"]):
        load_state_into(layer, tree)


# ---------------------------------------------------------------------------
# The PyanNet VAD (``models/vad_net.py``)
# ---------------------------------------------------------------------------

def _c(a) -> torch.Tensor:
    """A C-contiguous writable CPU copy of a numpy (or JAX) array."""
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def vad_params_from_jax(params: Tree) -> Tree:
    """The JAX PyanNet tree (``init_vad_params``, ``load_vad``) -> the
    port's state:

    * sinc taps [K, 1, F] -> [F, 1, K]; conv ``w`` [K, Cin, Cout] ->
      [Cout, Cin, K];
    * LSTM layer k, direction ``fwd``/``bwd``: ``w_ih`` [in, 4H] ->
      ``weight_ih_l{k}`` [4H, in] (``_reverse`` for ``bwd``), ``w_hh``
      likewise; the pre-summed ``b`` -> ``bias_ih_l{k}`` and a zero
      ``bias_hh_l{k}`` (gate order [i, f, g, o] on both sides);
    * ``norms`` (one list, whose entries may share one dict in the JAX
      init), linears and the classifier: copies."""
    def leaves(node):
        return {k: _c(v) for k, v in node.items()}

    lstm: Tree = {}
    for k, layer in enumerate(params["lstm"]):
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            p = layer[direction]
            lstm[f"weight_ih_l{k}{suffix}"] = _c(np.asarray(p["w_ih"]).T)
            lstm[f"weight_hh_l{k}{suffix}"] = _c(np.asarray(p["w_hh"]).T)
            lstm[f"bias_ih_l{k}{suffix}"] = _c(p["b"])
            lstm[f"bias_hh_l{k}{suffix}"] = torch.zeros(
                np.asarray(p["b"]).shape)
    return {
        "wav_norm": leaves(params["wav_norm"]),
        "sinc": {"taps": _c(np.asarray(params["sinc"]["taps"])
                            .transpose(2, 1, 0))},
        "norms": [leaves(n) for n in params["norms"]],
        "convs": [{"w": _c(np.asarray(c["w"]).transpose(2, 1, 0)),
                   "b": _c(c["b"])} for c in params["convs"]],
        "lstm": lstm,
        "linear": [leaves(lin) for lin in params["linear"]],
        "classifier": leaves(params["classifier"]),
    }


def vad_params_to_jax(net) -> Tree:
    """The inverse of ``vad_params_from_jax``: a ``PyanNet`` -> the JAX
    tree as numpy arrays (the LSTM's two biases summed into ``b``)."""
    def leaves(node):
        return {k: _numpy(v) for k, v in node.items()}

    sd = {k: _numpy(v) for k, v in net.lstm.state_dict().items()}
    lstm = [{direction: {"w_ih": sd[f"weight_ih_l{k}{suffix}"].T.copy(),
                         "w_hh": sd[f"weight_hh_l{k}{suffix}"].T.copy(),
                         "b": sd[f"bias_ih_l{k}{suffix}"]
                         + sd[f"bias_hh_l{k}{suffix}"]}
             for direction, suffix in (("fwd", ""), ("bwd", "_reverse"))}
            for k in range(net.cfg.lstm_layers)]
    return {
        "wav_norm": leaves(net.wav_norm),
        "sinc": {"taps": _numpy(net.sinc["taps"]).transpose(2, 1, 0).copy()},
        "norms": [leaves(n) for n in net.norms],
        "convs": [{"w": _numpy(c["w"]).transpose(2, 1, 0).copy(),
                   "b": _numpy(c["b"])} for c in net.convs],
        "lstm": lstm,
        "linear": [leaves(lin) for lin in net.linear],
        "classifier": leaves(net.classifier),
    }
