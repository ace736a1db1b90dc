"""Weights bridge: the JAX package's parameter tree and ``save_model``
artifacts -> the port's state, and back (``params_to_jax``, ``save_model``),
so that a model fine-tuned by the port loads in the JAX package.

A ``save_model`` artifact is a pair: ``<base>.npz`` holding the flattened
parameter tree under ``/``-joined keys, and ``<base>.json`` holding the
``ModelConfig`` (``gigaam_tpu/models/model.py:702-848``).  Both are read with
numpy and json only.

Layouts (JAX -> port):
* Linear ``w`` [in, out]: unchanged, so the bridge is a plain copy.
* conv2d [Kh, Kw, Cin, Cout] -> torch [Cout, Cin, Kh, Kw].
* depthwise conv [K, 1, C] -> torch [C, 1, K].
* per-layer leaves stacked on a leading layer axis -> one dict per layer.
* GLU value/gate leaves stay separate; legacy artifacts that fused them
  into one ``pointwise_conv1 {w, b}`` are split by ``migrate_params``.
"""

from __future__ import annotations

import dataclasses
import json
import os
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
    return root


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
    return torch.from_numpy(np.array(a))            # a writable copy


def _layer_leaf(path: Tuple[str, ...], a: np.ndarray) -> torch.Tensor:
    if path[-2:] == ("depthwise_conv", "w"):
        a = a.transpose(2, 1, 0)                       # [K, 1, C] -> [C, 1, K]
    return _tensor(a)


def _map(tree: Tree, fn, path: Tuple[str, ...] = ()) -> Tree:
    return {k: _map(v, fn, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def params_from_jax(tree: Tree) -> Tree:
    """The JAX package's parameter tree (numpy leaves) -> the port's state
    (nested dicts of CPU torch tensors, dtypes kept)."""
    enc = tree["encoder"]
    pre = {}
    for name, p in enc["pre_encode"].items():
        if name.startswith("conv_") and p["w"].ndim == 4:
            pre[name] = {"w": _tensor(p["w"].transpose(3, 2, 0, 1)),
                         "b": _tensor(p["b"])}
        elif name.startswith("conv_"):
            raise NotImplementedError("conv1d subsampling is not ported")
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


def _leaves(tree: Tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def read_artifact(path: str) -> Tuple[ModelConfig, Tree]:
    """A ``save_model`` pair (``model.npz`` or ``model``) -> (config, state)."""
    base = path[:-4] if path.endswith(".npz") else path
    with open(base + ".json") as f:
        cfg = ModelConfig.from_dict(json.load(f))
    return cfg, params_from_jax(load_params_npz(base + ".npz"))


def load_native(path: str, device=None, **kw):
    """Load a ``save_model`` artifact into the port's model class."""
    from .models.model import model_class_for

    cfg, state = read_artifact(path)
    return model_class_for(cfg)(cfg, state=state, device=device, **kw)


# ---------------------------------------------------------------------------
# The inverse: the port's modules -> the JAX layout
# ---------------------------------------------------------------------------

def module_tree(module: torch.nn.Module) -> Tree:
    """A module built by ``models.encoder.as_module`` -> nested dicts of its
    tensors (parameters first, then child nodes)."""
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
            pre[name] = {"w": _numpy(p["w"]).transpose(2, 3, 1, 0),
                         "b": _numpy(p["b"])}
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


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def save_model(model, path: str) -> None:
    """Save a port model as the JAX package's native artifact pair: params
    (``<base>.npz``, ``/``-joined keys of the JAX tree) and config
    (``<base>.json``), readable by ``load_native`` of either package."""
    base = path[:-4] if path.endswith(".npz") else path
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    np.savez(base + ".npz", **_flatten(params_to_jax(model)))
    with open(base + ".json", "w") as f:
        f.write(model.cfg.to_json())


def load_state_into(module: torch.nn.Module, tree: Tree) -> None:
    """Copy a nested dict of tensors (or numpy arrays) into a module built
    by ``as_module``, in place; the structures must match."""
    have = module_tree(module)
    if set(have) != set(tree):
        raise ValueError(f"parameter tree mismatch: {sorted(have)} vs "
                         f"{sorted(tree)}")
    with torch.no_grad():
        for k, dst in have.items():
            if isinstance(dst, dict):
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
