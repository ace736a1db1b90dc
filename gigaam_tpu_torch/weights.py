"""Weights bridge: the JAX package's parameter tree and ``save_model``
artifacts -> the port's state.

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

import json
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
