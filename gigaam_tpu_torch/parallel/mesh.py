"""Device mesh and sharding rules (port of ``gigaam_tpu/parallel/mesh.py``).

The JAX package annotates one ``jax.sharding.Mesh`` with ("data", "model")
axes and lets XLA insert every collective.  The port keeps the same mesh,
as a ``torch.distributed`` ``DeviceMesh`` of one process per device, and
issues its collectives itself:

* data parallelism: each "data" rank runs a contiguous block of the
  batch's rows (JAX's ``P("data")``); gradients are summed over "data";
* tensor parallelism: the Megatron sharding of the Conformer layer over
  "model" (the same leaves as ``mesh.py:42-81``: the first product of the
  FFN, of the attention (by head) and of the GLU column-parallel, the
  second row-parallel).  ``collectives.copy_to_model`` enters a
  column-parallel block (identity forward, all-reduce of the input's
  gradient backward) and ``collectives.reduce_from_model`` leaves a
  row-parallel one (all-reduce forward, identity backward); the replicated
  bias and the residual come after the reduce, once.

The partition specs are trees like the JAX package's, over the same
JAX-layout parameter tree (``weights.params_to_jax``): each leaf names the
axis that is sharded over "model", or None for a replicated leaf.
``shard_params`` slices one rank's part of such a tree and
``unshard_params`` joins the parts again; ``shard_model`` and
``gather_params`` do both for a live model.

``batch_pspec`` and ``to_named`` have no counterpart: there is no sharded
array type here, each rank slices its rows itself (``data_rows``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as tdist

AXES = ("data", "model")


def make_mesh(data: Optional[int] = None, model: int = 1,
              device_type: str = "cpu"):
    """A ("data", "model") ``DeviceMesh`` over the initialized world; by
    default every rank on "data".  ``device_type`` is the mesh's, not the
    tensors': the port uses the mesh for its groups only, so ranks that
    share one card over ``gloo`` take a "cpu" mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    n = tdist.get_world_size()
    if data is None:
        data = n // model
    assert data * model == n, f"{data}x{model} != {n} processes"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return None if mesh is None else mesh.get_group(axis)


def data_rows(mesh, n: int) -> slice:
    """This rank's contiguous block of ``n`` rows (``n`` a multiple of the
    data size), as JAX's ``P("data")`` places them."""
    d = axis_size(mesh, "data")
    if n % d:
        raise ValueError(f"batch of {n} rows does not split over a data "
                         f"axis of {d}")
    r = axis_rank(mesh, "data")
    return slice(r * n // d, (r + 1) * n // d)


# ---------------------------------------------------------------------------
# Partition specs over the JAX-layout tree (axis index or None)
# ---------------------------------------------------------------------------

def _layer_pspecs(attention: str) -> Dict[str, Any]:
    """Specs of one stacked Conformer layer tree (leading axis = layer):
    the first products column-parallel, the second row-parallel
    (``gigaam_tpu/parallel/mesh.py:42-81``)."""
    norm = {"scale": None, "bias": None}
    ffn = {"linear1": {"w": 2, "b": 1}, "linear2": {"w": 1, "b": None}}
    attn: Dict[str, Any] = {
        "linear_q": {"w": 2, "b": 1},
        "linear_k": {"w": 2, "b": 1},
        "linear_v": {"w": 2, "b": 1},
        "linear_out": {"w": 1, "b": None},
    }
    if attention == "rel_pos":
        attn["linear_pos"] = {"w": 2}
        attn["pos_bias_u"] = 1
        attn["pos_bias_v"] = 1
    conv = {
        # GLU halves are separate leaves, so a rank's value and gate
        # channels are the same ones
        "pointwise_conv1": {"w_value": 2, "b_value": 1,
                            "w_gate": 2, "b_gate": 1},
        "depthwise_conv": {"w": 3, "b": 1},
        "pointwise_conv2": {"w": 1, "b": None},
        "batch_norm": {"scale": 1, "bias": 1, "mean": 1, "var": 1},
    }
    return {
        "norm_feed_forward1": norm, "feed_forward1": ffn,
        "norm_self_att": norm, "self_attn": attn,
        "norm_conv": norm, "conv": conv,
        "norm_feed_forward2": norm, "feed_forward2": ffn,
        "norm_out": norm,
    }


def _replicated(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_replicated(v) for v in tree]
    return None


def encoder_pspecs(params: Dict[str, Any], attention: str,
                   conv_norm_type: str = "batch_norm") -> Dict[str, Any]:
    """Specs of an encoder tree.  The subsampling stages shard too: even
    stages by output channel (the weight's last axis), odd stages by input
    channel (its second to last), their bias replicated and added after the
    reduce; ``out`` is replicated."""
    layer = _layer_pspecs(attention)
    if conv_norm_type != "batch_norm":
        layer["conv"] = dict(layer["conv"], batch_norm={"scale": 1,
                                                        "bias": 1})
    pre: Dict[str, Any] = {}
    for k, v in params["pre_encode"].items():
        if k.startswith("conv_"):
            nd = np.ndim(v["w"])           # 4: conv2d HWIO, 3: conv1d WIO
            if int(k.split("_")[1]) % 2 == 0:
                pre[k] = {"w": nd - 1, "b": 0}
            else:
                pre[k] = {"w": nd - 2, "b": None}
        else:
            pre[k] = _replicated(v)
    return {"pre_encode": pre, "layers": layer}


def params_pspecs(params: Dict[str, Any], attention: str,
                  conv_norm_type: str = "batch_norm") -> Dict[str, Any]:
    """Specs of a whole model tree: the encoder sharded, every other
    subtree (heads, an SSL head) replicated."""
    specs = {"encoder": encoder_pspecs(params["encoder"], attention,
                                       conv_norm_type)}
    for key, sub in params.items():
        if key != "encoder":
            specs[key] = _replicated(sub)
    return specs


def _zip_map(fn, specs: Any, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _zip_map(fn, specs[k], v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zip_map(fn, s, v) for s, v in zip(specs, tree)]
    return fn(specs, tree)


def shard_params(params: Dict[str, Any], specs: Dict[str, Any], index: int,
                 size: int) -> Dict[str, Any]:
    """Part ``index`` of ``size`` of a JAX-layout tree (numpy leaves): each
    sharded leaf split evenly along its axis, each replicated leaf kept."""
    def part(axis, a):
        if axis is None:
            return a
        if a.shape[axis] % size:
            raise ValueError(f"axis {axis} of a {a.shape} leaf does not "
                             f"split over {size} model ranks")
        return np.split(np.asarray(a), size, axis=axis)[index]

    return _zip_map(part, specs, params)


def unshard_params(parts: Sequence[Dict[str, Any]],
                   specs: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``shard_params``: the parts, in model-rank order,
    joined along each sharded leaf's axis."""
    def join(axis, *leaves):
        return leaves[0] if axis is None else np.concatenate(leaves, axis)

    def walk(s, nodes):
        first = nodes[0]
        if isinstance(first, dict):
            return {k: walk(s[k], [n[k] for n in nodes]) for k in first}
        if isinstance(first, (list, tuple)):
            return [walk(si, [n[i] for n in nodes])
                    for i, si in enumerate(s)]
        return join(s, *nodes)

    return walk(specs, list(parts))


def model_specs(model, tree: Dict[str, Any]) -> Dict[str, Any]:
    enc = model.cfg.encoder
    return params_pspecs(tree, enc.self_attention_model, enc.conv_norm_type)


def shard_model(model, mesh) -> None:
    """Keep only this rank's "model" shard of ``model``'s encoder (in
    place; the head stays whole).  The encoder then runs its layers
    tensor-parallel over the mesh's "model" group.  Refuses an odd count of
    subsampling stages, whose last stage would leave its output sharded."""
    from ..models.encoder import ConformerEncoder
    from ..weights import params_from_jax, params_to_jax

    m = axis_size(mesh, "model")
    if m == 1:
        return
    enc_cfg = model.cfg.encoder
    if enc_cfg.num_subsampling_stages % 2:
        raise ValueError("tensor parallelism needs an even number of "
                         "subsampling stages")
    if enc_cfg.n_heads % m:
        raise ValueError(f"{enc_cfg.n_heads} heads do not split over {m} "
                         f"model ranks")
    tree = {"encoder": params_to_jax(model)["encoder"]}
    local = shard_params(tree, model_specs(model, tree),
                         axis_rank(mesh, "model"), m)
    dtype = next(model.encoder.parameters()).dtype
    encoder = ConformerEncoder(enc_cfg, params_from_jax(local)["encoder"])
    model.encoder = encoder.to(device=model.device, dtype=dtype)
    model.encoder.tp_group = axis_group(mesh, "model")


def gather_params(model) -> Dict[str, Any]:
    """The whole JAX-layout tree of a (possibly "model"-sharded) model, on
    every rank: a collective over "model", which every rank must join (the
    counterpart of ``tree_to_host``, ``gigaam_tpu/models/model.py:735``)."""
    from ..weights import params_to_jax

    tree = params_to_jax(model)
    group = getattr(model.encoder, "tp_group", None)
    if group is None:
        return tree
    parts: List[Any] = [None] * tdist.get_world_size(group)
    tdist.all_gather_object(parts, tree, group=group)
    return unshard_params(parts, model_specs(model, tree))
