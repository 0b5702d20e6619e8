"""Parameter, optimizer and cache placements (counterpart of
``repro.parallel.sharding``): name-based rules with a divisibility
fallback, and ZeRO-1 placement of the optimizer moments.

A placement is a tuple with one entry a dimension: a mesh axis name, a
tuple of them, or None (replicated): the JAX package's ``PartitionSpec``
as a plain tuple.  Rules map parameter path names to column/row roles;
any mesh axis that does not divide its dimension is dropped, which
handles kv_heads=8 on a model=16 axis or layer-stacked leading dims.
The meshes are read only for their axis names and sizes, so an
``launch.mesh.AbstractMesh`` answers for meshes larger than the world.
On the 1-D ``"data"`` mesh of data-parallel training every parameter
comes out replicated.
"""
from __future__ import annotations

import math
import re
from typing import Any, Tuple

from repro_torch.launch.mesh import axis_sizes

# (regex over '/'-joined path) -> spec for the LAST ndim dims of the leaf.
# Leading (layer-stack) dims are padded with None.
_PARAM_RULES = [
    (r"emb$",                         ("model", None)),       # (V, d) vocab-sharded
    (r"lm_head/w$",                   (None, "model")),
    (r"vision_proj/w$",               (None, "model")),
    (r"(wq|wk|wv)/w$",                (None, "model")),
    (r"wo/w$",                        ("model", None)),
    (r"(gate|up)/w$",                 (None, "model")),
    (r"down/w$",                      ("model", None)),
    (r"moe/router$",                  (None, None)),
    (r"moe/(wg|wu|wd)$",              ("model", None, None)),  # experts
    (r"shared/(wg|wu|wd)$",           ("model", None, None)),
    (r"in_proj/w$",                   (None, "model")),
    (r"out_proj/w$",                  ("model", None)),
    (r"conv_w$",                      (None, "model")),
    (r"w_gates/w$",                   (None, "model")),
    (r"r_gates$",                     ("model", None, None)),
    (r"(wif)/w$",                     (None, None)),
    (r"/b$",                          (None,)),                # biases replicated
]


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _path_str(path) -> str:
    return "/".join(path)


def _fit(spec_tail: Tuple, shape: Tuple[int, ...], mesh) -> Tuple:
    """Pad the rule to ndim and drop axes that don't divide the dim."""
    ndim = len(shape)
    tail = list(spec_tail)[-ndim:] if ndim else []
    full = [None] * (ndim - len(tail)) + tail
    sizes = axis_sizes(mesh)
    out = []
    for dim, ax in zip(shape, full):
        if ax is None:
            out.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        if any(a not in sizes for a in axes):   # axis absent on this mesh
            out.append(None)
            continue
        prod = math.prod(sizes[a] for a in axes)
        out.append(ax if dim % prod == 0 else None)
    return tuple(out)


def param_specs(params_shapes, mesh):
    """Tree of placements matching a tree of tensors (or anything with a
    ``shape``)."""

    def one(path, leaf):
        name = _path_str(path)
        shape = tuple(leaf.shape)
        for pat, tail in _PARAM_RULES:
            if re.search(pat, name):
                return _fit(tail, shape, mesh)
        return (None,) * len(shape)

    return _map_with_path(one, params_shapes)


def _zip_map(fn, specs, shapes):
    """``fn(spec, leaf)`` over two trees of one structure; a placement
    tuple is a leaf of ``specs``."""
    if isinstance(shapes, dict):
        return {k: _zip_map(fn, specs[k], v) for k, v in shapes.items()}
    if isinstance(shapes, (list, tuple)):
        return type(shapes)(_zip_map(fn, s, v)
                            for s, v in zip(specs, shapes))
    return fn(specs, shapes)


def zero1_specs(param_spec_tree, params_shapes, mesh,
                zero_axes: Tuple[str, ...] = ("data",)):
    """ZeRO-1: shard optimizer moments over the DP axes too.

    For each leaf, find the first dimension that is unsharded in the param
    spec and divisible by the DP axis product; shard it over zero_axes.
    Leaves with no eligible dim keep the param spec (replicated moments).
    """
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in zero_axes) if zero_axes else 1

    def one(spec: Tuple, leaf):
        if dp <= 1:
            return spec
        shape = tuple(leaf.shape)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for i, (dim, ax) in enumerate(zip(shape, parts)):
            if ax is None and dim % dp == 0 and dim > 0:
                parts[i] = zero_axes if len(zero_axes) > 1 else zero_axes[0]
                return tuple(parts)
        return spec

    return _zip_map(one, param_spec_tree, params_shapes)


def opt_state_specs(param_spec_tree, params_shapes, mesh,
                    zero_axes=("data",)):
    z = zero1_specs(param_spec_tree, params_shapes, mesh, zero_axes)
    return {"m": z, "v": z, "step": ()}


def cache_specs(cache_shapes, mesh, rules) -> Any:
    """KV/state caches: batch over DP, seq over model where divisible."""
    sizes = axis_sizes(mesh)

    def one(path, leaf):
        name = _path_str(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        if name.endswith("len") or nd == 0:
            return ()
        # layer-stacked KV caches: (..., B, S, KV, D)
        if re.search(r"(attn_k|attn_v|cross_k|cross_v|/k|/v|/k_s|/v_s)$",
                     name) and nd >= 4:
            spec = [None] * nd
            b_dim, s_dim = nd - 4, nd - 3
            batch_ax = rules.rules.get("batch")
            seq_ax = rules.rules.get("seq_tp")
            if batch_ax is not None:
                axes = (batch_ax,) if isinstance(batch_ax, str) \
                    else tuple(batch_ax)
                if shape[b_dim] % math.prod(sizes[a] for a in axes) == 0:
                    spec[b_dim] = batch_ax
            if seq_ax is not None and shape[s_dim] % sizes[seq_ax] == 0:
                spec[s_dim] = seq_ax
            return tuple(spec)
        # recurrent states: (..., B, ...) — batch on the dim matching known B
        batch_ax = rules.rules.get("batch")
        if batch_ax is not None:
            axes = (batch_ax,) if isinstance(batch_ax, str) \
                else tuple(batch_ax)
            prod = math.prod(sizes[a] for a in axes)
            spec = [None] * nd
            for i, dim in enumerate(shape):
                if dim % prod == 0 and dim >= prod and i < nd - 1:
                    spec[i] = batch_ax
                    return tuple(spec)
        return (None,) * nd

    return _map_with_path(one, cache_shapes)
