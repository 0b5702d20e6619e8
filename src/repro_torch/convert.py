"""Carry the JAX package's parameters into the port.

``params_from_jax`` takes a tree as ``jax.device_get`` returns it (nested
dicts, lists or tuples of numpy arrays, such as the parameters of
``repro.models.layers.init_conv2d`` or ``repro.models.lm.LM.init`` and
the caches of ``repro.models.serve``) and returns the same tree of torch
tensors.  Layer-stacked leaves stay stacked, 0-d arrays (a cache's int32
``len``) become 0-d tensors of their dtype, and ``None`` leaves (a cache's
``tail`` when the layers divide evenly) stay ``None``.  Layouts are the
same in both packages (HWIO kernels, (in, out) linear weights), so
nothing is transposed.  With a mesh whose "model" axis is larger than 1
(and the model's config) each rank gets its slices of the parameters
(``parallel.tensor.shard_params``).  Only numpy is needed here, not jax.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(arr, device) -> torch.Tensor:
    # Copy first: arrays from jax.device_get are read-only, and
    # torch.from_numpy warns on (and would alias) them.
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart in from_numpy:
        # carry the bits through uint16.
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_jax(tree, device="cuda", mesh=None, cfg=None):
    """The same tree with every numpy leaf as a torch tensor on
    ``device``; with ``mesh`` and ``cfg`` (an LM's parameters), this
    rank's slices of them."""
    if mesh is not None:
        from repro_torch.parallel import tensor
        whole = params_from_jax(tree, "cpu")
        local = tensor.shard_params(whole, mesh, cfg,
                                    tensor.model_rank(mesh))
        return _to(local, device)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return _leaf(tree, device)


def _to(tree, device):
    """A tree of tensors moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return None if tree is None else tree.to(device)
