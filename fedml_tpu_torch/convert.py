"""Weights between the JAX package's flax models and the port's models.

The port's models name their submodules as flax names its own
(``Conv_0``, ``BatchNorm_1``, ``BasicBlock_3``, ``Dense_0``, ...) and keep
flax's shapes for every leaf but conv kernels, so a flax path
``A/B/leaf`` is the port's ``A.B.leaf``.  The one change: a conv
``kernel`` in flax's HWIO is the port's ``weight`` in PyTorch's OIHW, and
a ``ConvTranspose_k`` kernel (which flax applies unflipped, PyTorch
flipped) is the port's ``weight`` flipped in both spatial axes and laid
out (in, out, kh, kw).  BatchNorm statistics (flax's ``batch_stats``
collection, leaves ``mean`` and ``var``) are buffers of the same names.

Nested dicts map to dotted names whatever they hold: the JAX VFLEngine's
per-party params (``party_0/kernel`` -> ``party_0.kernel``) and FedGAN's
``{"gen": ..., "disc": ...}`` pair (``gen.Dense_0.kernel``).  A tuple or
list, such as SplitNN's and FedGKT's (client, server) pair, maps item by
item.  Both directions take and give numpy-compatible values, so neither
side needs the other's framework.
"""
from __future__ import annotations

import numpy as np
import torch

COLLECTIONS = ("params", "batch_stats")


def _walk(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _transposed(path) -> bool:
    """A leaf of a flax ``nn.ConvTranspose`` (auto-named ConvTranspose_k)."""
    return len(path) > 1 and path[-2].startswith("ConvTranspose")


def flax_to_torch(variables, device="cpu"):
    """flax variables ``{"params": ..., ["batch_stats": ...]}`` (or the
    params dict alone) of numpy arrays -> the port's ``{name: tensor}``;
    a tuple or list of them -> a tuple of such dicts."""
    if isinstance(variables, (tuple, list)):
        return tuple(flax_to_torch(v, device) for v in variables)
    if not any(c in variables for c in COLLECTIONS):
        variables = {"params": variables}
    out = {}
    for collection in COLLECTIONS:
        for path, leaf in _walk(variables.get(collection, {})):
            a = np.asarray(leaf)
            if path[-1] == "kernel" and a.ndim == 4:
                a = (a[::-1, ::-1].transpose(2, 3, 0, 1) if _transposed(path)
                     else a.transpose(3, 2, 0, 1))
                path = path[:-1] + ("weight",)
            out[".".join(path)] = torch.tensor(np.ascontiguousarray(a),
                                               device=device)
    return out


def torch_to_flax(state):
    """The port's ``{name: tensor}`` -> flax ``{"params": {...}}`` (and
    ``"batch_stats"`` for BatchNorm's ``mean``/``var``) of numpy float32
    arrays, for comparing trained weights leaf by leaf; a tuple or list of
    such dicts -> a tuple of the results."""
    if isinstance(state, (tuple, list)):
        return tuple(torch_to_flax(s) for s in state)
    out: dict = {}
    for name, t in state.items():
        *path, leaf = name.split(".")
        a = t.detach().float().cpu().numpy()
        if leaf == "weight" and a.ndim == 4:
            a = (a.transpose(2, 3, 0, 1)[::-1, ::-1]
                 if _transposed(path + [leaf]) else a.transpose(2, 3, 1, 0))
            leaf = "kernel"
        node = out.setdefault("batch_stats" if leaf in ("mean", "var")
                              else "params", {})
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return out
