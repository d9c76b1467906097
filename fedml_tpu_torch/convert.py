"""Weights between the JAX package's ResNet18GN (flax params) and the port's.

The mapping is by flax module name: ``Conv_0``, ``GroupNorm_0``,
``BasicBlockGN_k/{Conv_0, Conv_1, Conv_2, GroupNorm_0, GroupNorm_1,
GroupNorm_2}`` (``Conv_2``/``GroupNorm_2`` are the shortcut's) and
``Dense_0``.  Conv kernels go from flax's HWIO to PyTorch's OIHW, the Dense
kernel from [in, out] to [out, in]; GroupNorm ``scale``/``bias`` keep their
names and shapes.  Both directions take and give numpy-compatible values,
so neither side needs the other's framework.
"""
from __future__ import annotations

import numpy as np
import torch

_MODULES = {"Conv_0": "conv0", "Conv_1": "conv1", "Conv_2": "shortcut_conv",
            "GroupNorm_0": "gn0", "GroupNorm_1": "gn1",
            "GroupNorm_2": "shortcut_gn", "Dense_0": "dense"}
_BLOCK = "BasicBlockGN_"


def _torch_prefix(path: tuple) -> str:
    parts = []
    for p in path:
        if p.startswith(_BLOCK):
            parts += ["blocks", p[len(_BLOCK):]]
        elif p in _MODULES:
            parts.append(_MODULES[p])
        else:
            raise KeyError(f"no port counterpart for flax module {'/'.join(path)}")
    return ".".join(parts)


def _walk(tree: dict, path=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def flax_to_torch(params: dict, device="cpu") -> dict:
    """flax ``{"params": {...}}`` (or the inner dict) of numpy arrays ->
    the port's ``{name: tensor}``."""
    if "params" in params:
        params = params["params"]
    out = {}
    for path, leaf in _walk(params):
        *mods, leaf_name = path
        a = np.asarray(leaf)
        if leaf_name == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            leaf_name = "weight"
        out[f"{_torch_prefix(tuple(mods))}.{leaf_name}"] = \
            torch.tensor(a, device=device)
    return out


def torch_to_flax(state: dict) -> dict:
    """The port's ``{name: tensor}`` -> flax ``{"params": {...}}`` of numpy
    float32 arrays (for comparing trained weights leaf by leaf)."""
    back_modules = {v: k for k, v in _MODULES.items()}
    out: dict = {}
    for name, t in state.items():
        parts = name.split(".")
        leaf_name = parts[-1]
        path, i = [], 0
        while i < len(parts) - 1:
            if parts[i] == "blocks":
                path.append(_BLOCK + parts[i + 1])
                i += 2
            else:
                path.append(back_modules[parts[i]])
                i += 1
        a = t.detach().float().cpu().numpy()
        if leaf_name == "weight":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            leaf_name = "kernel"
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf_name] = np.ascontiguousarray(a)
    return {"params": out}
