"""Weights carried between the JAX package and the port, as numpy arrays.

The flax parameter tree of DNGPRadianceField (`field.init(...)`, optionally
wrapped in {"params": ...}) maps to the port's state dict by path:
`motion_mlp/hidden_0/kernel` -> `motion_mlp.hidden_0.weight` (transposed:
flax Dense kernels are [in, out], torch Linear weights [out, in]),
`.../bias` -> `.../bias`, and `hash_encoder/grid_0` -> `hash_encoder.grid_0`
(tables keep their layout; so do the tri-plane's `hash_encoder/planes`,
the per-corner encoder's `hash_encoder/table` and the hash-grid motion
warp's `motion_grid/...`). Values are copied bit for bit; no framework
import crosses over.
"""

from typing import Dict, Mapping

import numpy as np
import torch

from .ops.occupancy import OccGridState
from .utils.device import resolve_device


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_numpy(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> the port's state dict (CPU)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        if path[-1] == "kernel":
            out[".".join(path[:-1] + ("weight",))] = torch.from_numpy(
                np.array(arr.T, order="C"))
        else:
            out[".".join(path)] = torch.from_numpy(np.array(arr))
    return out


def params_to_numpy(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port's state dict -> {"params": flax-shaped tree of numpy}."""
    tree: dict = {}
    for name, t in state_dict.items():
        path = name.split(".")
        arr = t.detach().cpu().numpy()
        if path[-1] == "weight":
            path[-1] = "kernel"
            arr = np.ascontiguousarray(arr.T)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(arr)
    return {"params": tree}


def occ_from_numpy(occs, binaries, aabbs, device="cuda") -> OccGridState:
    """Occupancy grid arrays (the JAX OccGridState's fields) -> the port's,
    on CUDA unless device="cpu" is asked for."""
    device = resolve_device(device)
    return OccGridState(
        occs=torch.tensor(np.asarray(occs, np.float32), device=device),
        binaries=torch.tensor(np.asarray(binaries, bool), device=device),
        aabbs=torch.tensor(np.asarray(aabbs, np.float32), device=device))
