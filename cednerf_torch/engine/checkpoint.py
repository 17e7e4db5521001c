"""Resumable training checkpoints — port of cednerf_tpu/engine/checkpoint.py
(`save_checkpoint`, `load_checkpoint`, `load_checkpoint_full`).

A checkpoint is a directory holding one torch.save dict (`state.pt`) with
the fields of the JAX package's `_ckpt_tree`: the field's state dict,
Adam's and the LR schedule's state, the occupancy grid (occs, binaries,
aabbs), the step, the Trainer's generator state (in place of the JAX
key), its ray bucket and its steady-march lattice; and a side-car
`param_shapes.json` of every tensor's shape, so that a load under another
encoder split fails with a message naming the mismatched tensors.

Proposal checkpoints (`save_prop_checkpoint` / `load_prop_checkpoint`, the
JAX `_prop_ckpt_tree`'s fields) hold the field's and each proposal field's
state dict, the joint PropOptimizer's state, the eval-culling occupancy
grid (absent when the run kept none), the step and the generator state;
their `param_shapes.json` names tensors "field.<name>" and
"props.<i>.<name>".
"""

import json
import os
from typing import Optional

import torch

from ..ops.occupancy import OccGridState

STATE_FILE = "state.pt"
SHAPES_FILE = "param_shapes.json"


def _shape_meta(field) -> dict:
    return {k: list(v.shape) for k, v in field.state_dict().items()}


def _prop_shape_meta(state) -> dict:
    out = {f"field.{k}": v for k, v in _shape_meta(state.field).items()}
    for i, p in enumerate(state.props):
        out.update({f"props.{i}.{k}": v for k, v in _shape_meta(p).items()})
    return out


def _check_shapes(path: str, here: dict, message: str):
    """Raises ValueError(message + the mismatched tensors) when the
    checkpoint's param_shapes.json differs from `here`."""
    meta_path = os.path.join(path, SHAPES_FILE)
    if not os.path.exists(meta_path):
        return
    with open(meta_path) as f:
        saved = json.load(f)
    bad = sorted(f"{k}: checkpoint {saved.get(k)} vs model {here.get(k)}"
                 for k in set(saved) | set(here)
                 if saved.get(k) != here.get(k))
    if bad:
        raise ValueError(message + ":\n  " + "\n  ".join(bad))


def _ckpt_tree(state, step: int, rng_state: Optional[torch.Tensor] = None,
               bucket: int = 0, steady: int = 0) -> dict:
    return {
        "field": state.field.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "occ": {"occs": state.occ.occs, "binaries": state.occ.binaries,
                "aabbs": state.occ.aabbs},
        "step": int(step),
        "rng": rng_state,
        "bucket": int(bucket),
        # the Trainer's adaptive steady-march lattice (0 = none recorded)
        "steady": int(steady),
    }


def save_checkpoint(path: str, state, step: int,
                    rng_state: Optional[torch.Tensor] = None,
                    bucket: int = 0, steady: int = 0):
    """Write the train state and the Trainer's step, generator state, ray
    bucket and steady lattice into the directory `path` (replacing what is
    there): a resume from it repeats the uninterrupted run's steps."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(_ckpt_tree(state, step, rng_state, bucket, steady), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    with open(os.path.join(path, SHAPES_FILE), "w") as f:
        json.dump(_shape_meta(state.field), f)


def load_checkpoint(path: str, state) -> tuple:
    """Restore into `state` (the --load_model path); returns (state, step).
    load_checkpoint_full also returns the generator state, bucket and
    steady lattice."""
    state, step, _, _, _ = load_checkpoint_full(path, state)
    return state, step


def load_checkpoint_full(path: str, state) -> tuple:
    """Restore into `state`: the field's tensors, Adam and the schedule in
    place, the occupancy grid replaced. Returns (state, step, generator
    state or None, bucket, steady); steady == 0 keeps the configured
    lattice. Raises ValueError naming the mismatched tensors when the
    checkpoint was written under another model config."""
    _check_shapes(path, _shape_meta(state.field),
                  "checkpoint/model parameter shapes differ (was it trained "
                  "with different --hash_levels/--hash_features or grid "
                  "flags?)")
    # loaded on the CPU: Adam keeps its step counts there (a count on the
    # card would cost a sync a step), and load_state_dict moves the rest
    tree = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    state.field.load_state_dict(tree["field"])
    state.optimizer.load_state_dict(tree["optimizer"])
    state.scheduler.load_state_dict(tree["scheduler"])
    occ = tree["occ"]
    dev = state.occ.occs.device
    state.occ = OccGridState(occs=occ["occs"].to(dev),
                             binaries=occ["binaries"].to(dev),
                             aabbs=occ["aabbs"].to(dev))
    return state, tree["step"], tree["rng"], tree["bucket"], tree["steady"]


def save_prop_checkpoint(path: str, state, occ: Optional[OccGridState],
                         step: int, rng_state: Optional[torch.Tensor] = None):
    """Write the proposal path's state (engine/train_prop.py PropTrainState:
    the field and proposal fields, the optimizer), the eval-culling
    occupancy grid (None: none is stored), the step and the generator
    state into the directory `path`, replacing what is there."""
    os.makedirs(path, exist_ok=True)
    tree = {"field": state.field.state_dict(),
            "props": [p.state_dict() for p in state.props],
            "optimizer": state.optimizer.state_dict(),
            "step": int(step), "rng": rng_state}
    if occ is not None:
        tree["occ"] = {"occs": occ.occs, "binaries": occ.binaries,
                       "aabbs": occ.aabbs}
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    with open(os.path.join(path, SHAPES_FILE), "w") as f:
        json.dump(_prop_shape_meta(state), f)


def load_prop_checkpoint(path: str, state, occ: Optional[OccGridState]):
    """Restore a proposal checkpoint into `state` (in place) and return
    (state, occ, step, generator state or None). `occ` is the template grid
    whose device the stored one goes to; the result is None when the
    checkpoint holds no grid or `occ` is None (no grid wanted). Raises
    ValueError naming the mismatched tensors when the checkpoint was
    written under another model or proposal config."""
    _check_shapes(path, _prop_shape_meta(state),
                  "prop checkpoint/model parameter shapes differ (different "
                  "--hash_levels/--hash_features or proposal config?)")
    tree = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    state.field.load_state_dict(tree["field"])
    if len(tree["props"]) != len(state.props):
        raise ValueError(f"prop checkpoint has {len(tree['props'])} "
                         f"proposal fields, the model {len(state.props)}")
    for p, sd in zip(state.props, tree["props"]):
        p.load_state_dict(sd)
    state.optimizer.load_state_dict(tree["optimizer"])
    new_occ = None
    if occ is not None and "occ" in tree:
        dev = occ.occs.device
        new_occ = OccGridState(**{k: v.to(dev) for k, v in
                                  tree["occ"].items()})
    return state, new_occ, tree["step"], tree["rng"]
