"""The measured program's public entry points as the drivers build them:
the preset and flags from a configuration file, the field with the
benchmark's weights, and the rows through the field that a traced run
counts on the instance."""

import collections
import contextlib


def scene_and_flags(config: dict):
    """(SceneConfig, ModelFlags) as the configuration file states them."""
    from cednerf_torch.engine.config import ModelFlags, SceneConfig

    sc = dict(config["scene"])
    sc["aabb"] = tuple(sc["aabb"])
    sc["milestones"] = tuple(sc["milestones"])
    return SceneConfig(**sc), ModelFlags(**config["flags"])


def build_field(scene, flags, weights: dict, device: str = "cuda"):
    """The program's field for the preset on `device`, its parameters set to
    `weights` (every name and shape must match)."""
    from cednerf_torch.engine.cli import build_field as build

    field = build(scene, flags, device=device)
    field.load_state_dict(weights, strict=True)
    return field


@contextlib.contextmanager
def count_rows(field, totals: collections.Counter):
    """Inside the block, totals["render"] and ["density"] count the rows the
    field evaluates: a forward for colour, a density query of its own."""
    forward, query_density = field.forward, field.query_density
    inside = [False]

    def fwd(*args, **kwargs):
        totals["render"] += args[0].shape[0]
        inside[0] = True
        try:
            return forward(*args, **kwargs)
        finally:
            inside[0] = False

    def density(*args, **kwargs):
        if not inside[0]:
            totals["density"] += args[0].reshape(-1, 3).shape[0]
        return query_density(*args, **kwargs)

    field.forward, field.query_density = fwd, density
    try:
        yield
    finally:
        del field.forward, field.query_density

