"""The field's MLP work a sample, from the layer shapes of the
configuration (the reference's `mlp_layers`): multiply-adds a row, x 2 for
operations."""

from ..reference.field import mlp_layers

# the MLPs a row runs through, by what the row is for
PATHS = {
    "render": ("motion_mlp", "mlp_base", "mlp_head"),
    "density": ("motion_mlp", "mlp_base"),
}


def macs(cfg: dict, mlps) -> int:
    """Multiply-adds a row through the named MLPs (those the configuration
    has)."""
    layers = mlp_layers(cfg)
    return sum(i * o for name in mlps if name in layers
               for i, o in layers[name])


def row_flops(cfg: dict, kind: str) -> int:
    """Operations of one row of `kind` ("render" or "density")."""
    return 2 * macs(cfg, PATHS[kind])
