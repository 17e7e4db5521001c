"""The field's weights, made on the card from the run's seed in a few
large draws: every table from one uniform draw on +-`table_bound`, every
MLP weight from one truncated unit normal (cut at +-2) scaled to its
layer's lecun-normal std, biases zero but the density output's, which is
`density_bias` (a trained field is dense where it is occupied; a raw
initialisation leaves a frame nearly transparent). Names and shapes are the
reference's (`param_specs`), which are the measured field's."""

import torch

from ..reference.field import param_specs


def make(cfg: dict, seed: int, table_bound: float, device,
         density_bias: float = 0.0) -> dict:
    specs = param_specs(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n_table = sum(_numel(s) for _, s, kind, _ in specs if kind == "table")
    n_weight = sum(_numel(s) for _, s, kind, _ in specs if kind == "weight")
    tables = torch.empty(n_table, device=device).uniform_(
        -table_bound, table_bound, generator=gen)
    normal = torch.nn.init.trunc_normal_(
        torch.empty(n_weight, device=device), std=1.0, a=-2.0, b=2.0,
        generator=gen)
    out, offs = {}, {"table": 0, "weight": 0}
    for name, shape, kind, std in specs:
        if kind == "bias":
            out[name] = torch.zeros(shape, device=device)
            continue
        src = tables if kind == "table" else normal
        k = _numel(shape)
        v = src[offs[kind]:offs[kind] + k].view(shape)
        out[name] = v * std if kind == "weight" else v
        offs[kind] += k
    out["mlp_base.out.bias"][0] = density_bias
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
