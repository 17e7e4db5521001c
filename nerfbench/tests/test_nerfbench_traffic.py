"""The generators give the same inputs for the same seed, and other inputs
for another."""

import itertools

import torch

from nerfbench.tests.tiny import VIEW, tiny_cell
from nerfbench.traffic import carved_grid, views, weights

CPU = torch.device("cpu")


def test_weights_follow_the_seed():
    cell = tiny_cell(VIEW[0])
    a = weights.make(cell.config, 2 ** 31 + 5, 1e-4, CPU, 5.0)
    b = weights.make(cell.config, 2 ** 31 + 5, 1e-4, CPU, 5.0)
    c = weights.make(cell.config, 2 ** 31 + 6, 1e-4, CPU, 5.0)
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a
               if not k.endswith("bias"))
    tables = [v for k, v in a.items() if k.startswith("hash_encoder")]
    assert max(t.abs().max().item() for t in tables) <= 1e-4
    assert a["mlp_base.out.bias"][0].item() == 5.0


def test_grid_and_views_follow_the_seed():
    cell = tiny_cell(VIEW[0])
    p = cell.workload["params"]
    aabb = cell.config["scene"]["aabb"]
    grid = dict(p["grid"], noise=0.01)
    g1 = carved_grid.shell(grid, aabb, 11, CPU)
    assert torch.equal(g1, carved_grid.shell(grid, aabb, 11, CPU))
    assert not torch.equal(g1, carved_grid.shell(grid, aabb, 12, CPU))
    n = p["views"]["views"]
    first = list(itertools.islice(views.order(p["views"], 3), 2 * n))
    again = list(itertools.islice(views.order(p["views"], 3), 2 * n))
    other = list(itertools.islice(views.order(p["views"], 4), 2 * n))
    assert first == again and first != other
    assert sorted(first[:n]) == list(range(n))      # every view a cycle
    vs = views.view_set(p["views"])
    assert len(vs) == n and len({t for _, t in vs}) == n
