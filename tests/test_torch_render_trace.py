"""The seg renderer's run-to-run stable 1-D scan (utils/math.py
`row_cumsum`) and the op-by-op frame trace (tools/render_trace.py) that
found where two renders of one checkpoint parted, on the CPU.

row_cumsum against torch.cumsum: integer-valued inputs sum exactly in any
order, so equal; random f32 within 1e-6 of the running total's scale
(another summation order). The trace: a toy computation traced twice gives
equal digests; a changed bit in one input shows at the first op that
reads it.
"""

import numpy as np
import pytest
import torch

from cednerf_torch.tools import render_trace as rt
from cednerf_torch.utils.math import row_cumsum


@pytest.mark.parametrize("n", [1, 5, 1023, 1024, 1025, 4096, 131072 + 7])
def test_row_cumsum_matches_cumsum(n):
    rng = np.random.default_rng(n)
    ints = torch.from_numpy(rng.integers(-50, 50, n).astype(np.float32))
    assert torch.equal(row_cumsum(ints), torch.cumsum(ints, 0))
    x = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    want = torch.cumsum(x.double(), 0)
    got = row_cumsum(x)
    assert got.shape == (n,) and got.dtype == torch.float32
    assert (got.double() - want).abs().max().item() <= 1e-6 * max(
        want[-1].item(), 1.0)


def _toy(a, b):
    c = torch.cumsum(a * b + 1.0, 0)
    return torch.empty_like(c).copy_(c).sum()


def test_op_trace_finds_the_first_changed_op():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    traces = []
    for bb in (b, b, b.clone().index_fill_(0, torch.tensor([7]), 0.5)):
        tr = rt.OpTrace()
        with tr:
            _toy(a, bb)
        traces.append(tr.result())
    same = rt.first_difference(traces[0], traces[1])
    assert same["n_differ"] == 0 and same["ops"][0] == same["ops"][1] > 0
    names = [op for op, _ in traces[0]["ops"]]
    assert "aten.empty_like" not in names       # undefined contents
    diff = rt.first_difference(traces[0], traces[2])
    assert diff["n_differ"] > 0 and diff["op"][0] == "aten.mul"
