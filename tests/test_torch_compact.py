"""The port's budget compaction (the plain version of kernel K4 and the
multi-block compact_select) against the JAX package, bit for bit: the
outputs are integers and masks, so there is no tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.engine import renderer as jr
from cednerf_tpu.ops.pallas_compact import compact_select_pallas
from cednerf_torch.engine import renderer as tr
from cednerf_torch.ops import compact_kernels as ck

CASES = [  # r, m, budget, occupancy
    (64, 128, 2048, 0.3),     # steady state, budget over demand
    (32, 256, 1024, 0.9),     # heavy overflow
    (24, 96, 512, 0.5),
    (16, 128, 1024, 0.0),     # empty lattice
    (16, 128, 1024, 1.0),     # full lattice, budget under demand
    (16, 128, 4096, 1.0),     # full lattice, budget over demand
    (40, 64, 977, 0.25),      # budget not a multiple of anything
]


def _valid(r, m, p, seed=0):
    rng = np.random.default_rng(seed + r * m)
    v = rng.uniform(size=(r, m)) < p
    if 0 < p < 1:
        v[r // 3] = False      # a ray with no valid candidate
        v[r // 2] = True       # a ray with all of them
    return v


@pytest.mark.parametrize("r,m,budget,p", CASES)
def test_k4_plain_matches_rayfold_and_pallas(r, m, budget, p):
    v = _valid(r, m, p)
    sel_t, kept_t = ck.compact_select_kernel(torch.from_numpy(v), budget)
    assert sel_t.dtype == torch.int32 and kept_t.dtype == torch.bool
    sel_j, kept_j = jr.compact_select_rayfold(jnp.asarray(v), budget)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    np.testing.assert_array_equal(kept_t.numpy(), np.asarray(kept_j))
    if budget <= (2 << 20) and (r * m) % 8 == 0:
        sel_p, kept_p = compact_select_pallas(jnp.asarray(v), budget,
                                              interpret=True)
        np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_p))
        np.testing.assert_array_equal(kept_t.numpy(), np.asarray(kept_p))


@pytest.mark.parametrize("n_blocks", [1, 2, 4])
def test_compact_select_blocks_match_jax(n_blocks):
    v = _valid(64, 128, 0.4, seed=n_blocks)
    got = tr.compact_select(torch.from_numpy(v), 2048, n_blocks=n_blocks)
    want = jr.compact_select(jnp.asarray(v), 2048, n_blocks=n_blocks)
    for name, g, w in zip(("sel", "kept", "rank"), got, want):
        g, w = g.numpy(), np.asarray(w)
        if name == "rank":        # garbage where not kept, in both
            g, w = g[np.asarray(want[1])], w[np.asarray(want[1])]
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("impl", ["rayfold", "xla", "pallas"])
@pytest.mark.parametrize("n_blocks", [1, 2])
def test_cpu_dispatch_matches_jax(impl, n_blocks):
    v = _valid(32, 128, 0.6, seed=7)
    sel_t, kept_t = tr._compact_sel_kept(torch.from_numpy(v), 1024, n_blocks,
                                         impl)
    sel_j, kept_j = jr._compact_sel_kept(jnp.asarray(v), 1024, n_blocks,
                                         impl)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    np.testing.assert_array_equal(kept_t.numpy(), np.asarray(kept_j))


def test_kernel_wrapper_counts_plain_calls_only_on_cuda():
    ck.reset_counts()
    ck.compact_select_kernel(torch.ones((4, 8), dtype=torch.bool), 16)
    assert ck.launches == {"compact_select": 0}
    assert ck.plain_cuda_calls == {"compact_select": 0}
