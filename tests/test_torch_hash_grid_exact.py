"""The exact per-corner Instant-NGP encoder of the port
(cednerf_torch/ops/hash_grid.py: `hash_encode`, `hash_encode_4d`, the
corner indices) against cednerf_tpu/ops/hash_grid.py, run under jax.jit as
the package runs it (XLA contracts pos = x*scale + 0.5 into one FMA there;
the port rounds pos once the same way).

Corner rows are integers and must be equal. Outputs and gradients in f32:
rtol 1e-5 / atol 1e-6 for the output and rtol 1e-4 / atol 1e-5 for the
table, position and time gradients (products and sums taken in another
order: the weight product, the scatter-add of the table gradient). In
bf16 compute the output is held to 2^-6 relative plus 2^-6 of the table
scale (the corner values, weights and products each rounded to bf16, the
8-corner sum in another order and precision).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.ops import hash_grid as jhg
from cednerf_torch.ops import hash_grid as thg

SPECS = {
    # dense levels below begin_fast_hash_level, hashed above
    "3d": dict(n_levels=6, n_features=2, base_res=8, max_res=256,
               log2_hashmap_size=12),
    "3d_f4": dict(n_levels=4, n_features=4, base_res=16, max_res=128,
                  log2_hashmap_size=14),
    "4d": dict(n_levels=5, n_features=2, base_res=8, max_res=128,
               log2_hashmap_size=12, time_keyframes=4),
}


def _inputs(spec, seed, n=400):
    rng = np.random.default_rng(seed)
    # some points outside the unit cube: negative cells wrap in uint32
    x = rng.uniform(-0.2, 1.2, (n, 3)).astype(np.float32)
    t = rng.uniform(0.01, 0.99, (n, 1)).astype(np.float32)
    t[:4, 0] = [0.0, 1.0, 1.0 / 3.0, 2.0 / 3.0]
    table = rng.uniform(-1, 1, (spec.total_rows, spec.row_features)).astype(
        np.float32)
    cot = rng.normal(0, 1, (n, spec.output_dim)).astype(np.float32)
    return x, t, table, cot


@pytest.mark.parametrize("name", list(SPECS))
def test_corner_rows_and_weights_match_jax(name):
    jspec, tspec = jhg.HashGridSpec(**SPECS[name]), thg.HashGridSpec(
        **SPECS[name])
    assert tspec._sizing()[3:] == jspec._sizing()[3:]
    for a, b in zip(tspec._sizing()[:3], jspec._sizing()[:3]):
        np.testing.assert_array_equal(a, b)
    x = _inputs(jspec, 0)[0]
    rows_j, w_j = jax.jit(lambda xx: jhg._corner_indices_and_weights(
        xx, jspec))(jnp.asarray(x))
    rows_t, w_t = thg._corner_rows_and_weights(torch.from_numpy(x), tspec)
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6,
                               atol=1e-7)


def _jax(spec_kw, x, t, table, cot, dtype):
    spec = jhg.HashGridSpec(**spec_kw)

    def loss(tab, xx, tt):
        out = (jhg.hash_encode_4d(xx, tt, tab, spec, compute_dtype=dtype)
               if spec.time_keyframes else
               jhg.hash_encode(xx, tab, spec, compute_dtype=dtype))
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(table), jnp.asarray(x), jnp.asarray(t))
    return [np.asarray(out, np.float32)] + [np.asarray(g) for g in grads]


def _port(spec_kw, x, t, table, cot, dtype):
    spec = thg.HashGridSpec(**spec_kw)
    tab = torch.tensor(table, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    out = (thg.hash_encode_4d(xt, tt, tab, spec, compute_dtype=dtype)
           if spec.time_keyframes else
           thg.hash_encode(xt, tab, spec, compute_dtype=dtype))
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return [out.detach().float().numpy(), tab.grad.numpy(),
            xt.grad.numpy(),
            tt.grad.numpy() if spec.time_keyframes else np.zeros_like(t)]


@pytest.mark.parametrize("name", list(SPECS))
def test_hash_encode_f32_matches_jax(name):
    spec = jhg.HashGridSpec(**SPECS[name])
    case = _inputs(spec, 1)
    want = _jax(SPECS[name], *case, jnp.float32)
    got = _port(SPECS[name], *case, torch.float32)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    for i, what in ((1, "table"), (2, "x"), (3, "t")):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-5,
                                   err_msg=what)
    assert np.abs(want[2]).max() > 0 and np.abs(want[1]).max() > 0


@pytest.mark.parametrize("name", list(SPECS))
def test_hash_encode_bf16_matches_jax(name):
    spec = jhg.HashGridSpec(**SPECS[name])
    x, t, table, cot = _inputs(spec, 2)
    want = _jax(SPECS[name], x, t, table, cot, jnp.bfloat16)[0]
    got = _port(SPECS[name], x, t, table, cot, torch.bfloat16)[0]
    assert np.all(np.abs(got - want) <= 2.0 ** -6 * np.abs(want)
                  + 2.0 ** -6)


def test_hash_encode_4d_end_keyframes():
    """t = 0 reads keyframe 0 and t = 1 the last keyframe (the fraction is
    taken after the clamp), as the JAX encoder."""
    spec = thg.HashGridSpec(**SPECS["4d"])
    x, _, table, _ = _inputs(spec, 3, n=16)
    tab = torch.from_numpy(table)
    k, f = spec.time_keyframes, spec.n_features
    for tv, key in ((0.0, 0), (1.0, k - 1)):
        out = thg.hash_encode_4d(torch.from_numpy(x),
                                 torch.full((16, 1), tv), tab, spec,
                                 compute_dtype=torch.float32)
        ref = thg.hash_encode(
            torch.from_numpy(x), tab.view(-1, k, f)[:, key].contiguous(),
            thg.HashGridSpec(**{**SPECS["4d"], "time_keyframes": 0}),
            compute_dtype=torch.float32)
        torch.testing.assert_close(out, ref)
