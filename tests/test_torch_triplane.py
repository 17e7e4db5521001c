"""The port's tri-plane encoder (cednerf_torch/ops/triplane.py) against
cednerf_tpu/ops/triplane.py, jitted as the package runs it (XLA leaves
pos = x*(scale - 1) + 0.5 a product and a sum there, as the port does).

f32 compute: the output within rtol 1e-5 / atol 1e-6, the plane and
position gradients within rtol 1e-4 / atol 1e-5 (products and the
scatter-add in another order). With one level XLA does contract pos into
an FMA (its scale is then a scalar), so there the output's atol is what
one f32 ulp of pos can move it: 4 ulp(plane_res), the bilinear weights'
slope (<= 1) times up to three +-1 features. bf16 compute: the output
within 2^-5 relative plus 2^-6 absolute at planes of +-1 (bf16 rounding of
the corner values, the weights, the 4-corner sums and the three-way
product).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.ops import triplane as jtp
from cednerf_torch.ops import triplane as ttp

SPECS = {"l8f2": dict(n_levels=8, n_features=2, plane_res=128, base_res=16),
         "l4f4": dict(n_levels=4, n_features=4, plane_res=64, base_res=8),
         "l1": dict(n_levels=1, n_features=2, plane_res=32)}


def _inputs(spec, seed, n=300):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    x[:8] = np.float32([0.0, 1.0, 0.5])[rng.integers(0, 3, (8, 3))]
    planes = rng.uniform(-1, 1, (spec.total_rows, spec.n_features)).astype(
        np.float32)
    cot = rng.normal(0, 1, (n, spec.output_dim)).astype(np.float32)
    return x, planes, cot


def _jax(spec, x, planes, cot, dtype):
    def loss(p, xx):
        out = jtp.triplane_encode(xx, p, spec, compute_dtype=dtype)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(planes),
                                             jnp.asarray(x))
    return np.asarray(out, np.float32), np.asarray(gp), np.asarray(gx)


def _port(spec, x, planes, cot, dtype):
    p = torch.tensor(planes, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out = ttp.triplane_encode(xt, p, spec, compute_dtype=dtype)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return out.detach().float().numpy(), p.grad.numpy(), xt.grad.numpy()


@pytest.mark.parametrize("name", list(SPECS))
def test_spec_matches_jax(name):
    js, ts = jtp.TriPlaneSpec(**SPECS[name]), ttp.TriPlaneSpec(**SPECS[name])
    np.testing.assert_array_equal(ts.scales, js.scales)
    assert (ts.output_dim, ts.total_rows) == (js.output_dim, js.total_rows)


@pytest.mark.parametrize("name", list(SPECS))
def test_triplane_f32_matches_jax(name):
    js, ts = jtp.TriPlaneSpec(**SPECS[name]), ttp.TriPlaneSpec(**SPECS[name])
    case = _inputs(js, 0)
    want = _jax(js, *case, jnp.float32)
    got = _port(ts, *case, torch.float32)
    atol = 1e-6 if ts.n_levels > 1 else 4 * float(
        np.spacing(np.float32(ts.plane_res)))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["l8f2", "l4f4"])
def test_triplane_bf16_matches_jax(name):
    js, ts = jtp.TriPlaneSpec(**SPECS[name]), ttp.TriPlaneSpec(**SPECS[name])
    x, planes, cot = _inputs(js, 1)
    want = _jax(js, x, planes, cot, jnp.bfloat16)[0]
    got = _port(ts, x, planes, cot, torch.bfloat16)[0]
    assert np.all(np.abs(got - want) <= 2.0 ** -5 * np.abs(want)
                  + 2.0 ** -6)
