"""Parameter-free encoders, trunc_exp, hash-grid sizing and metrics of the
port against the JAX package (f32: rtol 1e-6; sin/exp of the same f32
inputs differ by a few ulp between XLA's and torch's CPU math)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.ops import encoders as jenc
from cednerf_tpu.ops import hash_grid as jhg
from cednerf_tpu.utils import math as jmath
from cednerf_tpu.utils import metrics as jmetrics
from cednerf_torch.ops import encoders as tenc
from cednerf_torch.ops import hash_grid as thg
from cednerf_torch.utils import math as tmath
from cednerf_torch.utils import metrics as tmetrics

RNG = np.random.default_rng(0)
X = RNG.uniform(-1.5, 1.5, (257, 4)).astype(np.float32)
V = RNG.uniform(0, 0.2, (257, 1)).astype(np.float32)


@pytest.mark.parametrize("min_deg,max_deg,ident", [(0, 4, True), (1, 3, False),
                                                   (2, 2, True)])
def test_sinusoidal_encode(min_deg, max_deg, ident):
    want = np.asarray(jenc.sinusoidal_encode(jnp.asarray(X), min_deg, max_deg,
                                             ident))
    got = tenc.sinusoidal_encode(torch.from_numpy(X), min_deg, max_deg, ident)
    assert got.shape[-1] == want.shape[-1]
    if min_deg != max_deg:
        assert want.shape[-1] == tenc.sinusoidal_latent_dim(4, min_deg,
                                                            max_deg, ident)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_sinusoidal_encode_with_exp_and_sh():
    want = np.asarray(jenc.sinusoidal_encode_with_exp(
        jnp.asarray(X[:, :1]), jnp.asarray(V), 0, 4))
    got = tenc.sinusoidal_encode_with_exp(torch.from_numpy(X[:, :1]),
                                          torch.from_numpy(V), 0, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    d = X[:, :3] / np.linalg.norm(X[:, :3], axis=-1, keepdims=True)
    np.testing.assert_allclose(
        tenc.sh_encode_deg2(torch.from_numpy(d)).numpy(),
        np.asarray(jenc.sh_encode_deg2(jnp.asarray(d))), rtol=1e-6)
    np.testing.assert_allclose(
        tmath.trunc_exp(torch.from_numpy(X)).numpy(),
        np.asarray(jmath.trunc_exp(jnp.asarray(X))), rtol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"n_levels": 8, "n_features": 4,
                                     "max_res": 1024, "log2_hashmap_size": 21},
                                {"n_levels": 1}])
def test_hash_grid_sizing(kw):
    t, j = thg.HashGridSpec(**kw), jhg.HashGridSpec(**kw)
    for name in ("resolutions", "sizes", "offsets"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert (t.begin_fast_hash_level, t.total_rows, t.output_dim, t.log_b) \
        == (j.begin_fast_hash_level, j.total_rows, j.output_dim, j.log_b)
    assert thg._PRIMES == jhg._PRIMES


def test_psnr_and_depth_to_img():
    a = RNG.uniform(size=(16, 16, 3)).astype(np.float32)
    b = np.clip(a + RNG.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(tmetrics.psnr(a, b)),
                               float(jmetrics.psnr(a, b)), rtol=1e-5)
    dep = RNG.uniform(2, 5, (16, 16, 1)).astype(np.float32)
    np.testing.assert_array_equal(tmetrics.depth_to_img(dep[..., 0]),
                                  jmetrics.depth_to_img(dep[..., 0]))
