"""The port's TexturedCloudScene (cednerf_torch/datasets/procedural.py)
against the JAX package's (cednerf_tpu/datasets/procedural.py): the same
balls and texture from the same seed, the same ground-truth pixels on the
host (batches, eval views, image rays: numpy on both sides, equal), and
the device sampler's assembly (`sample_at`) on the draws of JAX's own
device sampler against that sampler's batch: origins and directions within
1e-5 (float32 rays computed by XLA and by torch), times and background
equal, pixels within 1e-3: the texture is a product of three sines of the
hit point at up to 120 rad/unit, so a float32 difference of ~1e-6 in the
hit point moves a textured pixel by up to ~3 x 0.45 x 120 x 1e-6 (3.2e-4
seen on these draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cednerf_tpu.datasets.procedural import TexturedCloudScene as JTexture
from cednerf_torch.datasets.procedural import TexturedCloudScene

KW = dict(n_cams=5, wh=24, n_times=3, n_balls=16, seed=2)


def test_scene_and_host_pixels_match_jax():
    j, t = JTexture(**KW), TexturedCloudScene(**KW)
    for k in ("centers0", "vels", "radii", "colors", "tex_freq",
              "tex_phase", "times", "c2ws", "K"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k),
                                      err_msg=k)
    for _ in range(2):
        bj, bt = j.sample(400), t.sample(400)
        assert bj.keys() == bt.keys()
        for k in bj:
            np.testing.assert_array_equal(bt[k], np.asarray(bj[k]),
                                          err_msg=k)
    for a, b in zip(t.eval_view(0.3, 0.5), j.eval_view(0.3, 0.5)):
        np.testing.assert_array_equal(a, b)
    it, ij = t.image_rays(1, 0.25), j.image_rays(1, 0.25)
    for k in ("origins", "viewdirs", "pixels"):
        np.testing.assert_array_equal(it[k], ij[k], err_msg=k)
    # textured hits: colours modulated within [0.1, 1.0] of the ball's
    px = it["pixels"].reshape(-1, 3)
    hit = ~np.all(px == 1.0, axis=-1)
    assert 0.05 < hit.mean() < 0.95


def _jax_draws(key, n_rays, n_cams, n_times, wh):
    """The draws of JAX's device sampler for `key` (its split and order)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    cam = jax.random.randint(k1, (n_rays,), 0, n_cams)
    ti = jax.random.randint(k2, (n_rays,), 0, n_times)
    x = jax.random.randint(k3, (n_rays,), 0, wh).astype(jnp.float32)
    y = jax.random.randint(k4, (n_rays,), 0, wh).astype(jnp.float32)
    return [np.asarray(a) for a in (cam, ti, x, y)]


def test_device_sampler_assembly_on_jax_draws():
    j, t = JTexture(**KW), TexturedCloudScene(**KW)
    jdata, jsample = j.device_sampler()
    data, sample_fn = t.device_sampler(device="cpu")
    for seed in (0, 1):
        key = jax.random.PRNGKey(seed)
        want = {k: np.asarray(v) for k, v in
                jax.jit(lambda d, kk: jsample(d, kk, 512))(jdata, key).items()}
        cam, ti, x, y = _jax_draws(key, 512, len(j.c2ws), len(j.times), j.wh)
        got = t.sample_at(data, torch.from_numpy(cam), torch.from_numpy(ti),
                          torch.from_numpy(x), torch.from_numpy(y))
        assert got.keys() == want.keys()
        for k, atol in (("origins", 1e-5), ("viewdirs", 1e-5),
                        ("pixels", 1e-3)):
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=atol,
                                       err_msg=k)
        np.testing.assert_array_equal(got["timestamps"].numpy(),
                                      want["timestamps"])
        np.testing.assert_array_equal(got["color_bkgd"].numpy(),
                                      want["color_bkgd"])
        tex = ~np.all(want["pixels"] == 1.0, axis=-1)
        assert 0.05 < tex.mean() < 0.95
    # the port's sampler draws from its generator: reproducible, in range
    b1 = sample_fn(data, torch.Generator().manual_seed(9), 64)
    b2 = sample_fn(data, torch.Generator().manual_seed(9), 64)
    for k in b1:
        assert torch.equal(b1[k], b2[k]), k
    assert b1["pixels"].shape == (64, 3)
