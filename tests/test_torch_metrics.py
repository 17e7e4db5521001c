"""The port's image metrics against the JAX package's: PSNR, SSIM and
MS-SSIM on numpy-drawn image pairs at 32x32 (MS-SSIM drops the scales
whose pooled size falls under the 11-tap window and renormalizes the
weights), 200x200 (all 5 scales, an even pooling) and 161x173 (odd
sizes, edge-padded pooling), in [H, W, C] and [N, C, H, W] layouts.
Within 1e-5 absolute (f32 convolutions summed in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.utils import metrics as jm
from cednerf_torch.utils import metrics as tm


def _pair(h, w, seed):
    """A smooth image and a noisy, shifted copy: SSIM well inside (0, 1)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.3 * np.sin(x[..., None] * np.array([0.11, 0.07, 0.05])
                              + y[..., None] * np.array([0.05, 0.13, 0.02]))
    noisy = base + rng.normal(0, 0.08, base.shape)
    return (np.clip(base, 0, 1).astype(np.float32),
            np.clip(noisy, 0, 1).astype(np.float32))


@pytest.mark.parametrize("h,w", [(32, 32), (200, 200), (161, 173)])
def test_ssim_and_ms_ssim_match_jax(h, w):
    a, b = _pair(h, w, h + w)
    for fn in ("psnr", "ssim", "ms_ssim"):
        want = float(getattr(jm, fn)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(tm, fn)(a, b).item()
        assert np.isfinite(got) and (fn == "psnr" or 0.05 < got < 0.999)
        np.testing.assert_allclose(got, want, atol=1e-5 if fn != "psnr"
                                   else 1e-4, err_msg=fn)


def test_metrics_take_nchw_tensors():
    a, b = _pair(64, 48, 0)
    ta = torch.from_numpy(a).permute(2, 0, 1)[None]
    tb = torch.from_numpy(b).permute(2, 0, 1)[None]
    for fn in ("ssim", "ms_ssim"):
        want = float(getattr(jm, fn)(jnp.asarray(np.asarray(ta)),
                                     jnp.asarray(np.asarray(tb))))
        np.testing.assert_allclose(getattr(tm, fn)(ta, tb).item(), want,
                                   atol=1e-5, err_msg=fn)
        np.testing.assert_allclose(getattr(tm, fn)(a, b).item(), want,
                                   atol=1e-5, err_msg=fn)
    assert tm.ms_ssim(a, a).item() == pytest.approx(1.0, abs=1e-5)
