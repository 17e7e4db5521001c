"""Image metrics for the port: PSNR (torch) and the turbo depth colormap
(numpy), as in cednerf_tpu/utils/metrics.py. SSIM and MS-SSIM come with the
evaluation slice."""

import numpy as np
import torch


def psnr(pred, target, data_range: float = 1.0) -> torch.Tensor:
    pred = torch.as_tensor(pred, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / mse)


# Turbo colormap (depth visualization): the published polynomial
# approximation, replacing cv2.COLORMAP_TURBO (train_real.py:38-43).
_TURBO_R = np.array([0.13572138, 4.61539260, -42.66032258, 132.13108234,
                     -152.94239396, 59.28637943])
_TURBO_G = np.array([0.09140261, 2.19418839, 4.84296658, -14.18503333,
                     4.27729857, 2.82956604])
_TURBO_B = np.array([0.10667330, 12.64194608, -60.58204836, 110.36276771,
                     -89.90310912, 27.34824973])


def _turbo_poly(coef, x):
    return sum(c * x ** i for i, c in enumerate(coef))


def depth_to_img(depth) -> np.ndarray:
    """Normalize a depth map and colorize it with Turbo -> uint8 [H, W, 3]."""
    depth = np.asarray(depth, np.float32)
    depth = depth.reshape(depth.shape[0], depth.shape[1])
    lo, hi = depth.min(), depth.max()
    x = (depth - lo) / max(hi - lo, 1e-8)
    rgb = np.stack([_turbo_poly(_TURBO_R, x), _turbo_poly(_TURBO_G, x),
                    _turbo_poly(_TURBO_B, x)], axis=-1)
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
