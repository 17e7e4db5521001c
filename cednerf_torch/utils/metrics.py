"""Image metrics for the port, as in cednerf_tpu/utils/metrics.py: PSNR,
SSIM and MS-SSIM (torch) and the turbo depth colormap (numpy).

MS-SSIM follows pytorch_msssim.ms_ssim, the reference's eval metric
(train_real.py:497-499): gaussian window 11 / sigma 1.5, K = (0.01, 0.03),
5 scales with the standard weights, 2x average pooling between scales,
relu'd contrast terms. The blur is a depthwise F.conv2d, the plain
counterpart of the JAX package's conv_general_dilated.
"""

import numpy as np
import torch
import torch.nn.functional as F

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def psnr(pred, target, data_range: float = 1.0) -> torch.Tensor:
    pred = torch.as_tensor(pred, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / mse)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable valid-mode gaussian blur of [N, C, H, W] (depthwise)."""
    c = img.shape[1]
    k = torch.as_tensor(kernel, dtype=img.dtype, device=img.device)
    out = F.conv2d(img, k.reshape(1, 1, -1, 1).expand(c, 1, -1, 1),
                   groups=c)
    return F.conv2d(out, k.reshape(1, 1, 1, -1).expand(c, 1, 1, -1),
                    groups=c)


def _ssim_and_cs(x, y, data_range: float, k1: float = 0.01,
                 k2: float = 0.03):
    """Mean SSIM and contrast sensitivity of [N, C, H, W] images."""
    kernel = _gaussian_kernel()
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _blur(x, kernel)
    mu_y = _blur(y, kernel)
    sigma_x = _blur(x * x, kernel) - mu_x ** 2
    sigma_y = _blur(y * y, kernel) - mu_y ** 2
    sigma_xy = _blur(x * y, kernel) - mu_x * mu_y
    cs_map = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    ssim_map = ((2 * mu_x * mu_y + c1) / (mu_x ** 2 + mu_y ** 2 + c1)) \
        * cs_map
    return ssim_map.mean(), cs_map.mean()


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x average pooling with odd-dim edge padding (pytorch_msssim)."""
    pad_h, pad_w = x.shape[2] % 2, x.shape[3] % 2
    if pad_h or pad_w:
        x = F.pad(x, (0, pad_w, 0, pad_h), mode="replicate")
    return F.avg_pool2d(x, 2)


def _to_nchw(img) -> torch.Tensor:
    img = (img.float() if isinstance(img, torch.Tensor)
           else torch.as_tensor(np.asarray(img, np.float32)))
    if img.dim() == 3:  # [H, W, C]
        img = img[None]
    if img.shape[-1] in (1, 3) and img.shape[1] not in (1, 3):
        img = img.permute(0, 3, 1, 2)
    return img


def ssim(pred, target, data_range: float = 1.0) -> torch.Tensor:
    """Single-scale SSIM of [H, W, C] (or [N, C, H, W]) images."""
    s, _ = _ssim_and_cs(_to_nchw(pred), _to_nchw(target), data_range)
    return s


def ms_ssim(pred, target, data_range: float = 1.0) -> torch.Tensor:
    """Multi-scale SSIM of [H, W, C] (or [N, C, H, W]) images in [0, range].

    The full 5 scales need min(H, W) > 160 (pytorch_msssim raises below);
    a smaller image drops the scales whose pooled size falls under the
    11-tap window and renormalizes the remaining weights, instead of
    producing NaN."""
    x, y = _to_nchw(pred), _to_nchw(target)
    levels = 1
    h, w = x.shape[2], x.shape[3]
    while levels < len(MSSSIM_WEIGHTS) and min(h, w) >= 2 * 11:
        levels += 1
        h, w = (h + 1) // 2, (w + 1) // 2
    vals = []
    for i in range(levels):
        s, cs = _ssim_and_cs(x, y, data_range)
        vals.append(s if i == levels - 1 else cs)
        if i < levels - 1:
            x, y = _avg_pool2(x), _avg_pool2(y)
    vals = torch.relu(torch.stack(vals))   # relu'd like pytorch_msssim
    weights = torch.tensor(MSSSIM_WEIGHTS[:levels], dtype=torch.float32,
                           device=vals.device)
    if levels < len(MSSSIM_WEIGHTS):
        weights = weights / weights.sum()
    return torch.prod(vals ** weights)


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
