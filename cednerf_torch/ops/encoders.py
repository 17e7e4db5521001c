"""Parameter-free input encodings: sinusoidal (NeRF PE) and spherical
harmonics. Port of cednerf_tpu/ops/encoders.py with the same layouts:

  * SinusoidalEncoder        — cednerf/encoder.py:6-44
  * SinusoidalEncoderWithExp — cednerf/encoder.py:46-91 (frequency i damped
    by exp(-x_var * i * 2^i))
  * SH degree 2 (l <= 1)     — cednerf/model.py:226-239 role
"""

import math

import torch


def sinusoidal_latent_dim(x_dim: int, min_deg: int, max_deg: int,
                          use_identity: bool = True) -> int:
    return (int(use_identity) + (max_deg - min_deg) * 2) * x_dim


def _pow2(min_deg: int, max_deg: int, like: torch.Tensor) -> torch.Tensor:
    """[2^min_deg, ..., 2^(max_deg-1)] made on like's device (exact powers
    of two): a tensor built from a Python list would be a host upload, and
    a host sync, on every call."""
    return torch.exp2(torch.arange(min_deg, max_deg, dtype=like.dtype,
                                   device=like.device))


def sinusoidal_encode(x: torch.Tensor, min_deg: int, max_deg: int,
                      use_identity: bool = True) -> torch.Tensor:
    """[..., D] -> [..., (use_identity + 2*(max_deg-min_deg)) * D] laid out as
    [x?, sin(x*2^i) for all (i, d), cos(x*2^i) for all (i, d)]."""
    if max_deg == min_deg:
        return x
    scales = _pow2(min_deg, max_deg, x)
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    latent = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    if use_identity:
        latent = torch.cat([x, latent], dim=-1)
    return latent


def sinusoidal_encode_with_exp(x: torch.Tensor, x_var: torch.Tensor,
                               min_deg: int, max_deg: int,
                               use_identity: bool = True) -> torch.Tensor:
    """Sinusoidal encoding with per-frequency damping exp(-x_var * i * 2^i).

    x: [..., D]; x_var: [..., 1] non-negative damping magnitude."""
    if max_deg == min_deg:
        return x
    scales = _pow2(min_deg, max_deg, x)
    scales_move = torch.arange(min_deg, max_deg, dtype=x.dtype,
                               device=x.device) * scales
    n_deg = max_deg - min_deg
    d = x.shape[-1]
    xb = x[..., None, :] * scales[:, None]                       # [..., n, D]
    damp = torch.exp(-(x_var[..., None, :] * scales_move[:, None])[..., 0])
    latent = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    latent = latent * damp[..., None]
    latent = latent.reshape(*x.shape[:-1], n_deg * d * 2)
    if use_identity:
        latent = torch.cat([x, latent], dim=-1)
    return latent


_SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199


def sh_encode_deg2(dirs: torch.Tensor) -> torch.Tensor:
    """Degree-2 real SH basis (4 coefficients) of unit directions: [..., 4]."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    return torch.stack(
        [torch.full_like(x, _SH_C0), -_SH_C1 * y, _SH_C1 * z, -_SH_C1 * x],
        dim=-1)
