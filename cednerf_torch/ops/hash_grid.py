"""Multiresolution hash grids — port of cednerf_tpu/ops/hash_grid.py: the
resolution schedule, the xor primes, the `HashGridSpec` the field hands to
the brick encoder, and the exact per-corner Instant-NGP encoder
(`hash_encode`, `hash_encode_4d`; `HashGridEncoder(impl="gather")`).

The per-corner encoder is plain PyTorch with autograd, as the JAX one is
XLA code with no Pallas kernel: one gather of the [N, L*8] corner rows of
a flat [total_rows, F (x K)] table, the trilinear weights, the sum. The
corner indices follow the JAX uint32 arithmetic (the cell base cast to
uint32 with wrap-around, dense "under hash" indexing below
`begin_fast_hash_level`, the xor-prime fast hash above it, modulo the
level size) in int64 masked to 32 bits, so they equal JAX's exactly; pos =
x*scale + 0.5 is rounded once, as XLA contracts it under jit (see
ops/encode_kernels.cell_geom). The 4D fraction is taken after clamping the
lower keyframe, so t = 1 lands on the last keyframe (the JAX package's
continuity fix over the reference).
"""

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

_U32 = 0xFFFFFFFF

# XOR primes of the reference fast hash (hash_encoder_half.py:71); the first
# dimension is multiplied by 1 (i.e. used raw).
_PRIMES = (1, 2654435761, 805459861)


def _align_to(x: int, y: int) -> int:
    return int((x + y - 1) // y) * y


def level_scale(level: int, log_b: float, base_res: float) -> float:
    """Grid scale of a level (hash_encoder_half.py:96-99)."""
    return base_res * math.exp(level * log_b) - 1.0


def level_resolution(scale: float) -> int:
    """Grid resolution of a level (hash_encoder_half.py:101-103)."""
    return int(math.ceil(scale)) + 1


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static configuration of a multiresolution grid (3D, or 4D with
    `time_keyframes` > 0). The brick-impl fields mirror BrickGridSpec."""

    n_levels: int = 16
    n_features: int = 2
    base_res: int = 16
    max_res: int = 4096
    log2_hashmap_size: int = 19
    time_keyframes: int = 0
    grad_accum_dtype: str = "float32"
    scatter_impl: str = "xla"
    interp_impl: str = "xla"
    max_table_rows: int = 16384
    fine_table_rows: int = 0
    fine_from_level: int = 5
    remat_feats: bool = False
    row_layout: str = "brick"
    cell_rows_cap: int = 524288

    @property
    def log_b(self) -> float:
        if self.n_levels == 1:
            return 0.0
        return math.log(self.max_res / self.base_res) / (self.n_levels - 1)

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features

    @property
    def row_features(self) -> int:
        return self.n_features * max(self.time_keyframes, 1)

    def _sizing(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
        """Per-level (resolutions, sizes, offsets), fast-hash start, total rows
        (hash_encoder_half.py:268-292)."""
        max_params = 2 ** self.log2_hashmap_size
        resolutions, sizes, offsets = [], [], []
        offset = 0
        begin_fast = self.n_levels
        for lvl in range(self.n_levels):
            res = level_resolution(level_scale(lvl, self.log_b, self.base_res))
            full = res ** 3
            size = min(max_params, _align_to(full, 8))
            resolutions.append(res)
            sizes.append(size)
            offsets.append(offset)
            if full > size and begin_fast == self.n_levels:
                begin_fast = lvl
            offset += size
        return (np.asarray(resolutions, np.int64), np.asarray(sizes, np.int64),
                np.asarray(offsets, np.int64), begin_fast, offset)

    @property
    def resolutions(self) -> np.ndarray:
        return self._sizing()[0]

    @property
    def sizes(self) -> np.ndarray:
        return self._sizing()[1]

    @property
    def offsets(self) -> np.ndarray:
        return self._sizing()[2]

    @property
    def begin_fast_hash_level(self) -> int:
        return self._sizing()[3]

    @property
    def total_rows(self) -> int:
        return self._sizing()[4]


def _corner_rows_and_weights(x: torch.Tensor, spec: HashGridSpec):
    """(rows [N, L, 8] int64 into the flat table, weights [N, L, 8] f32)
    for x [N, 3] f32; corner c's bit d selects the +1 along axis d."""
    dev = x.device
    scales = [float(np.float32(level_scale(lvl, spec.log_b, spec.base_res)))
              for lvl in range(spec.n_levels)]
    sc = torch.tensor(scales, dtype=torch.float64, device=dev)
    pos = (x.double()[:, None, :] * sc[None, :, None] + 0.5).float()
    pos_grid = torch.floor(pos).detach()
    frac = pos - pos_grid                                        # [N, L, 3]
    base = pos_grid.clamp(-2.0 ** 31, 2.0 ** 31 - 1).long() & _U32
    c = torch.arange(8, device=dev)
    bits = torch.stack([(c >> d) & 1 for d in range(3)], dim=1)   # [8, 3]
    cpos = (base[:, :, None, :] + bits) & _U32                # [N, L, 8, 3]
    fr = frac[:, :, None, :]
    w3 = torch.where(bits == 1, fr, 1.0 - fr)                  # [N, L, 8, 3]
    w = (w3[..., 0] * w3[..., 1]) * w3[..., 2]
    res = torch.tensor(spec.resolutions, device=dev)[None, :, None]
    sizes = torch.tensor(spec.sizes, device=dev)[None, :, None]
    offsets = torch.tensor(spec.offsets, device=dev)[None, :, None]
    x0, x1, x2 = cpos[..., 0], cpos[..., 1], cpos[..., 2]
    dense = (x0 + ((x1 * res) & _U32) + ((((x2 * res) & _U32) * res) & _U32)
             ) & _U32
    fast = x0 ^ ((x1 * _PRIMES[1]) & _U32) ^ ((x2 * _PRIMES[2]) & _U32)
    level = torch.arange(spec.n_levels, device=dev)[None, :, None]
    idx = torch.where(level < spec.begin_fast_hash_level, dense, fast)
    return idx % sizes + offsets, w


def hash_encode(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """3D per-corner hash encoding: x [N, 3] unit-cube positions, table
    [total_rows, F] -> [N, L*F] in compute_dtype (corner values and weights
    cast to compute_dtype, their products summed over the 8 corners)."""
    if spec.time_keyframes:
        raise ValueError("hash_encode: a 4D spec takes hash_encode_4d")
    n = x.shape[0]
    rows, w = _corner_rows_and_weights(x.float(), spec)
    feats = table[rows.reshape(n, -1)].to(compute_dtype)     # [N, L*8, F]
    feats = feats * w.reshape(n, -1, 1).to(compute_dtype)
    return feats.reshape(n, spec.n_levels, 8, spec.n_features).sum(
        2).reshape(n, spec.output_dim)


def hash_encode_4d(x: torch.Tensor, t: torch.Tensor, table: torch.Tensor,
                   spec: HashGridSpec,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """4D (xyz + t) per-corner hash encoding: each table row holds K
    keyframe slices of F features; t [N, 1] in [0, 1] lerps the two
    keyframes around t*(K - 1) (lower index clamped to K - 2 first).
    table [total_rows, F*K] -> [N, L*F] in compute_dtype."""
    k = spec.time_keyframes
    if k < 2:
        raise ValueError("hash_encode_4d: needs time_keyframes >= 2")
    n, f = x.shape[0], spec.n_features
    rows, w = _corner_rows_and_weights(x.float(), spec)
    feats = table[rows.reshape(n, -1)].reshape(n, spec.n_levels, 8, k, f)
    t_scaled = t.reshape(n).float() * float(k - 1)
    idx_lo = torch.floor(t_scaled).clamp(0, k - 2).detach()
    t_frac = (t_scaled - idx_lo).to(compute_dtype)
    at = idx_lo.long()[:, None, None, None, None].expand(
        n, spec.n_levels, 8, 1, f)
    lo = feats.gather(3, at)[..., 0, :].to(compute_dtype)
    hi = feats.gather(3, at + 1)[..., 0, :].to(compute_dtype)
    tf = t_frac[:, None, None, None]
    slices = lo * (1 - tf) + hi * tf
    out = (slices * w[..., None].to(compute_dtype)).sum(2)
    return out.reshape(n, spec.output_dim)
