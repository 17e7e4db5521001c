"""Multiresolution hash-grid sizing (port of cednerf_tpu/ops/hash_grid.py).

This slice needs the resolution schedule, the xor primes and the
`HashGridSpec` the field hands to the brick encoder. The exact per-corner
`hash_encode` / `hash_encode_4d` come with a later slice.
"""

import dataclasses
import math
from typing import Tuple

import numpy as np

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
