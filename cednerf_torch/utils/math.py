"""Small math utilities (port of cednerf_tpu/utils/math.py)."""

import torch


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """Density activation, forward only: exp(x) in the input's dtype.

    The JAX version's backward clamps the pre-activation at 15
    (reference cednerf/utils.py:27-43); that gradient arrives with the
    training slice as an autograd.Function."""
    return torch.exp(x)
