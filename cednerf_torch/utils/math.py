"""Small math utilities (port of cednerf_tpu/utils/math.py)."""

import torch


class _TruncExp(torch.autograd.Function):
    """exp(x); the backward clamps the pre-activation at 15 so that huge
    pre-activations cannot blow up the gradient (reference
    cednerf/utils.py:27-43)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, max=15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """Density activation: exp(x) in the input's dtype, with the truncated
    backward of the JAX version's custom_vjp."""
    return _TruncExp.apply(x)


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Cumulative sum shifted right by one (first element is zero), as the
    JAX version forms it: cumsum(x) - x."""
    return torch.cumsum(x, dim=dim) - x
