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


def row_cumsum(x: torch.Tensor, width: int = 1024) -> torch.Tensor:
    """Inclusive cumsum of a 1-D tensor that gives the same bits on every
    run. PyTorch scans a tensor whose length is its numel with cub's
    single-pass scan on the card, whose float sums take an order that
    changes from run to run (tools/render_trace.py found it parting two
    renders of one checkpoint); here x is scanned as rows of `width` (each
    row in a fixed order) plus the exclusive prefix of the row totals,
    both along the last dim of a tensor of two rows or more."""
    n = x.numel()
    rows = max(-(-n // width), 2)
    m = torch.cat([x, x.new_zeros(rows * width - n)]).view(rows, width)
    scan = torch.cumsum(m, 1)
    tot = scan[:, -1]
    carry = torch.cumsum(torch.stack([tot, torch.zeros_like(tot)]), 1)[0]
    return (scan + (carry - tot)[:, None]).view(-1)[:n]
