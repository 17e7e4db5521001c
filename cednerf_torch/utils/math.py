"""Small math utilities (port of cednerf_tpu/utils/math.py)."""

import torch
import torch.nn.functional as F


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


def fixed_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """torch.cumsum(x, dim) that gives the same bits on every run. A float
    tensor whose length along dim is its numel (a 1-D tensor, a [1, B]
    row) goes through row_cumsum: PyTorch scans it with cub's single-pass
    scan on the card. Any other shape is a batch of rows of the same
    length, which PyTorch scans one row at a time in a fixed order. The
    backward of either is the same scans reversed."""
    if x.is_floating_point() and x.numel() > 1 and x.numel() == x.shape[dim]:
        return row_cumsum(x.reshape(-1)).reshape(x.shape)
    return torch.cumsum(x, dim=dim)


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Cumulative sum shifted right by one (first element is zero), as the
    JAX version forms it: cumsum(x) - x (fixed_cumsum)."""
    return fixed_cumsum(x, dim) - x


_BEFORE = {}


def row_cumsum(x: torch.Tensor, width: int = 1024) -> torch.Tensor:
    """Inclusive cumsum along the last dim that gives the same bits on every
    run. PyTorch scans a tensor whose length is its numel with cub's
    single-pass scan on the card, whose float sums take an order that
    changes from run to run (tools/render_trace.py found it parting two
    renders of one checkpoint); and it scans a few long rows with a few
    blocks. Here each row of x [..., n] is cut into blocks of `width`,
    each block scanned in a fixed order (a tensor of two blocks or more),
    and the totals of the blocks before it added: one product by a
    strictly upper-triangular ones matrix (cuBLAS, a fixed order), cached
    for the block count. Its backward is the same ops' backward."""
    n = x.shape[-1]
    blocks = max(-(-n // width), 2)
    scan = torch.cumsum(F.pad(x, (0, blocks * width - n)).reshape(
        -1, blocks, width), -1)
    key = (blocks, x.dtype, x.device)
    if key not in _BEFORE:
        # a normal tensor even when made under inference_mode (an eval
        # render), so that a train step's autograd may save it later
        with torch.inference_mode(False):
            _BEFORE[key] = torch.ones((blocks, blocks), dtype=x.dtype,
                                      device=x.device).triu(1)
    out = scan + (scan[..., -1] @ _BEFORE[key])[..., None]
    return out.reshape(*x.shape[:-1], blocks * width)[..., :n]
