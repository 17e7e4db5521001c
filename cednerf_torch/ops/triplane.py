"""Tri-plane factored encoding — port of cednerf_tpu/ops/triplane.py
(`TriPlaneSpec`, `triplane_encode`), the reference's tri-plane swap option
(cednerf/taichi_kernel/triplane.py:61-157).

Three feature planes indexed by the coordinate pairs (y, z), (x, z),
(x, y); a geometric ladder of `n_levels` query scales that all read ONE
plane_res x plane_res plane per orientation (each level's cell corners are
scaled up into it, clamped to plane_res - 1, the JAX package's fix of the
reference's out-of-bounds read); bilinear interpolation per plane; and a
fourth feature group per level, the product of the three plane features.
Output per level: [plane_yz F, plane_xz F, plane_xy F, product F].

Plain PyTorch: the JAX function is XLA code with no Pallas kernel. The
interpolation and its backward are one autograd Function
(`_PlaneInterp`): the forward rounds where JAX's does, the backward forms
its terms in f32, sums each texel's terms through K3
(ops/scatter_kernels.py: in sample order, the same bits on every run) and
rounds the plane gradient once (see there). pos =
x*(scale - 1) + 0.5 is a product and a sum, each rounded to f32: XLA does
not contract this one into an FMA under jit (tests/test_torch_triplane.py
holds the two-rounding form to the jitted JAX encoder at rtol 1e-5; the
contracted form misses it). Memory: the corner values are [N, L, 3, 4, F] per call
(N x 96F values at L = 8), 1.6 GB in bf16 at F = 4 for a
2,097,152-sample pass.
"""

import dataclasses
import math

import numpy as np
import torch

from . import scatter_kernels as sk


@dataclasses.dataclass(frozen=True)
class TriPlaneSpec:
    """Static configuration (the reference's defaults: 8 levels, 2
    features, plane resolution 4096, base query scale 16)."""

    n_levels: int = 8
    n_features: int = 2
    plane_res: int = 4096
    base_res: int = 16

    @property
    def output_dim(self) -> int:
        return self.n_levels * 4 * self.n_features

    @property
    def scales(self) -> np.ndarray:
        """Per-level query scales (triplane.py:150-156), f32."""
        if self.n_levels == 1:
            return np.asarray([float(self.plane_res)], np.float32)
        log_b = math.log(self.plane_res / self.base_res) / (self.n_levels - 1)
        return np.asarray(
            [int(math.ceil(self.base_res * math.exp(lvl * log_b) - 1.0)) + 1
             for lvl in range(self.n_levels)], np.float32)

    @property
    def total_rows(self) -> int:
        return 3 * self.plane_res * self.plane_res

    def init_planes(self, generator: torch.Generator,
                    device="cpu") -> torch.Tensor:
        """Uniform(-1e-4, 1e-4) planes [3*R*R, F] (the JAX distribution, not
        its random stream)."""
        planes = torch.empty((self.total_rows, self.n_features),
                             dtype=torch.float32, device=device)
        return planes.uniform_(-1e-4, 1e-4, generator=generator)


class _PlaneInterp(torch.autograd.Function):
    """(planes [3*R*R, F], idx [N, L, 3, 4] corner rows, w2 [N, L, 3, 4, 2]
    f32 per-axis bilinear factors) -> [N, L*4F] in `dtype`.

    Forward, as JAX computes it in the compute dtype: the corner values
    cast to it, w = w2[..., 0] * w2[..., 1] rounded to it, the 4-corner
    sums and the three-way product in it. Backward in f32 from those
    values (as K6 forms the brick encoder's gradients in f32 where the JAX
    kernels take bf16 products): the product's rule, the plane gradient
    summed in f32 and rounded to the compute dtype once (JAX's cast point;
    its scatter-add runs in that dtype, one term at a time), and the
    factors' gradient for the position gradient. In bf16, gradients formed
    in bf16 part the card's step from the CPU's by ~2% (chip_smoke.py
    phase 15's first reading); formed in f32 they stay at the brick
    encoder's level."""

    @staticmethod
    def forward(ctx, planes, idx, w2, dtype):
        n, lvls = idx.shape[:2]
        f = planes.shape[1]
        rows = planes[idx.reshape(-1)].to(dtype).view(n, lvls, 3, 4, f)
        w = (w2[..., 0] * w2[..., 1]).to(dtype)
        feats = (rows * w[..., None]).sum(3)                   # [N, L, 3, F]
        prod = feats[:, :, 0] * feats[:, :, 1] * feats[:, :, 2]
        ctx.save_for_backward(idx, w2, rows, w, feats)
        ctx.shape, ctx.dtypes = planes.shape, (dtype, planes.dtype)
        out = torch.cat([feats.reshape(n, lvls, 3 * f), prod], dim=-1)
        return out.reshape(n, lvls * 4 * f)

    @staticmethod
    def backward(ctx, g_out):
        idx, w2, rows, w, feats = ctx.saved_tensors
        n, lvls = idx.shape[:2]
        f = rows.shape[-1]
        g = g_out.float().view(n, lvls, 4, f)
        fe = feats.float()
        g_prod = g[:, :, 3]
        g_feats = g[:, :, :3] + g_prod[:, :, None] * torch.stack(
            [fe[:, :, 1] * fe[:, :, 2], fe[:, :, 0] * fe[:, :, 2],
             fe[:, :, 0] * fe[:, :, 1]], dim=2)                 # [N, L, 3, F]
        d_planes = d_w2 = None
        if ctx.needs_input_grad[0]:
            terms = g_feats[:, :, :, None, :] * w.float()[..., None]
            # many samples share a texel: K3 sums each texel's terms in
            # sample order on the card (index_add_ would add them with
            # atomics, in another order on every run)
            d = sk.scatter_add_rows(idx.reshape(-1).to(torch.int32),
                                    terms.reshape(-1, f).contiguous(),
                                    ctx.shape[0])
            d_planes = d.to(ctx.dtypes[0]).to(ctx.dtypes[1])
        if ctx.needs_input_grad[2]:
            d_w = (g_feats[:, :, :, None, :] * rows.float()).sum(-1)
            d_w2 = torch.stack([d_w * w2[..., 1], d_w * w2[..., 0]], dim=-1)
        return d_planes, None, d_w2, None


# coordinate pairs of the planes, flat index a + b*R (triplane.py:86-120)
_PLANE_AXES = ((1, 2), (0, 2), (0, 1))
# bilinear corner offsets along the pair's two axes
_OFFS = ((0, 0), (1, 0), (0, 1), (1, 1))


def triplane_encode(x: torch.Tensor, planes: torch.Tensor,
                    spec: TriPlaneSpec,
                    compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x [N, 3] positions in [0, 1], planes [3*R*R, F] (plane-major) ->
    [N, n_levels*4*F] in compute_dtype."""
    r, dev = spec.plane_res, x.device
    sc = torch.from_numpy(spec.scales).to(dev)                     # [L] f32
    pos = x[:, None, :] * (sc - 1.0)[None, :, None] + 0.5        # [N, L, 3]
    base = torch.floor(pos).detach()
    frac = pos - base
    axes = torch.tensor(_PLANE_AXES, device=dev)                    # [3, 2]
    c0 = base[:, :, axes]                                     # [N, L, 3, 2]
    fr = frac[:, :, axes]
    offs = torch.tensor(_OFFS, device=dev)                          # [4, 2]
    corner = c0[:, :, :, None, :] + offs                   # [N, L, 3, 4, 2]
    frx = fr[:, :, :, None, :]
    w2 = torch.where(offs == 1, frx, 1.0 - frx)               # [N, L, 3, 4, 2]
    # the level's corners scaled up into the shared plane, clamped
    hi = (corner / sc[None, :, None, None, None] * float(r)).long()
    hi = hi.clamp(0, r - 1)
    plane_off = (torch.arange(3, device=dev) * (r * r))[None, None, :, None]
    idx = hi[..., 0] + hi[..., 1] * r + plane_off               # [N, L, 3, 4]
    return _PlaneInterp.apply(planes, idx, w2, compute_dtype)
