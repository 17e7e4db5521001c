"""Dynamic NGP radiance field and the proposal sampler's density field —
port of cednerf_tpu/models/field.py.

Same modules, names and math as the flax version (reference
cednerf/model.py:97-488): a frequency-encoded motion-warp MLP, the brick
hash encoder, time embeddings with motion attenuation, the density head
(trunc_exp(x - 1) * in-AABB selector) and the view-dependent colour head.
MLPs keep fp32 parameters and compute in bf16. Parameter names follow the
flax tree (`motion_mlp.hidden_0.weight` <- `motion_mlp/hidden_0/kernel`,
transposed), so bridge.py moves weights across unchanged.

`return_internal=True` adds the loss internals of the train step (move,
selector, the feat-prediction and weight-prediction heads' outputs).
`grid_type`: "hash3d" (the motion-warped 3D grid), "hash4d" (the same grid
with `time_keyframes` keyframes per table row, queried at (xn, t)) or
"triplane" (the factored tri-plane encoder, ops/triplane.py, at
plane_res = dst_resolution and F = n_features_per_level).
`encoder_impl`: "brick" (ops/brick_grid.py, the kernels) or "gather" (the
exact per-corner encoder, ops/hash_grid.py, a `table` parameter).
`hash4motion`: the motion warp reads a brick `motion_grid` (L8 F2,
16 -> 2048, 2^19, the JAX defaults otherwise: on CUDA K5 and K6 at F = 2)
of the field-normalised position, concatenated with the time's frequency
encoding, into a 1-hidden-layer `motion_mlp` (reference model.py:165-199).
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.brick_grid import BrickGridSpec, brick_encode
from ..ops.encoders import (sh_encode_deg2, sinusoidal_encode,
                            sinusoidal_encode_with_exp, sinusoidal_latent_dim)
from ..ops.hash_grid import HashGridSpec, hash_encode, hash_encode_4d
from ..ops.triplane import TriPlaneSpec, triplane_encode
from ..utils.math import trunc_exp

DEFAULT_MOVING_STEP = 1.0 / 4096.0  # model.py:26

# flax's lecun_normal: truncated normal at +-2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def huber(pred, target, delta: float = 1.0):
    """Elementwise Huber loss (torch F.huber_loss, reduction='none'), in the
    JAX package's form."""
    d = pred - target
    abs_d = d.abs()
    return torch.where(abs_d < delta, 0.5 * d * d,
                       delta * (abs_d - 0.5 * delta))


def contract_to_unisphere(x, aabb_min, aabb_max, eps: float = 1e-7):
    """nerfacc's unbounded-scene contraction (the proposal density fields'):
    the aabb maps to [0.25, 0.75] and all of space into [0, 1]."""
    x = (x - aabb_min) / (aabb_max - aabb_min)
    x = x * 2.0 - 1.0
    mag = torch.linalg.norm(x, dim=-1, keepdim=True)
    safe_mag = torch.clamp(mag, min=eps)
    contracted = (2.0 - 1.0 / safe_mag) * (x / safe_mag)
    x = torch.where(mag > 1.0, contracted, x)
    return x / 4.0 + 0.5


class MLP(nn.Module):
    """Small ReLU MLP (64-wide) with fp32 params and bf16 compute."""

    def __init__(self, in_dim: int, out_dim: int, hidden_layers: int = 1,
                 width: int = 64, dtype=torch.bfloat16):
        super().__init__()
        self.hidden_layers = hidden_layers
        self.dtype = dtype
        d = in_dim
        for i in range(hidden_layers):
            setattr(self, f"hidden_{i}", nn.Linear(d, width))
            d = width
        self.out = nn.Linear(d, out_dim)

    def layers(self):
        return [getattr(self, f"hidden_{i}")
                for i in range(self.hidden_layers)] + [self.out]

    def reset_parameters(self, generator: torch.Generator):
        """lecun-normal weights, zero biases (flax Dense defaults)."""
        for lin in self.layers():
            std = math.sqrt(1.0 / lin.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for lin in self.layers()[:-1]:
            x = F.relu(F.linear(x, lin.weight.to(self.dtype),
                                lin.bias.to(self.dtype)))
        return F.linear(x, self.out.weight.to(self.dtype),
                        self.out.bias.to(self.dtype))


class HashGridEncoder(nn.Module):
    """Multires grid with its tables as parameters: impl "brick" (the brick
    layout: `grid_{l}` for dense levels, `bricks_{l}` for hashed ones) or
    "gather" (the exact per-corner layout: one `table` [total_rows, F*K])."""

    def __init__(self, spec: HashGridSpec, dtype=torch.bfloat16,
                 impl: str = "brick"):
        super().__init__()
        if impl not in ("brick", "gather"):
            raise ValueError(f"HashGridEncoder: impl {impl!r} is not "
                             "'brick' or 'gather'")
        self.dtype, self.impl, self.spec = dtype, impl, spec
        self.bspec = BrickGridSpec(
            n_levels=spec.n_levels, n_features=spec.n_features,
            base_res=spec.base_res, max_res=spec.max_res,
            log2_hashmap_size=spec.log2_hashmap_size,
            time_keyframes=spec.time_keyframes,
            grad_accum_dtype=spec.grad_accum_dtype,
            scatter_impl=spec.scatter_impl, interp_impl=spec.interp_impl,
            max_table_rows=spec.max_table_rows,
            fine_table_rows=spec.fine_table_rows,
            fine_from_level=spec.fine_from_level,
            remat_feats=spec.remat_feats, row_layout=spec.row_layout,
            cell_rows_cap=spec.cell_rows_cap)
        shapes = (self.bspec.param_shapes() if impl == "brick" else
                  [("table", (spec.total_rows, spec.row_features))])
        self._names = []
        for name, shape in shapes:
            self.register_parameter(name, nn.Parameter(torch.empty(shape)))
            self._names.append(name)

    def tables(self):
        return {name: getattr(self, name) for name in self._names}

    def reset_parameters(self, generator: torch.Generator):
        """Uniform(-1e-4, 1e-4) tables (the JAX distribution)."""
        with torch.no_grad():
            for name in self._names:
                getattr(self, name).uniform_(-1e-4, 1e-4,
                                             generator=generator)

    def forward(self, x: torch.Tensor,
                t: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.impl == "brick":
            return brick_encode(x, self.tables(), self.bspec, t=t,
                                compute_dtype=self.dtype)
        if self.spec.time_keyframes:
            if t is None:
                raise ValueError("HashGridEncoder: a 4D spec needs t")
            return hash_encode_4d(x, t, self.table, self.spec,
                                  compute_dtype=self.dtype)
        return hash_encode(x, self.table, self.spec, compute_dtype=self.dtype)


class TriPlaneEncoderModule(nn.Module):
    """Tri-plane factored encoder with its `planes` [3*R*R, F] parameter
    (the reference's TriPlaneEncoder swap option, model.py:253-260)."""

    def __init__(self, spec: TriPlaneSpec, dtype=torch.bfloat16):
        super().__init__()
        self.spec, self.dtype = spec, dtype
        self.planes = nn.Parameter(torch.empty(spec.total_rows,
                                               spec.n_features))

    def tables(self):
        return {"planes": self.planes}

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.planes.uniform_(-1e-4, 1e-4, generator=generator)

    def forward(self, x: torch.Tensor,
                t: Optional[torch.Tensor] = None) -> torch.Tensor:
        return triplane_encode(x, self.planes, self.spec,
                               compute_dtype=self.dtype)


class NGPDensityField(nn.Module):
    """Instant-NGP density field of the proposal sampler (reference
    cednerf/model.py:28-94): the brick encoder `grid` (L `n_levels`, F 2,
    base_resolution -> max_resolution, 2^log2_hashmap_size; on CUDA K5
    and K6) and a 1-hidden-layer bf16 `mlp`; density trunc_exp(raw - 1),
    raw capped at density_clamp when it is > 0, times the in-AABB selector
    (bounded) or on the contracted position (unbounded). Constructor
    arguments are the flax module's fields; parameters are uninitialised
    until `reset_parameters(generator)` or a state dict."""

    def __init__(self, aabb: Tuple[float, ...], unbounded: bool = False,
                 base_resolution: int = 16, max_resolution: int = 128,
                 n_levels: int = 5, log2_hashmap_size: int = 17,
                 encoder_impl: str = "brick", density_clamp: float = 0.0):
        super().__init__()
        self.aabb = tuple(float(v) for v in aabb)
        self.register_buffer("_aabb_t", torch.tensor(self.aabb,
                                                     dtype=torch.float32),
                             persistent=False)
        self.unbounded = unbounded
        self.density_clamp = density_clamp
        self.grid = HashGridEncoder(
            HashGridSpec(n_levels=n_levels, n_features=2,
                         base_res=base_resolution, max_res=max_resolution,
                         log2_hashmap_size=log2_hashmap_size),
            impl=encoder_impl)
        self.mlp = MLP(self.grid.spec.output_dim, 1, hidden_layers=1)

    def reset_parameters(self, generator: torch.Generator):
        """Tables uniform +-1e-4, Dense lecun-normal with zero bias."""
        for mod in self.children():
            mod.reset_parameters(generator)
        return self

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        aabb_min, aabb_max = self._aabb_t[:3], self._aabb_t[3:]
        if self.unbounded:
            x = contract_to_unisphere(positions, aabb_min, aabb_max)
            selector = torch.ones(x.shape[:-1], dtype=torch.bool,
                                  device=x.device)
        else:
            x = (positions - aabb_min) / (aabb_max - aabb_min)
            selector = torch.all((x > 0.0) & (x < 1.0), dim=-1)
        h = self.grid(x.reshape(-1, 3))
        raw = self.mlp(h).float() - 1.0
        if self.density_clamp > 0:
            raw = torch.clamp(raw, max=self.density_clamp)
        return trunc_exp(raw) * selector[..., None]


class DNGPRadianceField(nn.Module):
    """Time-conditioned Instant-NGP radiance field with a motion-warp MLP.

    Constructor arguments are the flax module's fields, same names and
    defaults. Parameters are created uninitialised; call
    `reset_parameters(generator)` (engine/cli.py::build_field does) or load
    a state dict."""

    def __init__(self, aabb: Tuple[float, ...], geo_feat_dim: int = 15,
                 base_resolution: int = 16, n_levels: int = 16,
                 n_features_per_level: int = 2, dst_resolution: int = 4096,
                 log2_hashmap_size: int = 19, use_feat_predict: bool = False,
                 use_weight_predict: bool = False,
                 moving_step: float = DEFAULT_MOVING_STEP,
                 use_div_offsets: bool = False,
                 use_time_embedding: bool = False,
                 use_time_attenuation: bool = False,
                 time_inject_before_sigma: bool = True,
                 hash4motion: bool = False, use_viewdirs: bool = True,
                 grid_type: str = "hash3d", time_keyframes: int = 4,
                 encoder_impl: str = "brick",
                 grad_accum_dtype: str = "float32", scatter_impl: str = "xla",
                 interp_impl: str = "xla", max_table_rows: int = 16384,
                 fine_table_rows: int = 0, fine_from_level: int = 5,
                 remat_feats: bool = False, row_layout: str = "brick",
                 cell_rows_cap: int = 524288, density_clamp: float = 0.0):
        super().__init__()
        if grid_type not in ("hash3d", "hash4d", "triplane"):
            raise ValueError(f"grid_type {grid_type!r} is not 'hash3d', "
                             "'hash4d' or 'triplane'")
        self.aabb = tuple(float(v) for v in aabb)
        # on the field's device, so that no call uploads it (a host sync)
        self.register_buffer("_aabb_t", torch.tensor(self.aabb,
                                                     dtype=torch.float32),
                             persistent=False)
        self.geo_feat_dim = geo_feat_dim
        self.moving_step = moving_step
        self.use_div_offsets = use_div_offsets
        self.use_time_embedding = use_time_embedding
        self.use_time_attenuation = use_time_attenuation
        self.time_inject_before_sigma = time_inject_before_sigma
        self.use_feat_predict = use_feat_predict
        self.use_weight_predict = use_weight_predict
        self.use_viewdirs = use_viewdirs
        self.density_clamp = density_clamp
        self.grid_type = grid_type
        self.hash4motion = hash4motion
        self.hash_spec = HashGridSpec(
            n_levels=n_levels, n_features=n_features_per_level,
            base_res=base_resolution, max_res=dst_resolution,
            log2_hashmap_size=log2_hashmap_size,
            time_keyframes=time_keyframes if grid_type == "hash4d" else 0,
            grad_accum_dtype=grad_accum_dtype, scatter_impl=scatter_impl,
            interp_impl=interp_impl, max_table_rows=max_table_rows,
            fine_table_rows=fine_table_rows, fine_from_level=fine_from_level,
            remat_feats=remat_feats, row_layout=row_layout,
            cell_rows_cap=cell_rows_cap)
        self.triplane_spec = TriPlaneSpec(plane_res=dst_resolution,
                                          n_features=n_features_per_level)
        enc_dim = (self.triplane_spec.output_dim if grid_type == "triplane"
                   else self.hash_spec.output_dim)
        xt_dim = sinusoidal_latent_dim(4, 0, 4)
        t_dim = sinusoidal_latent_dim(1, 0, 4) if use_time_embedding else 0
        before = t_dim if time_inject_before_sigma else 0
        after = 0 if time_inject_before_sigma else t_dim

        motion_out = 6 if use_div_offsets else 3
        if hash4motion:
            # HashGrid(xyz, 8 levels, 16 -> 2048) + Frequency(t) -> a
            # 1-hidden-layer MLP (model.py:165-199)
            self.motion_grid = HashGridEncoder(
                HashGridSpec(n_levels=8, n_features=2, base_res=16,
                             max_res=2048, log2_hashmap_size=19),
                impl=encoder_impl)
            self.motion_mlp = MLP(
                self.motion_grid.spec.output_dim
                + sinusoidal_latent_dim(1, 0, 4), motion_out, hidden_layers=1)
        else:
            # Frequency(xyzt, 4 octaves) -> a 3-hidden-layer MLP
            self.motion_mlp = MLP(xt_dim, motion_out, hidden_layers=3)
        if grid_type == "triplane":
            self.hash_encoder = TriPlaneEncoderModule(self.triplane_spec)
        else:
            self.hash_encoder = HashGridEncoder(self.hash_spec,
                                                impl=encoder_impl)
        self.mlp_base = MLP(enc_dim + before, 1 + geo_feat_dim,
                            hidden_layers=1)
        self.mlp_head = MLP((4 if use_viewdirs else 0) + geo_feat_dim + after,
                            3, hidden_layers=2)
        if use_feat_predict:
            self.mlp_feat_prediction = MLP(xt_dim, enc_dim, hidden_layers=1)
        if use_weight_predict:
            self.mlp_weight_prediction = MLP(xt_dim, 1, hidden_layers=1)

    def reset_parameters(self, generator: torch.Generator):
        """Fresh weights from `generator`: tables uniform +-1e-4, Dense
        lecun-normal with zero bias (the flax shapes and distributions)."""
        for mod in self.children():
            mod.reset_parameters(generator)
        return self

    # ------------------------------------------------------------------ #

    def _aabb(self, like: torch.Tensor):
        aabb = self._aabb_t.to(like.device)
        return aabb[:3], aabb[3:]

    def query_move(self, x, t):
        """Motion warp: (x, t) -> (x + move, move). Reference model.py:354-365."""
        if self.hash4motion:
            aabb_min, aabb_max = self._aabb(x)
            xn = (x - aabb_min) / (aabb_max - aabb_min)
            h = torch.cat([self.motion_grid(xn),
                           sinusoidal_encode(t, 0, 4).to(torch.bfloat16)],
                          dim=-1)
        else:
            h = sinusoidal_encode(torch.cat([x, t], dim=-1), 0, 4)
        offsets = self.motion_mlp(h).float()
        if self.use_div_offsets:
            grid_move = offsets[:, 0:3] * self.moving_step
            fine_move = torch.tanh(offsets[:, 3:]) * self.moving_step
            move = grid_move + fine_move
        else:
            move = offsets * self.moving_step
        return x + move, move

    def query_density(self, x, t, return_feat: bool = False,
                      return_internal: bool = False, skip_move: bool = False):
        """Density (+ geometry features / aux-loss internals) at (x [N, 3],
        t [N, 1]). Reference model.py:367-445."""
        x = x.reshape(-1, 3).float()
        t = t.reshape(-1, 1).float()
        if skip_move:
            x_move, move = x, torch.zeros_like(x[:, :1])
        else:
            x_move, move = self.query_move(x, t)

        aabb_min, aabb_max = self._aabb(x)
        xn = (x_move - aabb_min) / (aabb_max - aabb_min)
        selector = torch.all((xn > 0.0) & (xn < 1.0), dim=-1)
        if self.grid_type == "hash4d":
            hash_feat = self.hash_encoder(xn, t)
        else:
            hash_feat = self.hash_encoder(xn)

        time_encode = None
        if self.use_time_embedding:
            # computed under no_grad in the reference (model.py:387): a
            # constant input to the MLPs
            if self.use_time_attenuation:
                move_norm = torch.linalg.norm(move.detach(), dim=-1,
                                              keepdim=True)
                time_encode = sinusoidal_encode_with_exp(t, move_norm, 0, 4)
            else:
                time_encode = sinusoidal_encode(t, 0, 4)
            time_encode = time_encode.detach().to(hash_feat.dtype)

        if time_encode is not None and self.time_inject_before_sigma:
            cat_feat = torch.cat([hash_feat, time_encode], dim=-1)
        else:
            cat_feat = hash_feat

        base_out = self.mlp_base(cat_feat)
        density_before = base_out[:, :1].float()
        geo_feat = base_out[:, 1:]
        raw_act = density_before - 1.0
        if self.density_clamp > 0:
            raw_act = torch.clamp(raw_act, max=self.density_clamp)
        density = trunc_exp(raw_act) * selector[:, None]

        results = {"density": density}
        if return_feat:
            if time_encode is not None and not self.time_inject_before_sigma:
                results["base_mlp_out"] = torch.cat([geo_feat, time_encode],
                                                    dim=-1)
            else:
                results["base_mlp_out"] = geo_feat
        if return_internal:
            internal = {"move": move, "selector": selector}
            if self.use_feat_predict or self.use_weight_predict:
                temp_feat = sinusoidal_encode(torch.cat([x_move, t], dim=-1),
                                              0, 4)
                if self.use_feat_predict:
                    # the target hash_feat is not detached (as in JAX): the
                    # loss trains the tables toward the prediction as well
                    predict = self.mlp_feat_prediction(temp_feat).float()
                    internal["latent_losses"] = huber(
                        predict, hash_feat.float()) * selector[:, None]
                if self.use_weight_predict:
                    internal["weight_losses"] = self.mlp_weight_prediction(
                        temp_feat).float()
            results["internal"] = internal
        return results

    def query_rgb(self, directions, embedding):
        """View-dependent colour head. Reference model.py:447-466."""
        if self.use_viewdirs:
            d = directions / torch.linalg.norm(directions, dim=-1,
                                               keepdim=True)
            d_enc = sh_encode_deg2(d.float()).to(embedding.dtype)
            h = torch.cat([d_enc, embedding], dim=-1)
        else:
            h = embedding
        return torch.sigmoid(self.mlp_head(h).float())

    def forward(self, positions, t, directions=None,
                return_internal: bool = False, skip_move: bool = False):
        """Full field query: (rgb, sigma_results). Reference model.py:468-488."""
        sigma_results = self.query_density(
            positions, t, return_feat=True, return_internal=return_internal,
            skip_move=skip_move)
        rgb = self.query_rgb(directions, sigma_results["base_mlp_out"])
        return rgb, sigma_results
