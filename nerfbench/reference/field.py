"""The D-NeRF field in plain PyTorch: the reference that a cell's outputs
are held to.

It follows Ced-NeRF's dynamic Instant-NGP field (model.py:97-488) as the
configuration file states it: a frequency-encoded motion warp, the brick
hash grid, the time embedding with motion attenuation, the density head
(exp(x - 1) times the in-box selector) and the view-dependent colour
head. Parameters are a
plain dict {name: tensor} under the names and shapes of the measured
program's field, so one draw of weights feeds both.

Precision is the configuration's: f32 parameters; the table values read
in bfloat16 and interpolated in f32; the encoder's output and every MLP
in bfloat16. `precision="fp8"` runs the MLPs on per-tensor scaled float8
(e4m3) inputs and weights instead: the control that a comparison has to
fail.

Nothing here imports the measured program: the brick layout, the hash and
the level geometry are written out again from the configuration.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

BRICK_CELLS = 3             # cells per brick edge
CORNERS_PER_BRICK = 64      # 4^3 corner lanes of a brick row
PRIMES = (1, 2654435761, 805459861)
U32 = 0xFFFFFFFF
TRUNC_STD = 0.87962566103423978   # std of a unit normal cut at +-2
FP8_MAX = 448.0                   # largest float8 e4m3 value


# ------------------------------------------------------------------ #
# Shapes


def sin_dim(x_dim: int, n_deg: int) -> int:
    """Width of a sinusoidal encoding with the identity: (1 + 2n) * D."""
    return (1 + 2 * n_deg) * x_dim


def level_layout(enc: dict) -> list:
    """Per level of the brick grid: scale, bricks per axis, rows, hashed."""
    n = enc["n_levels"]
    log_b = 0.0 if n == 1 else math.log(
        enc["max_res"] / enc["base_res"]) / (n - 1)
    hashed_rows = min(max(2 ** enc["log2_hashmap_size"] // 16, 1),
                      enc["max_table_rows"])
    out = []
    for lvl in range(n):
        scale = enc["base_res"] * math.exp(lvl * log_b) - 1.0
        res = int(math.ceil(scale)) + 1
        nb = max((res + BRICK_CELLS - 1) // BRICK_CELLS, 1)
        hashed = nb ** 3 > hashed_rows
        out.append({"scale": scale, "nb": nb, "hashed": hashed,
                    "rows": hashed_rows if hashed else nb ** 3})
    return out


def mlp_layers(cfg: dict) -> dict:
    """{mlp: [(in, out), ...]} of the field's MLPs, input layer first."""
    f = cfg["field"]
    enc = f["encoder"]
    w = f["mlp_width"]
    xt = sin_dim(4, f["pos_enc_degrees"])
    t_dim = sin_dim(1, f["pos_enc_degrees"]) if cfg["flags"][
        "use_time_embedding"] else 0
    enc_dim = enc["n_levels"] * enc["n_features"]
    motion_out = 6 if cfg["flags"]["use_div_offsets"] else 3
    geo = f["geo_feat_dim"]
    layers = {
        "motion_mlp": [(xt, w)] + [(w, w)] * (f["motion_hidden"] - 1)
        + [(w, motion_out)],
        "mlp_base": [(enc_dim + t_dim, w), (w, 1 + geo)],
        "mlp_head": [(4 + geo, w), (w, w), (w, 3)],
    }
    if cfg["flags"]["use_feat_predict"]:
        layers["mlp_feat_prediction"] = [(xt, w), (w, enc_dim)]
    return layers


def param_specs(cfg: dict) -> list:
    """[(name, shape, kind, std)] of every parameter: kind "table" (uniform
    draw), "weight" (lecun normal, std given) or "bias" (zero)."""
    enc = cfg["field"]["encoder"]
    f = enc["n_features"]
    out = []
    for name, layers in mlp_layers(cfg).items():
        for i, (d_in, d_out) in enumerate(layers):
            layer = "out" if i == len(layers) - 1 else f"hidden_{i}"
            out.append((f"{name}.{layer}.weight", (d_out, d_in), "weight",
                        math.sqrt(1.0 / d_in) / TRUNC_STD))
            out.append((f"{name}.{layer}.bias", (d_out,), "bias", 0.0))
    for lvl, lay in enumerate(level_layout(enc)):
        if lay["hashed"]:
            out.append((f"hash_encoder.bricks_{lvl}",
                        (lay["rows"], CORNERS_PER_BRICK * f), "table", 0.0))
        else:
            n = lay["nb"] * BRICK_CELLS + 1
            out.append((f"hash_encoder.grid_{lvl}", (n, n, n, f), "table",
                        0.0))
    return out


# ------------------------------------------------------------------ #
# Precision


def _fp8(v: torch.Tensor) -> torch.Tensor:
    """v through float8 e4m3 at a per-tensor scale (amax to 448) and back
    to f32."""
    v = v.float()
    scale = FP8_MAX / torch.clamp(v.abs().amax(), min=1e-30)
    return (v * scale).to(torch.float8_e4m3fn).float() / scale


def mlp(params: dict, name: str, n_layers: int, x: torch.Tensor,
        precision: str = "bf16") -> torch.Tensor:
    """ReLU MLP in bfloat16 (precision "bf16") or on float8 operands
    ("fp8"); the output in bfloat16 either way."""
    def layer(i):
        tag = "out" if i == n_layers - 1 else f"hidden_{i}"
        return params[f"{name}.{tag}.weight"], params[f"{name}.{tag}.bias"]

    h = x.to(torch.bfloat16)
    for i in range(n_layers):
        w, b = layer(i)
        if precision == "fp8":
            h = F.linear(_fp8(h), _fp8(w), b.float()).to(torch.bfloat16)
        else:
            h = F.linear(h, w.to(torch.bfloat16), b.to(torch.bfloat16))
        if i < n_layers - 1:
            h = F.relu(h)
    return h


# ------------------------------------------------------------------ #
# Encodings


def sinusoidal(x: torch.Tensor, n_deg: int) -> torch.Tensor:
    """[x, sin(x 2^i) for (i, d), cos(x 2^i) for (i, d)] (encoder.py:6)."""
    scales = torch.exp2(torch.arange(n_deg, dtype=x.dtype, device=x.device))
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(torch.cat([xb, xb + 0.5 * math.pi], -1))],
                     -1)


def sinusoidal_with_exp(x, x_var, n_deg: int) -> torch.Tensor:
    """The same with frequency i damped by exp(-x_var i 2^i) (encoder.py:46)."""
    scales = torch.exp2(torch.arange(n_deg, dtype=x.dtype, device=x.device))
    move_scales = torch.arange(n_deg, dtype=x.dtype, device=x.device) * scales
    xb = x[..., None, :] * scales[:, None]
    damp = torch.exp(-(x_var[..., None, :] * move_scales[:, None])[..., 0])
    lat = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], -1)) * damp[..., None]
    return torch.cat([x, lat.reshape(*x.shape[:-1], -1)], -1)


def sh_deg2(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degree <= 1 of unit directions."""
    c0, c1 = 0.28209479177387814, 0.4886025119029199
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack([torch.full_like(x, c0), -c1 * y, c1 * z, -c1 * x], -1)


def _brick_axis(g: torch.Tensor, axis: int, nb: int) -> torch.Tensor:
    """Corner axis [3 nb + 1] -> [nb, 4]: out[b, d] = g[3 b + d]."""
    idx = (3 * torch.arange(nb, device=g.device)[:, None]
           + torch.arange(4, device=g.device)[None]).reshape(-1)
    out = g.index_select(axis, idx)
    return out.reshape(g.shape[:axis] + (nb, 4) + g.shape[axis + 1:])


def dense_bricks(grid: torch.Tensor, nb: int) -> torch.Tensor:
    """A dense level's corner grid [n, n, n, C] as overlapping brick rows
    [nb^3, 64 C] (corner = dx 16 + dy 4 + dz, lane = corner C + c)."""
    c = grid.shape[-1]
    g = _brick_axis(_brick_axis(_brick_axis(grid, 0, nb), 2, nb), 4, nb)
    return g.permute(0, 2, 4, 1, 3, 5, 6).reshape(nb ** 3,
                                                  CORNERS_PER_BRICK * c)


def level_table(params: dict, lvl: int, lay: dict) -> torch.Tensor:
    """One level's rows [rows, 64 F], a row per brick."""
    if lay["hashed"]:
        return params[f"hash_encoder.bricks_{lvl}"]
    return dense_bricks(params[f"hash_encoder.grid_{lvl}"], lay["nb"])


def encode(params: dict, xn: torch.Tensor, enc: dict) -> torch.Tensor:
    """Brick-grid features [N, L F] in bfloat16 of unit-box positions xn,
    trilinear over each level's table values read in bfloat16."""
    f = enc["n_features"]
    dev = xn.device
    bits = torch.tensor([[(j >> 2) & 1, (j >> 1) & 1, j & 1]
                         for j in range(8)], device=dev)          # [8, 3]
    outs = []
    for lvl, lay in enumerate(level_layout(enc)):
        scale = float(np.float32(lay["scale"]))
        pos = (xn.double() * scale + 0.5).float()
        grid_pos = torch.floor(pos)
        hi = lay["nb"] * BRICK_CELLS - 1
        frac = pos - grid_pos
        cell = grid_pos.clamp(-1, hi + 1).long().clamp(0, hi)
        brick = cell // BRICK_CELLS
        intra = cell - brick * BRICK_CELLS
        if lay["hashed"]:
            h = ((brick[:, 0] * PRIMES[0]) & U32) \
                ^ ((brick[:, 1] * PRIMES[1]) & U32) \
                ^ ((brick[:, 2] * PRIMES[2]) & U32)
            row = h % lay["rows"]
        else:
            nb = lay["nb"]
            row = (brick[:, 0] * nb + brick[:, 1]) * nb + brick[:, 2]
        c3 = intra[:, None, :] + bits[None]                      # [N, 8, 3]
        corner = c3[..., 0] * 16 + c3[..., 1] * 4 + c3[..., 2]    # [N, 8]
        w3 = torch.where(bits[None].bool(), frac[:, None, :],
                         1.0 - frac[:, None, :])                  # [N, 8, 3]
        w = w3[..., 0] * (w3[..., 1] * w3[..., 2])                # [N, 8]
        table = level_table(params, lvl, lay).reshape(-1, f)
        vals = table[row[:, None] * CORNERS_PER_BRICK + corner].to(
            torch.bfloat16).float()
        outs.append((vals * w[..., None]).sum(1))
    return torch.cat(outs, -1).to(torch.bfloat16)


# ------------------------------------------------------------------ #
# The field


def field_forward(params: dict, cfg: dict, x: torch.Tensor, t: torch.Tensor,
                  dirs=None, precision: str = "bf16"):
    """(density [N] f32, rgb [N, 3] f32 or None) at world positions x [N, 3]
    and times t [N, 1]; rgb where view directions `dirs` are given."""
    f = cfg["field"]
    flags = cfg["flags"]
    n_deg = f["pos_enc_degrees"]
    layers = mlp_layers(cfg)
    aabb = torch.tensor(cfg["scene"]["aabb"], dtype=torch.float32,
                        device=x.device)
    x = x.reshape(-1, 3).float()
    t = t.reshape(-1, 1).float()
    off = mlp(params, "motion_mlp", len(layers["motion_mlp"]),
              sinusoidal(torch.cat([x, t], -1), n_deg), precision).float()
    step = cfg["scene"]["moving_step"]
    if flags["use_div_offsets"]:
        move = off[:, 0:3] * step + torch.tanh(off[:, 3:]) * step
    else:
        move = off * step
    xn = (x + move - aabb[:3]) / (aabb[3:] - aabb[:3])
    selector = torch.all((xn > 0.0) & (xn < 1.0), -1)
    parts = [encode(params, xn, f["encoder"])]
    if flags["use_time_embedding"]:
        if flags["use_time_attenuation"]:
            te = sinusoidal_with_exp(
                t, torch.linalg.norm(move, dim=-1, keepdim=True),
                n_deg)
        else:
            te = sinusoidal(t, n_deg)
        parts.append(te.to(torch.bfloat16))
    base = mlp(params, "mlp_base", 2, torch.cat(parts, -1), precision)
    density = torch.exp(base[:, 0].float() - 1.0) * selector
    rgb = None
    if dirs is not None:
        d = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        h = torch.cat([sh_deg2(d.float()).to(torch.bfloat16), base[:, 1:]],
                      -1)
        rgb = torch.sigmoid(mlp(params, "mlp_head", 3, h, precision).float())
    return density, rgb
