"""Encoder-backward probe: the all-levels interpolation kernels K1 (forward)
and K7 (backward as update rows, scattered per level by K3) against
brick_encode's own route (K5 forward, K6 backward). Port of the JAX
package's tools/profile_pallas_enc.py.

    python -m cednerf_torch.tools.profile_interp_enc [--n 262144]
        [--device cuda] [--seed 0] [--reps 20]

Sections, as the JAX tool's:
  1. tables and rows: a BrickGridSpec(L8 F4, base 16, max 1024, 2^19
     hashmap, 16,384-row cap) initialised from the seed, its level tables
     (dense levels materialized) cast to bf16, and each level's rows
     gathered into [L, N, 64F] for N points uniform in [0.02, 0.98]^3;
  2. forward: K1 on those rows against brick_encode (K5): max abs error
     and the largest output;
  3. backward: K7 on the rows and a bf16 cotangent, then K3 once per level
     on its update rows, against autograd through brick_encode (K6): each
     level's table-gradient error relative to the largest entry (dense
     levels compared as `grid_{l}` gradients, the scattered rows pushed
     through the backward of _materialize_dense_bricks) and d_x's;
  4. timing (CUDA only), CUDA events over `reps` calls: K1 alone,
     brick_encode forward, K7 + regather + one K3 per level, brick_encode
     forward + backward.

Limits (`ok`): forward within one bf16 ulp of the largest output (both
sides round the same f32 sums to bf16, summed in another order); table
gradients within 1e-4 of the largest entry (K3 and K6 add with f32
atomics in orders that change from run to run); d_x within 1e-5 (both sum
the same products in the same order per level).

Prints JSON lines: the card, then one line per section.
"""

import argparse
import json

import torch

from ..ops import encode_kernels as ek
from ..ops import scatter_kernels as sk
from ..ops.brick_grid import (BrickGridSpec, _level_geom,
                              _materialize_dense_bricks, brick_encode,
                              level_tables)
from ..utils.bench import card_name, cuda_ms
from ..utils.device import resolve_device

SPEC = dict(n_levels=8, n_features=4, base_res=16, max_res=1024,
            log2_hashmap_size=19, max_table_rows=16384)
FWD_FRAC = 2.0 ** -7
TABLE_FRAC = 1e-4
DX_FRAC = 1e-5


def _rel(got, want):
    """max |got - want| / max |want|."""
    scale = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() / max(scale, 1e-30)


def run(n=262144, spec_kwargs=None, device="cuda", seed=0, reps=20) -> dict:
    """Sections 1-4 above; timing only on CUDA with reps > 0."""
    dev = resolve_device(device)
    spec = BrickGridSpec(**(spec_kwargs or SPEC))
    lay = spec.level_layout()
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    level_rows = [l["rows"] for l in lay]
    L, F = spec.n_levels, spec.n_features
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = spec.init_params(gen, device=dev)
    x = torch.rand((n, 3), generator=gen, device=dev) * 0.96 + 0.02
    g = torch.randn((n, L * F), generator=gen, device=dev).to(torch.bfloat16)
    res = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
           else "cpu", "n": n, "levels": L, "n_feat": F,
           "layouts": [[l["rows"], l["hashed"]] for l in lay]}

    # 1. tables and rows
    with torch.no_grad():
        tables = [t.to(torch.bfloat16) for t in level_tables(params, spec)]

    def gather_rows():
        rows = torch.stack([_level_geom(x, scales[l], nbs[l], lay[l]["hashed"],
                                        level_rows[l])[0] for l in range(L)])
        feats = torch.empty((L, n, spec.row_width), dtype=torch.bfloat16,
                            device=dev)
        for l in range(L):
            torch.index_select(tables[l], 0, rows[l].long(), out=feats[l])
        return feats, rows

    feats, rows = gather_rows()

    # 2. forward: K1 against brick_encode (K5)
    with torch.no_grad():
        out_k1 = ek.interp_fwd(x, feats, scales, nbs, F)
        out_ref = brick_encode(x, params, spec)
    res["fwd_max_abs_err"] = (out_k1.float() - out_ref.float()).abs().max(
    ).item()
    res["fwd_scale"] = out_ref.float().abs().max().item()
    del out_k1, out_ref

    # 3. backward: K7 + K3 per level against autograd through brick_encode
    upd, d_x = ek.interp_bwd(x, g, feats, scales, nbs, F)
    d_tabs = [sk.scatter_add_rows(rows[l], upd[l], level_rows[l])
              for l in range(L)]
    del upd
    xr = x.clone().requires_grad_(True)
    pr = {k: v.detach().clone().requires_grad_(True)
          for k, v in params.items()}

    def encode_fwd_bwd():
        out = brick_encode(xr, pr, spec)
        return torch.autograd.grad(out, [xr, *pr.values()], g)

    d_x_ref, *d_params = encode_fwd_bwd()
    d_params = dict(zip(pr, d_params))
    errs = {}
    for l in range(L):
        if lay[l]["hashed"]:
            errs[l] = _rel(d_tabs[l], d_params[f"bricks_{l}"])
        else:
            grid = params[f"grid_{l}"].detach().requires_grad_(True)
            d_grid, = torch.autograd.grad(
                _materialize_dense_bricks(grid, nbs[l]), grid, d_tabs[l])
            errs[l] = _rel(d_grid, d_params[f"grid_{l}"])
    res["d_table_rel_err"] = errs
    res["dx_rel_err"] = _rel(d_x, d_x_ref)
    res["ok"] = (res["fwd_max_abs_err"] <= FWD_FRAC * res["fwd_scale"]
                 and max(errs.values()) <= TABLE_FRAC
                 and res["dx_rel_err"] <= DX_FRAC)
    del d_tabs, d_params, d_x, d_x_ref

    # 4. timing
    if dev.type != "cuda" or reps <= 0:
        res["ms"] = None
        return res

    def k1():
        return ek.interp_fwd(x, feats, scales, nbs, F)

    def encode_fwd():
        with torch.no_grad():
            return brick_encode(x, params, spec)

    def k7_regather_k3():
        f, r = gather_rows()
        u, dx = ek.interp_bwd(x, g, f, scales, nbs, F)
        return [sk.scatter_add_rows(r[l], u[l], level_rows[l])
                for l in range(L)], dx

    res["ms"] = {"k1_interp_fwd": cuda_ms(k1, reps),
                 "brick_encode_fwd": cuda_ms(encode_fwd, reps),
                 "k7_regather_k3": cuda_ms(k7_regather_k3, reps),
                 "brick_encode_fwd_bwd": cuda_ms(encode_fwd_bwd, reps)}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=262144)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        print(card_name(), flush=True)
    res = run(args.n, device=args.device, seed=args.seed, reps=args.reps)
    print(json.dumps({"layouts": res.pop("layouts")}))
    print(json.dumps({"forward": {k: res[k] for k in (
        "fwd_max_abs_err", "fwd_scale")}}))
    print(json.dumps({"backward": {k: res[k] for k in (
        "d_table_rel_err", "dx_rel_err", "ok")}}))
    print(json.dumps({"timing_ms": res["ms"], "device": res["device"],
                      "n": res["n"]}))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
