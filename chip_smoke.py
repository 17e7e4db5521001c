#!/usr/bin/env python3
"""Chip smoke test of cednerf_torch, the PyTorch / CUDA port, on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught and carried on):

  1. device: needs CUDA (exits 1 without it, printing no result); prints
     the card's name and power limit as nvidia-smi reports them;
  2. build: nvcc builds the brick-encoder kernels from the checkout;
  3. kernels: K1 (interp_fwd) and K5 (fused_encode_fwd) against their plain
     PyTorch versions on the card, at one full seg-eval pass
     (eval_chunk_seg 32768 x budget_per_ray 64 = 2,097,152 samples) and at
     a ragged N, on the full-width D-NeRF field's tables; times each with
     CUDA events;
  4. reference: a small frame rendered on the card (kernel route) and on
     the CPU (plain route) from the same weights and grid must agree; both
     fields get the same uniform(-2, 2) tables, and the served field's
     frame (tables of +-1e-4, features ~0) must differ from it by far
     more than the tolerance, so a wrong encoder would fail the check;
  5. serving: ViewerServer on 127.0.0.1 answers /, /snap and five /render
     requests from the D-NeRF field at full width (dnerf_config with
     -te -ta -f -df: L8 F4, dst resolution 1024, 2^21 hashmap, 16384-row
     cap, brick layout; random weights from --seed), every frame a finite
     PNG. Four requests take the default K5 route (400x400 at 128 samples
     for t in {0, 0.5, 1}, one of them depth, and 800x800 at 256), one more
     400x400 request goes through a second server whose field takes the K1
     route (interp_impl="interp"). Launch counters are zeroed just before
     the requests and read just after: each kernel must have launched and
     the plain versions must not have run on CUDA.

Prints one JSON line per kernel, then the `kernels` line, then as its last
line {"ok": true, "device": {...}}.
"""

import argparse
import dataclasses
import http.client
import json
import os
import sys
import time

# bf16 output of a kernel vs the plain version's f32 sum: one bf16 rounding
# (half an ulp, <= 2^-8 relative) plus f32 summation order (~1e-11 absolute
# at the +-1e-4 table scale)
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-9
F32_RTOL, F32_ATOL = 1e-5, 1e-9
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # H100 SXM, f32 outside the tensor cores
REF_TABLE_BOUND = 8.0          # hash tables of the reference phase's fields


def log(msg):
    print(msg, flush=True)


def check_close(name, got, want, rtol, atol):
    err = (got.float() - want.float()).abs()
    bad = err > rtol * want.float().abs() + atol
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} values outside "
                             f"rtol {rtol} atol {atol}; max err "
                             f"{err.max().item()}")
    return err.max().item()


def kernel_phase(field, n_main, n_ragged, seed):
    import torch
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.ops.brick_grid import _level_geom, level_tables
    from cednerf_torch.utils.bench import cuda_ms

    spec = field.hash_encoder.bspec
    lay = spec.level_layout()
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    level_rows = [l["rows"] for l in lay]
    L, F = spec.n_levels, spec.n_features
    with torch.no_grad():
        tables = [t.to(torch.bfloat16) for t in
                  level_tables(field.hash_encoder.tables(), spec)]
    table = torch.cat(tables).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    results = {}
    for n in (n_main, n_ragged):
        x = torch.rand((n, 3), device="cuda", generator=gen)
        rows = torch.stack([
            _level_geom(x, scales[l], nbs[l], lay[l]["hashed"],
                        level_rows[l])[0] for l in range(L)]).contiguous()
        feats = torch.stack([tables[l].index_select(0, rows[l].long())
                             for l in range(L)]).contiguous()
        calls = {
            "fused_encode_fwd": (
                lambda od: ek.fused_encode_fwd(x, table, rows, scales, nbs,
                                               level_rows, F, od),
                lambda: ek.fused_encode_fwd_plain(x, table, rows, scales, nbs,
                                                  level_rows, F,
                                                  torch.float32)),
            "interp_fwd": (
                lambda od: ek.interp_fwd(x, feats, scales, nbs, F, od),
                lambda: ek.interp_fwd_plain(x, feats, scales, nbs, F,
                                            torch.float32)),
        }
        for name, (kern, plain) in calls.items():
            want = plain()
            got16 = kern(torch.bfloat16)
            got32 = kern(torch.float32)
            torch.cuda.synchronize()
            err16 = check_close(f"{name} N={n} bf16", got16, want,
                                BF16_RTOL, BF16_ATOL)
            err32 = check_close(f"{name} N={n} f32", got32, want,
                                F32_RTOL, F32_ATOL)
            rec = {"name": name, "n": n, "levels": L, "n_feat": F,
                   "max_abs_err": err16, "max_abs_err_f32_out": err32}
            if n == n_main:
                rec["ms"] = cuda_ms(lambda: kern(torch.bfloat16), 20)
                rec["plain_ms"] = cuda_ms(plain, 3)
                out_b = n * L * F * 2
                if name == "fused_encode_fwd":
                    in_b = rows.numel() * 4 + x.numel() * 4 \
                        + table.numel() * 2
                else:
                    in_b = x.numel() * 4 + feats.numel() * 2
                t_bytes = (in_b + out_b) / HBM_BYTES_PER_S * 1e3
                # the interpolation needs 8 corners x F multiply-adds per
                # (sample, level)
                t_ops = n * L * 8 * F * 2 / F32_FLOPS * 1e3
                rec["bound_ms"] = max(t_bytes, t_ops)
                rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                rec["row_bytes"] = n * L * 64 * F * 2
                results[name] = rec
            log(json.dumps({"kernel_check": rec}))
        del feats
        torch.cuda.empty_cache()
    return results


def reference_phase(field, occ, cfg, flags, seed):
    """The served route on the card against the plain route on the CPU,
    from fields built from `seed` and given the same
    uniform(-REF_TABLE_BOUND, REF_TABLE_BOUND) hash tables.

    1. encoder: the field's hash encoder (brick_encode: row geometry, dense
       bricks, table prep and the K5 launch) on random points and on points
       that sit on cell boundaries of every level;
    2. frame: a 32x32 frame. The served `field` keeps its initial +-1e-4
       tables, so its features are ~0, as an encoder that returned zeros
       would give; its frame must differ from the card's reference frame by
       far more than the tolerance, which shows that the check can fail.
       At the initial scale, or at +-2, the full-width density MLP damps
       the features so far that the frame barely moves (on the CPU, +-4
       moved rgb by 0.06 at most); at +-8 it moves rgb by ~0.3.

    Tolerances. Encoder (bf16 out): rtol 2^-7 (one bf16 rounding) and atol
    1e-4 (the f32 sums of 8 products of up to 8 in another order). Frame:
    rgb and opacity 2e-2 absolute; depth 5e-2 (scene units, the camera is 4
    away) on rays of opacity >= 0.1, where depth is not the rounding noise
    of a near-transparent ray. Why any: the card's and the CPU's bf16 GEMMs
    round differently, and a ray at the early-stop threshold can stop one
    pass earlier on one side."""
    import numpy as np
    import torch
    from cednerf_torch.datasets.rays import pinhole_rays
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.renderer import make_eval_render_fn, render_image
    from cednerf_torch.ops.occupancy import OccGridState
    from cednerf_torch.utils.bench import load_uniform_tables, orbit_c2w

    card = next(field.parameters()).device
    ref_fields = [build_field(cfg, flags, device=dev, seed=seed)
                  for dev in (card, "cpu")]
    load_uniform_tables(ref_fields, seed, REF_TABLE_BOUND)
    rec = {}

    # 1. the encoder on the served route
    gen = torch.Generator().manual_seed(seed)
    pts = [torch.rand((65536, 3), generator=gen) * 1.1 - 0.05]
    for scale in ref_fields[1].hash_encoder.bspec.level_scales():
        k = torch.randint(0, int(scale) + 2, (4096, 3), generator=gen)
        pts.append(((k.double() - 0.5) / float(np.float32(scale))).float())
    xe = torch.cat(pts)
    with torch.inference_mode():
        got = ref_fields[0].hash_encoder(xe.to(card)).float().cpu()
        want = ref_fields[1].hash_encoder(xe).float()
    rec["encoder_max_abs_err"] = check_close(
        "reference encoder", got, want, 2.0 ** -7, 1e-4)
    rec["encoder_max_abs"] = want.abs().max().item()

    # 2. a frame
    w = 32
    K = np.array([[w * 1.1, 0, w / 2], [0, w * 1.1, w / 2], [0, 0, 1]],
                 np.float32)
    xx, yy = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="xy")
    o, d, _ = pinhole_rays(xx.reshape(-1), yy.reshape(-1), K,
                           np.broadcast_to(orbit_c2w(), (w * w, 3, 4)), True)
    bkgd = np.ones(3, np.float32)
    ref_occ = OccGridState(*(a.cpu() for a in occ))
    outs = []
    for f, g in ((ref_fields[0], occ), (ref_fields[1], ref_occ),
                 (field, occ)):
        fn = make_eval_render_fn(f, cfg, s_max=64)
        outs.append(render_image(f, g, fn, o, d, 0.5, bkgd, chunk=4096))
    card_out, ref_out, served_out = outs
    seen = ref_out[1][..., 0] >= 0.1
    rec["opacity_mean"] = float(ref_out[1].mean())
    rec["depth_rays"] = int(seen.sum())
    for i, (name, tol) in enumerate((("rgb", 2e-2), ("opacity", 2e-2),
                                     ("depth", 5e-2))):
        a, b, z = card_out[i], ref_out[i], served_out[i]
        if not (np.isfinite(a).all() and np.isfinite(z).all()):
            raise AssertionError(f"reference: non-finite {name} on the card")
        if name == "depth":
            a, b, z = a[seen], b[seen], z[seen]
        err = float(np.abs(a - b).max())
        if err > tol:
            raise AssertionError(f"reference: {name} differs by {err} "
                                 f"(> {tol}): {rec}")
        rec[f"{name}_max_abs_err"] = err
        rec[f"{name}_moved_by_zero_features"] = float(np.abs(z - a).max())
        if name != "depth" and rec[f"{name}_moved_by_zero_features"] < 5 * tol:
            raise AssertionError(
                f"reference: zero features barely move {name}, so the frame "
                f"check could not fail: {rec}")
    return rec


def post_render(port, c2w, t, width, max_samples, depth):
    from cednerf_torch.utils.image import decode_png
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        body = json.dumps({"c2w": c2w.reshape(-1).tolist(), "time": t,
                           "width": width, "max_samples": max_samples,
                           "depth": depth})
        t0 = time.perf_counter()
        conn.request("POST", "/render", body=body)
        resp = conn.getresponse()
        data = resp.read()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()
    if resp.status != 200 or resp.getheader("Content-Type") != "image/png":
        raise AssertionError(f"/render: status {resp.status}, "
                             f"type {resp.getheader('Content-Type')}")
    img = decode_png(data)
    if img.shape != (width, width, 3):
        raise AssertionError(f"/render: image {img.shape}")
    return img, wall_ms, len(data)


def serving_phase(field, field_k1, occ, cfg):
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.utils.bench import orbit_c2w
    from cednerf_torch.viewer.server import ViewerServer

    c2w = orbit_c2w()
    servers = [ViewerServer(f, occ, cfg, wh=(400, 400), render_bkgd=(1, 1, 1))
               for f in (field, field_k1)]
    httpds = [s.start(port=0, host="127.0.0.1") for s in servers]
    ports = [h.server_address[1] for h in httpds]
    requests = [(0, 0.0, 400, 128, False), (0, 0.5, 400, 128, True),
                (0, 1.0, 400, 128, False), (0, 0.5, 800, 256, False),
                (1, 0.5, 400, 128, False)]
    frames = []
    try:
        conn = http.client.HTTPConnection("127.0.0.1", ports[0], timeout=60)
        conn.request("GET", "/")
        page = conn.getresponse().read()
        conn.request("GET", "/snap")
        snap = json.loads(conn.getresponse().read())
        conn.close()
        if b"cednerf_torch viewer" not in page or "radius" not in snap:
            raise AssertionError("viewer page or /snap malformed")
        # warm-up frame outside the counted run (allocator, cuBLAS handles)
        post_render(ports[0], c2w, 0.25, 64, 32, False)
        ek.reset_counts()
        for which, t, width, ms, depth in requests:
            before = dict(ek.launches)
            _, wall_ms, n_bytes = post_render(ports[which], c2w, t, width,
                                              ms, depth)
            stats = servers[which].last_frame
            if not stats["finite"]:
                raise AssertionError(f"non-finite frame {width}/{ms} t={t}")
            rec = {"route": "K5" if which == 0 else "K1", "t": t,
                   "width": width, "max_samples": ms, "depth": depth,
                   "render_ms": stats["ms"], "http_ms": wall_ms,
                   "png_bytes": n_bytes,
                   "launches": {k: v - before[k]
                                for k, v in ek.launches.items()},
                   "chunks": len(stats["passes_per_chunk"]),
                   "passes_per_chunk": stats["passes_per_chunk"]}
            frames.append(rec)
            log(json.dumps({"frame": rec}))
        launches = dict(ek.launches)
        plain = dict(ek.plain_cuda_calls)
    finally:
        for h in httpds:
            h.shutdown()
            h.server_close()
    if launches["fused_encode_fwd"] == 0 or launches["interp_fwd"] == 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on CUDA: {plain}")
    return frames, launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags, dnerf_config
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.utils.bench import card_name, fill_occupancy

    log(card_name())
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build_s, build_log = ek.build()
    log(f"build: {build_s:.2f} s nvcc, {time.perf_counter() - t0:.2f} s "
        "with load")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas: " + line.strip())

    cfg = dnerf_config()
    flags = ModelFlags(use_time_embedding=True, use_time_attenuation=True,
                       use_feat_predict=True, use_div_offsets=True)
    field = build_field(cfg, flags, device="cuda", seed=args.seed)
    field_k1 = build_field(dataclasses.replace(cfg, interp_impl="interp"),
                           flags, device="cuda", seed=args.seed)
    n_params = sum(p.numel() for p in field.parameters())
    log(f"field: {n_params} params, {n_params * 4 / 2 ** 20:.1f} MiB f32")

    n_main = cfg.eval_chunk_seg * 64   # one full seg-eval pass
    kern = kernel_phase(field, n_main, 1_000_003, args.seed)

    t0 = time.perf_counter()
    occ = fill_occupancy(field, cfg, args.seed, "cuda")
    torch.cuda.synchronize()
    occ_frac = occ.binaries.float().mean().item()
    log(f"occupancy: {cfg.grid_resolution}^3 all-cells update "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, occupied {occ_frac:.4f}")

    ref = reference_phase(field, occ, cfg, flags, args.seed)
    log(json.dumps({"reference": ref}))

    frames, launches = serving_phase(field, field_k1, occ, cfg)

    replaces = {
        "fused_encode_fwd": "cednerf_tpu/ops/pallas_fused.py:138",
        "interp_fwd": "cednerf_tpu/ops/pallas_encoder.py:136",
    }
    line = []
    for name in ("fused_encode_fwd", "interp_fwd"):
        r = kern[name]
        line.append({
            "name": name, "route": "cuda",
            "source": "cednerf_torch/csrc/brick_encode_fwd.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
