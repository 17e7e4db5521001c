#!/usr/bin/env python3
"""Chip smoke test of cednerf_torch, the PyTorch / CUDA port, on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which must pass (nothing is caught and carried on):

  1. device: needs CUDA (exits 1 without it, printing no result); prints
     the card's name and power limit as nvidia-smi reports them;
  2. build: nvcc builds the port's five CUDA sources from the checkout,
     one nvcc per source, all started together;
  3. kernels: K1 (interp_fwd) and K5 (fused_encode_fwd) against their plain
     PyTorch versions at one full seg-eval pass (eval_chunk_seg 32768 x
     budget_per_ray 64 = 2,097,152 samples) and at a ragged N; K6
     (fused_encode_bwd) and K2 (interp_bwd_fused) at one train step's
     262,144 samples and at a ragged N, all 8 levels, tables of +-8; K4
     (compact_select) bit-exact on [256, 1024] and [16000, 1024] lattices
     (the warmup and top ray buckets) at occupancy 1.0 and ~0.1, budget
     262,144. Each is timed with CUDA events beside its bound;
  4. reference: a small frame rendered on the card (kernel route) and on
     the CPU (plain route) from the same weights and grid must agree (see
     reference_phase for why the check can fail);
  5. serving: ViewerServer on 127.0.0.1 answers /, /snap and five /render
     requests from the D-NeRF field at full width (dnerf_config with
     -te -ta -f -df: L8 F4, dst resolution 1024, 2^21 hashmap, 16384-row
     cap, brick layout; random weights from --seed), every frame a finite
     PNG; four on the K5 route, one on K1 (interp_impl="interp"). Launch
     counters are zeroed just before the requests and read just after;
  6. reference step: one train step of a shrunken config on the card (both
     kernel routes) and on the CPU (plain versions), from the same weights,
     occupancy grid, ray batch and march jitter: loss and every gradient
     must agree (see reference_step_phase);
  7. training: Trainer.run_step on the full-width field (dnerf_config,
     -te -ta -f -ae -df -d) over BallCloudScene for TRAIN_STEPS steps on
     the default route (the 256-step all-cells occupancy warmup and sampled
     updates after it), then INTERP_STEPS steps on the K1/K2 route. Every
     loss must be finite and the last 8 default steps' mean PSNR above the
     first 8's; counters zeroed before each route and read after it: K5, K6
     and K4 on the default steps, K1, K2 and K4 on the interp steps, no
     plain version on CUDA in either;
  8. K3 (scatter_add_rows) against its plain version on the update rows of
     one real backward of the full-width 4D keyframe field (--grid_type
     hash4d: 3 dense and 5 hashed levels, K = 4) at the train step's
     262,144 samples, on level 0 (864 keyframe rows, the most contended)
     and on a hashed level (65,536 rows), and on a ragged M = 100,003 of
     random rows; each timed with CUDA events beside its bound and
     index_add_;
  9. hash4d reference step: phase 6 for the 4D field (its backward on K3
     on the card, on the plain version on the CPU);
 10. hash4d training: Trainer.run_step on the full-width 4D field for
     HASH4D_STEPS steps; finite losses, rising PSNR, K3 launched 8 times a
     step (one per level) and K4 once, no K1/K2/K5/K6 and no plain version
     on CUDA; then one 400x400 frame at 128 samples of the trained field
     through ViewerServer, finite;
 11. interp_enc probe: K7 (interp_bwd) against its plain version on the
     full-width field's levels (tables +-8, as phase 3) at the probe's N =
     262,144 and at a ragged N, timed beside its bound; then
     cednerf_torch.tools.profile_interp_enc.run at its defaults (L8 F4, max
     res 1024, 2^19 hashmap, N = 262,144), counters zeroed just before and
     read just after: K1's forward within one bf16 ulp of brick_encode's
     (K5), K7 + one K3 per level within 1e-4 of the K6 route's table
     gradients and d_x within 1e-5; K7 launched once and K3 8 times; then
     the tool's four timings in a second run;
 12. row_gather probe: K8 (row_gather) bit-exact against its plain version
     on the probe's tables (442,368 rows of W = 128 and 256 bf16, N =
     1,048,576 random rows), a W = 128 f32 table, and a ragged N =
     1,000,003 with indices out of range; the in-range cases timed beside
     their bound and index_select; then
     cednerf_torch.tools.profile_row_gather.run at its defaults, counted:
     every `match` true and K8 launched by every setting.
Phases 5, 7 and 10 fail if K7 or K8 launched on a serving or training path.

Prints one JSON line per check, then the `kernels` line, then as its last
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
# K6/K2 against their plain versions: the table gradient is summed with f32
# atomics in another order than the plain index_add (up to ~1,200 adds per
# address on the coarse dense level at 262,144 samples), so each level's
# table gradient is held to 1e-4 of that level's largest entry; d_x is
# summed in a fixed order on both sides, 1e-5 of its largest entry.
BWD_TABLE_FRAC, BWD_DX_FRAC = 1e-4, 1e-5
# the reference step's shrunken config (tests/test_torch_train.py's)
SMALL = dict(target_sample_batch_size=4096, grid_resolution=16,
             render_step_size=2e-2, max_march_steps=128,
             hash_dst_resolution=128, log2_hashmap_size=14,
             max_table_rows=512, hash_n_levels=4,
             grad_accum_dtype="float32")
# reference step, card vs CPU: each parameter's gradient L2 error relative
# to its norm, and the loss's relative error. The sound readings on an H100
# are 0.0034 (motion MLP, where cuBLAS's and the CPU's bf16 GEMMs round
# differently) and 2.4e-6; on the CPU, one level's position gradient
# scaled by 1.02 reads 0.0094 and by 1.05 0.0184, one dropped table-gradient
# corner 0.31, and one level's features scaled by 1.01 move the loss 7.4e-4.
STEP_GRAD_REL, STEP_LOSS_RTOL = 0.01, 1e-4
# the training phase: 512 default-route steps (the 256-step all-cells
# occupancy warmup, then 64 sampled updates), then 8 on the K1/K2 route
TRAIN_STEPS, INTERP_STEPS = 512, 8
# the hash4d training phase: the 256-step warmup and 64 steps after it
HASH4D_STEPS = 320
# K3 against its plain version: both sum in f32, K3 with atomics in an order
# that changes from run to run, index_add_ in its own (up to ~1,200 adds per
# address on level 0 at 262,144 samples), so each table is held to 1e-4 of
# its largest entry, as K6's table gradient.
K3_FRAC = 1e-4
# K7 against its plain version: its update rows are the plain version's f32
# products in the same order, d_x the same sums in another order; held to
# the limits of K6/K2: 1e-4 of each level's largest upd entry, 1e-5 of d_x's
K7_UPD_FRAC, K7_DX_FRAC = BWD_TABLE_FRAC, BWD_DX_FRAC
# kernels that only the probe paths (phases 11 and 12) run
PROBE_KERNELS = ("interp_bwd", "row_gather")


def log(msg):
    print(msg, flush=True)


def no_probe_kernels(label, launches):
    """Fails if K7 or K8 launched on a serving or training path."""
    ran = {k: launches[k] for k in PROBE_KERNELS if launches[k]}
    if ran:
        raise AssertionError(f"{label} launched a probe kernel: {ran}")


def _kernel_modules():
    from cednerf_torch.ops import compact_kernels as ck
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.ops import gather_kernels as gk
    from cednerf_torch.ops import scatter_kernels as sk
    return ek, ck, sk, gk


def reset_counts():
    for mod in _kernel_modules():
        mod.reset_counts()


def all_counts():
    """(launches, plain-version calls on CUDA) of every kernel wrapper."""
    mods = _kernel_modules()
    return ({k: v for mod in mods for k, v in mod.launches.items()},
            {k: v for mod in mods for k, v in mod.plain_cuda_calls.items()})


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
                    in_b = x.numel() * 4 + _corner_bytes(n, L, F)
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
        reset_counts()
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
        launches, plain = all_counts()
    finally:
        for h in httpds:
            h.shutdown()
            h.server_close()
    if launches["fused_encode_fwd"] == 0 or launches["interp_fwd"] == 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if launches["scatter_add_rows"]:
        raise AssertionError(f"serving launched K3: {launches}")
    no_probe_kernels("serving", launches)
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on CUDA: {plain}")
    return frames, launches


def _corner_bytes(n, L, F):
    """The bytes of gathered brick rows that K1 and K2 must read: the 8
    corners of a (sample, level) lie on 4 lines of the 4^3 brick, each 4
    corners x F bf16 (8F bytes, one 32-byte DRAM sector at F = 4), and the
    other 56 corners of the 64F row are never read."""
    return n * L * 4 * 8 * F


def _frac_err(got, want):
    """max |got - want| / max |want|."""
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / max(scale, 1e-30)


def backward_kernel_phase(field, n_main, n_ragged, seed):
    """K6 and K2 against their plain versions on the full-width field's
    levels, tables uniform(-8, 8), at one train step's sample count and at
    a ragged one. One bf16 cotangent row in eight is zero (unused budget
    slots carry zero)."""
    import torch
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.ops.brick_grid import _level_geom
    from cednerf_torch.utils.bench import cuda_ms

    spec = field.hash_encoder.bspec
    lay = spec.level_layout()
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    level_rows = [l["rows"] for l in lay]
    L, F = spec.n_levels, spec.n_features
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = ((torch.rand((sum(level_rows), 64 * F), device="cuda",
                         generator=gen) * 2 - 1) * REF_TABLE_BOUND
             ).to(torch.bfloat16)
    offs = [0]
    for r in level_rows:
        offs.append(offs[-1] + r)
    results = {}
    for n in (n_main, n_ragged):
        x = torch.rand((n, 3), device="cuda", generator=gen)
        g = (torch.randn((n, L * F), device="cuda", generator=gen) * 1e-3
             ).to(torch.bfloat16)
        g[::8] = 0
        rows = torch.stack([
            _level_geom(x, scales[l], nbs[l], lay[l]["hashed"],
                        level_rows[l])[0] for l in range(L)]).contiguous()
        feats = torch.stack([table[offs[l]:offs[l + 1]].index_select(
            0, rows[l].long()) for l in range(L)]).contiguous()
        want_t, want_x = ek.fused_encode_bwd_plain(x, g, rows, table, scales,
                                                   nbs, level_rows, F)
        calls = {
            "fused_encode_bwd": (
                lambda: ek.fused_encode_bwd(x, g, rows, table, scales, nbs,
                                            level_rows, F),
                lambda: ek.fused_encode_bwd_plain(x, g, rows, table, scales,
                                                  nbs, level_rows, F)),
            "interp_bwd_fused": (
                lambda: ek.interp_bwd_fused(x, g, feats, rows, scales, nbs,
                                            level_rows, F),
                lambda: ek.interp_bwd_fused_plain(x, g, feats, rows, scales,
                                                  nbs, level_rows, F)),
        }
        for name, (kern, plain) in calls.items():
            d_t, d_x = kern()
            torch.cuda.synchronize()
            errs = [_frac_err(d_t[offs[l]:offs[l + 1]],
                              want_t[offs[l]:offs[l + 1]]) for l in range(L)]
            err_x = _frac_err(d_x, want_x)
            if max(errs) > BWD_TABLE_FRAC or err_x > BWD_DX_FRAC:
                raise AssertionError(
                    f"{name} N={n}: table errors per level {errs} (limit "
                    f"{BWD_TABLE_FRAC}), d_x {err_x} (limit {BWD_DX_FRAC})")
            rec = {"name": name, "n": n, "levels": L, "n_feat": F,
                   "max_abs_err": max((d_t - want_t).abs().max().item(),
                                      (d_x - want_x).abs().max().item()),
                   "table_err_frac_per_level": errs, "dx_err_frac": err_x,
                   "d_table_max": want_t.abs().max().item()}
            if n == n_main:
                rec["ms"] = cuda_ms(kern, 20)
                rec["plain_ms"] = cuda_ms(plain, 3)
                src_b = (table.numel() * 2 if name == "fused_encode_bwd"
                         else _corner_bytes(n, L, F))
                in_b = x.numel() * 4 + g.numel() * 2 + rows.numel() * 4 \
                    + src_b
                out_b = want_t.numel() * 4 + want_x.numel() * 4
                t_bytes = (in_b + out_b) / HBM_BYTES_PER_S * 1e3
                # per (sample, level): 8 corners x F multiply-adds for the
                # table gradient and F for the position gradient's dot
                t_ops = n * L * 8 * F * 2 * 2 / F32_FLOPS * 1e3
                rec["bound_ms"] = max(t_bytes, t_ops)
                rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                # the kernel's own traffic: 8 corners x F bf16 read and
                # 8 x F f32 atomics per (sample, level)
                rec["corner_bytes"] = n * L * 8 * F * (2 + 4)
                results[name] = rec
            log(json.dumps({"kernel_check": rec}))
        del feats, want_t, want_x
        torch.cuda.empty_cache()
    return results


def compact_kernel_phase(budget, seed):
    """K4 bit-exact against its plain version on the warmup and top ray
    buckets' lattices at occupancy 1.0 and ~0.1; times the top bucket at
    ~0.1 (a carved steady-state grid) beside torch.nonzero."""
    import torch
    from cednerf_torch.ops import compact_kernels as ck
    from cednerf_torch.utils.bench import cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(seed)
    main = None
    for rays in (256, 16000):
        for occ in (1.0, 0.1):
            valid = torch.rand((rays, 1024), device="cuda",
                               generator=gen) < occ
            sel, kept = ck.compact_select_kernel(valid, budget)
            want = ck.compact_select_rayfold(valid, budget)
            torch.cuda.synchronize()
            if not (torch.equal(sel, want[0]) and torch.equal(kept, want[1])):
                raise AssertionError(f"compact_select {rays}x1024 occ {occ}: "
                                     "differs from its plain version")
            rec = {"name": "compact_select", "lattice": [rays, 1024],
                   "occupancy": occ, "budget": budget, "max_abs_err": 0,
                   "n_valid": int(valid.sum().item()),
                   "n_selected": int(kept.sum().item())}
            if rays == 16000 and occ == 0.1:
                rec["ms"] = cuda_ms(
                    lambda: ck.compact_select_kernel(valid, budget), 20)
                rec["plain_ms"] = cuda_ms(
                    lambda: ck.compact_select_rayfold(valid, budget), 3)
                flat = valid.reshape(-1)
                rec["library_ms"] = cuda_ms(lambda: torch.nonzero(flat), 20)
                n = valid.numel()
                # read the lattice once, write kept and sel once; the work
                # is a few integer operations per candidate
                t_bytes = (2 * n + 4 * budget) / HBM_BYTES_PER_S * 1e3
                t_ops = 4 * n / F32_FLOPS * 1e3
                rec["bound_ms"] = max(t_bytes, t_ops)
                rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                main = rec
            log(json.dumps({"kernel_check": rec}))
    return main


def scatter_kernel_phase(cfg, seed):
    """K3 against its plain version. The update rows of level 0 and of the
    last hashed level come from one backward of the full-width 4D field's
    encoder at the train step's N (positions and times uniform, a bf16
    cotangent with one row in eight zero, as unused budget slots carry):
    the wrapper is wrapped for that one call to keep what it is handed.
    Then a ragged M = 100,003 of random rows into the hashed table."""
    import torch
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags
    from cednerf_torch.ops import scatter_kernels as sk
    from cednerf_torch.utils.bench import HASH4D_FLAGS, cuda_ms

    field = build_field(cfg, ModelFlags(**HASH4D_FLAGS), device="cuda",
                        seed=seed)
    spec = field.hash_encoder.bspec
    n = cfg.sample_budget
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xn = torch.rand((n, 3), device="cuda", generator=gen)
    t = torch.rand((n, 1), device="cuda", generator=gen)
    g = torch.randn((n, spec.output_dim), device="cuda",
                    generator=gen).to(torch.bfloat16)
    g[::8] = 0
    lay = spec.level_layout()
    cases = [("level 0", lay[0]["rows"] * spec.keyframes),
             ("hashed level", lay[-1]["rows"] * spec.keyframes)]
    kept = {}
    real = sk.scatter_add_rows

    def keep(rows, upd, n_rows):
        if n_rows in {r for _, r in cases}:
            kept.setdefault(n_rows, (rows, upd))
        return real(rows, upd, n_rows)

    sk.scatter_add_rows = keep
    try:
        field.hash_encoder(xn, t).backward(g)
    finally:
        sk.scatter_add_rows = real
    del field
    cases = [(label, n_rows) + kept[n_rows] for label, n_rows in cases]
    m = 100_003
    cases.append(("ragged random rows", cases[1][1],
                  torch.randint(0, cases[1][1], (m,), device="cuda",
                                generator=gen, dtype=torch.int32),
                  torch.randn((m, spec.row_width), device="cuda",
                              generator=gen)))
    recs = []
    for label, n_rows, rows, upd in cases:
        want = sk.scatter_add_rows_plain(rows, upd, n_rows)
        got = real(rows, upd, n_rows)
        torch.cuda.synchronize()
        frac = _frac_err(got, want)
        if frac > K3_FRAC:
            raise AssertionError(f"scatter_add_rows {label}: error {frac} "
                                 f"of the largest entry (limit {K3_FRAC})")
        rows_m, w = upd.shape
        nnz = int((upd != 0).sum().item())
        t_bytes = (rows_m * 4 + upd.numel() * 4 + n_rows * w * 4) \
            / HBM_BYTES_PER_S * 1e3
        t_ops = nnz / F32_FLOPS * 1e3       # one add per nonzero lane
        rec = {"name": "scatter_add_rows", "case": label, "m": rows_m,
               "w": w, "n_rows": n_rows, "nonzero_lanes": nnz,
               "max_abs_err": (got - want).abs().max().item(),
               "err_frac": frac, "table_max": want.abs().max().item(),
               "ms": cuda_ms(lambda: real(rows, upd, n_rows), 20),
               "plain_ms": cuda_ms(
                   lambda: sk.scatter_add_rows_plain(rows, upd, n_rows), 5),
               "library_ms": cuda_ms(lambda: torch.zeros(
                   (n_rows, w), device="cuda").index_add_(0, rows, upd), 20),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        log(json.dumps({"kernel_check": rec}))
        recs.append(rec)
        del want, got
    del kept, cases
    torch.cuda.empty_cache()
    return recs


def reference_step_phase(seed, grid_type="hash3d"):
    """One train step of the shrunken config (SMALL) on the card, through
    each kernel route (for hash4d the one route: its backward on K3), and
    on the CPU through the plain versions: the same
    weights (tables uniform(-1, 1), so that the MLPs feel them), occupancy
    grid (30% of cells, numpy), ray batch (BallScene) and march jitter.
    n_valid must match, the loss within STEP_LOSS_RTOL, and each
    parameter's gradient within STEP_GRAD_REL of its L2 norm, the
    limits set out beside them (between the sound reading and a fault's).
    A backward kernel that dropped a corner, a level or the position
    gradient would move the table or motion-MLP gradients far past that."""
    import numpy as np
    import torch
    from cednerf_torch.bridge import occ_from_numpy
    from cednerf_torch.datasets.procedural import BallScene
    from cednerf_torch.engine import train as tt
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags, dnerf_config
    from cednerf_torch.ops.occupancy import create_occ_grid
    from cednerf_torch.utils.bench import TRAIN_FLAGS, load_uniform_tables

    cfg = dataclasses.replace(dnerf_config(), **SMALL)
    flags = ModelFlags(**TRAIN_FLAGS, grid_type=grid_type)
    routes = ("xla", "interp") if grid_type == "hash3d" else ("xla",)
    rng = np.random.default_rng(seed)
    res = cfg.grid_resolution
    bins = rng.uniform(size=(1, res, res, res)) < 0.3
    occs = np.where(bins, 0.5, 0.0).astype(np.float32).reshape(1, -1)
    aabbs = create_occ_grid(cfg.aabb, res, 1, device="cpu").aabbs.numpy()
    batch = BallScene(n_cams=4, wh=32, n_times=4, seed=seed).sample(128)
    jitter = rng.uniform(size=128).astype(np.float32)
    runs = {}
    for route, dev in (("plain", "cpu"),) + tuple((r, "cuda")
                                                 for r in routes):
        c = dataclasses.replace(cfg, interp_impl=route)
        f = build_field(c, flags, device=dev, seed=seed)
        load_uniform_tables([f], seed, 1.0)
        state = tt.create_train_state(f, c, device=dev)
        state.occ = occ_from_numpy(occs, bins, aabbs, device=dev)
        loss, aux = tt._make_loss_fn(c, flags, c.sample_budget)(
            state, {k: torch.as_tensor(np.asarray(v)).to(dev)
                    for k, v in batch.items()},
            jitter=torch.from_numpy(jitter).to(dev))
        runs[route] = (loss.item(), {k: v.item() for k, v in aux.items()},
                       {n: p.grad.detach().float().cpu()
                        for n, p in f.named_parameters()})
    loss0, aux0, g0 = runs["plain"]
    rec = {"grid_type": grid_type, "cpu_loss": loss0,
           "n_valid": aux0["n_valid"], "complete_frac": aux0["complete_frac"]}
    for route in routes:
        loss, aux, grads = runs[route]
        rels = {n: ((grads[n] - g0[n]).norm() / g0[n].norm()).item()
                for n in g0 if g0[n].norm() > 0}
        worst = max(rels, key=rels.get)
        rec[route] = {"loss": loss, "loss_rel_err": abs(loss - loss0) / loss0,
                      "n_valid": aux["n_valid"],
                      "worst_grad": worst, "worst_grad_rel_err": rels[worst],
                      "encoder_grad_rel_err": {
                          n: rels[n] for n in rels if "hash_encoder" in n}}
        if aux["n_valid"] != aux0["n_valid"]:
            raise AssertionError(f"reference step ({route}): n_valid "
                                 f"{aux['n_valid']} != {aux0['n_valid']}")
        if abs(loss - loss0) > STEP_LOSS_RTOL * abs(loss0):
            raise AssertionError(f"reference step ({route}): loss {loss} vs "
                                 f"{loss0}")
        if rels[worst] > STEP_GRAD_REL:
            raise AssertionError(f"reference step ({route}): gradient of "
                                 f"{worst} off by {rels[worst]}: {rec}")
    return rec


def _drive(trainer, cfg, n, label):
    """`n` steps of trainer.run_step with every launch counter zeroed just
    before and read just after: (per-step records, launch counts). Fails on
    a non-finite loss or a plain version run on CUDA."""
    import numpy as np
    import torch

    reset_counts()
    recs = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        occ_step = trainer.step % cfg.occ_update_interval == 0
        m = trainer.run_step()
        torch.cuda.synchronize()
        m["ms"] = (time.perf_counter() - t0) * 1e3
        m["occ_update"] = occ_step
        if not np.isfinite(m["loss"]):
            raise AssertionError(f"{label} step {trainer.step}: loss "
                                 f"{m['loss']}")
        recs.append(m)
    counts, plain = all_counts()
    if any(plain.values()):
        raise AssertionError(f"{label}: plain versions ran on CUDA: {plain}")
    no_probe_kernels(label, counts)
    return recs, counts


def _train_summary(recs, cfg, counts, tag):
    """PSNR rise (fails unless the last 8 steps' mean is above the first
    8's), step times and rates; logs a few steps' records under `tag`."""
    import numpy as np

    steps = len(recs)
    psnr = [r["psnr"] for r in recs]
    first, last = float(np.mean(psnr[:8])), float(np.mean(psnr[-8:]))
    if not last > first:
        raise AssertionError(f"{tag}: PSNR did not rise: first 8 {first}, "
                             f"last 8 {last}")
    steady = [r for r in recs[cfg.occ_warmup_steps:] if not r["occ_update"]]
    warm = [r for r in recs[:cfg.occ_warmup_steps] if not r["occ_update"]]
    step_ms = float(np.median([r["ms"] for r in steady or recs]))
    for i in sorted({0, 7, cfg.occ_warmup_steps - 1, steps - 1}):
        if i < steps:
            log(json.dumps({tag: i, **recs[i]}))
    return {
        "steps": steps, "psnr_first8": first, "psnr_last8": last,
        "median_ms_per_step": step_ms,
        "median_ms_per_warmup_step": float(np.median(
            [r["ms"] for r in warm])) if warm else None,
        "occ_update_step_ms": float(np.median(
            [r["ms"] for r in recs if r["occ_update"]])),
        "budget_slots_per_s": cfg.sample_budget / step_ms * 1e3,
        "valid_samples_per_s": float(np.median(
            [r["n_samples"] / r["ms"] * 1e3 for r in steady or recs])),
        "last": {k: recs[-1][k] for k in ("num_rays", "n_valid", "n_samples",
                                          "complete_frac", "loss", "psnr")},
        "buckets_visited": sorted({r["num_rays"] for r in recs}),
        "launches": counts}


def training_phase(cfg, flags, seed, steps=TRAIN_STEPS,
                   interp_steps=INTERP_STEPS):
    """Trainer.run_step at full width: `steps` default-route steps, then
    `interp_steps` on the K1/K2 route, with launch counts per route."""
    import numpy as np
    import torch
    from cednerf_torch.datasets.procedural import BallCloudScene
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.train import Trainer
    from cednerf_torch.ops import compact_kernels as ck
    from cednerf_torch.ops import encode_kernels as ek

    field = build_field(cfg, flags, device="cuda", seed=seed)
    trainer = Trainer(field, cfg, flags, BallCloudScene(seed=seed),
                      seed=seed, device="cuda")

    recs, counts = _drive(trainer, cfg, steps, "default route")
    for k in ("fused_encode_fwd", "fused_encode_bwd", "compact_select"):
        if counts[k] == 0:
            raise AssertionError(f"default route: {k} never launched: "
                                 f"{counts}")
    if (counts["interp_fwd"] or counts["interp_bwd_fused"]
            or counts["scatter_add_rows"]):
        raise AssertionError(f"default route took K1/K2/K3: {counts}")
    summary = _train_summary(recs, cfg, counts, "train_step")

    spec = field.hash_encoder.bspec
    field.hash_encoder.bspec = dataclasses.replace(spec, interp_impl="interp")
    irecs, icounts = _drive(trainer, cfg, interp_steps, "interp route")
    for k in ("interp_fwd", "interp_bwd_fused", "compact_select"):
        if icounts[k] == 0:
            raise AssertionError(f"interp route: {k} never launched: "
                                 f"{icounts}")
    if (icounts["fused_encode_fwd"] or icounts["fused_encode_bwd"]
            or icounts["scatter_add_rows"]):
        raise AssertionError(f"interp route took K5/K6/K3: {icounts}")
    summary["interp"] = {
        "steps": interp_steps, "launches": icounts,
        "median_ms_per_step": float(np.median([r["ms"] for r in irecs])),
        "psnr": [r["psnr"] for r in irecs]}
    return summary


def hash4d_phase(cfg, seed, steps=HASH4D_STEPS):
    """Trainer.run_step on the full-width 4D keyframe field for `steps`
    steps, then one 400x400 frame at 128 samples of the trained field and
    its occupancy grid through ViewerServer."""
    import torch
    from cednerf_torch.datasets.procedural import BallCloudScene
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags
    from cednerf_torch.engine.train import Trainer
    from cednerf_torch.utils.bench import HASH4D_FLAGS, orbit_c2w
    from cednerf_torch.viewer.server import ViewerServer

    flags = ModelFlags(**HASH4D_FLAGS)
    field = build_field(cfg, flags, device="cuda", seed=seed)
    n_levels = field.hash_encoder.bspec.n_levels
    trainer = Trainer(field, cfg, flags, BallCloudScene(seed=seed),
                      seed=seed, device="cuda")
    recs, counts = _drive(trainer, cfg, steps, "hash4d")
    if counts["scatter_add_rows"] != n_levels * steps:
        raise AssertionError(f"hash4d: K3 launched {counts['scatter_add_rows']}"
                             f" times in {steps} steps, not {n_levels} a step")
    if counts["compact_select"] != steps:
        raise AssertionError(f"hash4d: K4 launched {counts['compact_select']}"
                             f" times in {steps} steps")
    if any(counts[k] for k in ("fused_encode_fwd", "fused_encode_bwd",
                               "interp_fwd", "interp_bwd_fused")):
        raise AssertionError(f"hash4d took a 3D kernel: {counts}")
    summary = _train_summary(recs, cfg, counts, "hash4d_step")

    server = ViewerServer(field, trainer.state.occ, cfg, wh=(400, 400),
                          render_bkgd=(1, 1, 1))
    httpd = server.start(port=0, host="127.0.0.1")
    port = httpd.server_address[1]
    try:
        post_render(port, orbit_c2w(), 0.25, 64, 32, False)    # warm-up
        reset_counts()
        _, wall_ms, n_bytes = post_render(port, orbit_c2w(), 0.5, 400, 128,
                                          False)
        launches, plain = all_counts()
        stats = server.last_frame
    finally:
        httpd.shutdown()
        httpd.server_close()
    if not stats["finite"]:
        raise AssertionError("hash4d frame: non-finite values")
    if any(plain.values()) or any(launches.values()):
        raise AssertionError(f"hash4d frame: launches {launches}, plain "
                             f"versions on CUDA {plain} (its forward is "
                             "plain PyTorch, no kernel)")
    summary["frame"] = {
        "t": 0.5, "width": 400, "max_samples": 128,
        "render_ms": stats["ms"], "http_ms": wall_ms, "png_bytes": n_bytes,
        "chunks": len(stats["passes_per_chunk"]),
        "passes_per_chunk": stats["passes_per_chunk"], "launches": launches}
    log(json.dumps({"hash4d_frame": summary["frame"]}))
    return summary


def interp_bwd_kernel_phase(spec, n_main, n_ragged, seed):
    """K7 against its plain version on the full-width field's levels,
    tables uniform(-8, 8), f32 update rows, at the probe's sample count and
    at a ragged one; one bf16 cotangent row in eight zero."""
    import torch
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.ops.brick_grid import _level_geom
    from cednerf_torch.utils.bench import cuda_ms

    lay = spec.level_layout()
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    level_rows = [l["rows"] for l in lay]
    L, F = spec.n_levels, spec.n_features
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tables = [((torch.rand((r, 64 * F), device="cuda", generator=gen) * 2
                - 1) * REF_TABLE_BOUND).to(torch.bfloat16) for r in level_rows]
    main = None
    for n in (n_main, n_ragged):
        x = torch.rand((n, 3), device="cuda", generator=gen)
        g = (torch.randn((n, L * F), device="cuda", generator=gen) * 1e-3
             ).to(torch.bfloat16)
        g[::8] = 0
        feats = torch.stack([tables[l].index_select(0, _level_geom(
            x, scales[l], nbs[l], lay[l]["hashed"], level_rows[l])[0].long())
            for l in range(L)]).contiguous()
        want_u, want_x = ek.interp_bwd_plain(x, g, feats, scales, nbs, F)
        upd, d_x = ek.interp_bwd(x, g, feats, scales, nbs, F)
        torch.cuda.synchronize()
        errs = [_frac_err(upd[l], want_u[l]) for l in range(L)]
        err_x = _frac_err(d_x, want_x)
        if max(errs) > K7_UPD_FRAC or err_x > K7_DX_FRAC:
            raise AssertionError(
                f"interp_bwd N={n}: upd errors per level {errs} (limit "
                f"{K7_UPD_FRAC}), d_x {err_x} (limit {K7_DX_FRAC})")
        rec = {"name": "interp_bwd", "n": n, "levels": L, "n_feat": F,
               "max_abs_err": max((upd - want_u).abs().max().item(),
                                  (d_x - want_x).abs().max().item()),
               "upd_err_frac_per_level": errs, "dx_err_frac": err_x,
               "nonzero_upd_lanes": int((upd != 0).sum().item())}
        del upd, want_u
        if n == n_main:
            rec["ms"] = cuda_ms(
                lambda: ek.interp_bwd(x, g, feats, scales, nbs, F), 20)
            rec["plain_ms"] = cuda_ms(
                lambda: ek.interp_bwd_plain(x, g, feats, scales, nbs, F), 3)
            rec["library_ms"] = None      # no one PyTorch call computes it
            # the f32 rows written once (every lane), x, g and the 8
            # corners of each (sample, level) read once, d_x written once
            out_b = L * n * 64 * F * 4 + n * 3 * 4
            in_b = x.numel() * 4 + g.numel() * 2 + _corner_bytes(n, L, F)
            t_bytes = (in_b + out_b) / HBM_BYTES_PER_S * 1e3
            # per (sample, level): 8F products for the rows, 8F
            # multiply-adds for d_x
            t_ops = n * L * 8 * F * 2 * 2 / F32_FLOPS * 1e3
            rec["bound_ms"] = max(t_bytes, t_ops)
            rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            rec["upd_bytes"] = L * n * 64 * F * 4
            main = rec
        log(json.dumps({"kernel_check": rec}))
        del feats, want_x
        torch.cuda.empty_cache()
    return main


def interp_enc_probe_phase(seed):
    """cednerf_torch.tools.profile_interp_enc at its defaults, counted; then
    its timings from a second run."""
    import torch
    from cednerf_torch.tools import profile_interp_enc as pie

    reset_counts()
    res = pie.run(device="cuda", seed=seed, reps=0)
    torch.cuda.synchronize()
    launches, plain = all_counts()
    log(json.dumps({"probe_interp_enc": res, "launches": launches}))
    if not res["ok"]:
        raise AssertionError(f"profile_interp_enc: outside its limits: {res}")
    want = {"interp_bwd": 1, "scatter_add_rows": res["levels"],
            "interp_fwd": 1, "row_gather": 0}
    if any(launches[k] != v for k, v in want.items()) or any(plain.values()):
        raise AssertionError(f"profile_interp_enc: launches {launches} (want "
                             f"{want}), plain on CUDA {plain}")
    ms = pie.run(device="cuda", seed=seed, reps=20)["ms"]
    log(json.dumps({"probe_interp_enc_ms": ms}))
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms}


def row_gather_kernel_phase(seed, rows=442_368, n=1_048_576):
    """K8 bit-exact against its plain version: the probe's bf16 tables at
    W = 128 and 256, a W = 128 f32 table, and a ragged N with 1% of the
    indices out of range; the in-range cases timed beside their bound and
    index_select (which cannot take an out-of-range index)."""
    import torch
    from cednerf_torch.ops import gather_kernels as gk
    from cednerf_torch.tools.profile_row_gather import bits_equal
    from cednerf_torch.utils.bench import cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(seed)
    idx = torch.randint(0, rows, (n,), device="cuda", generator=gen,
                        dtype=torch.int32)
    ragged = torch.randint(0, rows, (1_000_003,), device="cuda",
                           generator=gen, dtype=torch.int32)
    ragged[::100] = torch.randint(-rows, 2 * rows, ragged[::100].shape,
                                  device="cuda", generator=gen,
                                  dtype=torch.int32)
    cases = [("W=128 bf16", torch.bfloat16, 128, idx),
             ("W=256 bf16", torch.bfloat16, 256, idx),
             ("W=128 f32", torch.float32, 128, idx),
             ("ragged, out of range", torch.bfloat16, 256, ragged)]
    recs = {}
    for label, dtype, w, ix in cases:
        table = torch.randn((rows, w), device="cuda", generator=gen).to(dtype)
        want = gk.row_gather_plain(table, ix)
        got = gk.row_gather(table, ix)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            raise AssertionError(f"row_gather {label}: differs from its "
                                 "plain version")
        valid = ix[(ix >= 0) & (ix < rows)]
        distinct = int(torch.unique(valid).numel())
        rec = {"name": "row_gather", "case": label, "rows": rows, "w": w,
               "n": ix.shape[0], "dtype": str(dtype).split(".")[1],
               "rows_in_flight": gk.DEFAULT_ROWS_IN_FLIGHT, "max_abs_err": 0,
               "out_of_range": int(ix.shape[0] - valid.shape[0]),
               "distinct_rows": distinct}
        del got, want
        if rec["out_of_range"] == 0:
            es = table.element_size()
            rec["ms"] = cuda_ms(lambda: gk.row_gather(table, ix), 20)
            rec["plain_ms"] = cuda_ms(lambda: gk.row_gather_plain(table, ix),
                                      5)
            rec["library_ms"] = cuda_ms(lambda: table.index_select(0, ix), 20)
            # the output written once, the index read once, each distinct
            # row read once; no arithmetic
            rec["bound_ms"] = (ix.shape[0] * w * es + ix.shape[0] * 4
                               + distinct * w * es) / HBM_BYTES_PER_S * 1e3
            rec["bound_by"] = "bytes"
        log(json.dumps({"kernel_check": rec}))
        recs[label] = rec
        del table
    torch.cuda.empty_cache()
    return recs


def row_gather_probe_phase(seed):
    """cednerf_torch.tools.profile_row_gather at its defaults, counted."""
    import torch
    from cednerf_torch.ops import gather_kernels as gk
    from cednerf_torch.tools import profile_row_gather as prg

    reset_counts()
    res = prg.run(device="cuda", seed=seed)
    torch.cuda.synchronize()
    launches, plain = all_counts()
    for rec in res["widths"]:
        log(json.dumps({"probe_row_gather": rec}))
    # each setting: the match run, cuda_ms's warm-up and 20 timed calls
    want = len(res["widths"]) * len(gk.ROWS_IN_FLIGHT) * (1 + 1 + 20)
    if not res["all_match"]:
        raise AssertionError("profile_row_gather: a setting did not match "
                             "index_select")
    others = {k: v for k, v in launches.items() if k != "row_gather" and v}
    if launches["row_gather"] != want or others or any(plain.values()):
        raise AssertionError(f"profile_row_gather: launches {launches} (want "
                             f"row_gather {want} alone), plain on CUDA "
                             f"{plain}")
    return {"launches": launches, "widths": res["widths"]}


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
    from cednerf_torch.ops.cuda_build import build_all
    from cednerf_torch.utils.bench import (TRAIN_FLAGS, card_name,
                                           fill_occupancy)

    t_start = time.perf_counter()
    log(card_name())
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    builds = build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        + ", ".join(f"{k} (nvcc {v[0]:.2f} s)" for k, v in builds.items()))
    for stem, (_, build_log) in builds.items():
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {stem}: " + line.strip())

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
    kern.update(backward_kernel_phase(field, cfg.sample_budget, 100_003,
                                      args.seed))
    kern["compact_select"] = compact_kernel_phase(cfg.sample_budget,
                                                  args.seed)

    t0 = time.perf_counter()
    occ = fill_occupancy(field, cfg, args.seed, "cuda")
    torch.cuda.synchronize()
    occ_frac = occ.binaries.float().mean().item()
    log(f"occupancy: {cfg.grid_resolution}^3 all-cells update "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, occupied {occ_frac:.4f}")

    ref = reference_phase(field, occ, cfg, flags, args.seed)
    log(json.dumps({"reference": ref}))

    frames, serve_launches = serving_phase(field, field_k1, occ, cfg)
    spec3d = field.hash_encoder.bspec
    del field, field_k1, occ
    torch.cuda.empty_cache()

    log(json.dumps({"reference_step": reference_step_phase(args.seed)}))

    train = training_phase(cfg, ModelFlags(**TRAIN_FLAGS), args.seed)
    log(json.dumps({"training": train}))
    torch.cuda.empty_cache()

    k3 = scatter_kernel_phase(cfg, args.seed)
    kern["scatter_add_rows"] = k3[1]          # the hashed level
    log(json.dumps({"reference_step": reference_step_phase(args.seed,
                                                           "hash4d")}))
    h4 = hash4d_phase(cfg, args.seed)
    log(json.dumps({"hash4d_training": h4}))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    kern["interp_bwd"] = interp_bwd_kernel_phase(spec3d, 262_144, 100_003,
                                                 args.seed)
    probe_enc = interp_enc_probe_phase(args.seed)
    k8 = row_gather_kernel_phase(args.seed)
    kern["row_gather"] = k8["W=256 bf16"]
    probe_gather = row_gather_probe_phase(args.seed)
    log(f"probe phases 11-12: {time.perf_counter() - t0:.1f} s")

    replaces = {
        "fused_encode_fwd": "cednerf_tpu/ops/pallas_fused.py:138",
        "interp_fwd": "cednerf_tpu/ops/pallas_encoder.py:136",
        "fused_encode_bwd": "cednerf_tpu/ops/pallas_fused.py:244",
        "interp_bwd_fused": "cednerf_tpu/ops/pallas_encoder.py:307",
        "compact_select": "cednerf_tpu/ops/pallas_compact.py:47",
        "scatter_add_rows": "cednerf_tpu/ops/pallas_scatter.py:87",
        "interp_bwd": "cednerf_tpu/ops/pallas_encoder.py:180",
        "row_gather": "cednerf_tpu/ops/pallas_gather.py:27",
    }
    sources = {
        "fused_encode_fwd": "cednerf_torch/csrc/brick_encode_fwd.cu",
        "interp_fwd": "cednerf_torch/csrc/brick_encode_fwd.cu",
        "fused_encode_bwd": "cednerf_torch/csrc/brick_encode_bwd.cu",
        "interp_bwd_fused": "cednerf_torch/csrc/brick_encode_bwd.cu",
        "compact_select": "cednerf_torch/csrc/compact_select.cu",
        "scatter_add_rows": "cednerf_torch/csrc/scatter_add_rows.cu",
        "interp_bwd": "cednerf_torch/csrc/brick_encode_bwd.cu",
        "row_gather": "cednerf_torch/csrc/row_gather.cu",
    }
    line = []
    for name in replaces:
        r = kern[name]
        by_path = {"serve": serve_launches.get(name, 0),
                   "train": train["launches"].get(name, 0),
                   "train_interp": train["interp"]["launches"].get(name, 0),
                   "train_hash4d": h4["launches"].get(name, 0),
                   "serve_hash4d": h4["frame"]["launches"].get(name, 0),
                   "probe_interp_enc": probe_enc["launches"].get(name, 0),
                   "probe_row_gather": probe_gather["launches"].get(name, 0)}
        line.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms")})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
