#!/usr/bin/env python3
"""Where a served frame's time goes on the card (cednerf_torch, one GPU).

    python3 profile_serving.py [--seed 0] [--out results/profile_serving]

Same configuration as chip_smoke.py (dnerf_config, -te -ta -f -df, random
weights from --seed, 128^3 occupancy filled by one all-cells update). Then:

  1. components at one full seg-eval pass (N = 2,097,152 samples), CUDA
     events: the field forward, brick_encode alone (row geometry, table
     prep and the K5 launch), the K5 launch alone, and the rest of the field
     (motion MLP, encodings, density and colour MLPs) as the difference;
  2. one 400x400 frame at max_samples 128 through ViewerServer.render_frame
     under torch.profiler: device time by kernel name, the sum of device
     time against the frame's wall time (the device's busy share), and the
     frame's passes;
  3. the same for one 400x400 frame at max_samples 128 of the HyperNeRF
     preset (hypernerf_config("vrig_3dprinter"), the same flags, random
     weights, its 2-level 128^3 grid filled by one all-cells update, black
     background) through the lattice eval marcher.

Prints JSON lines; writes the profiler's tables under --out.
"""

import argparse
import json
import os
import sys
import time


def profile_frame(server, label, card, out, width=400, max_samples=128):
    """One frame of `server` timed plain, then one under torch.profiler:
    prints the frame's JSON line under `label` and its 15 costliest
    kernels, and writes the profiler's table to out/<label>_key_averages.txt
    (the seg frame's keeps its name, key_averages.txt)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cednerf_torch.utils.bench import device_time_by_kernel, orbit_c2w

    c2w = orbit_c2w()
    server.render_frame(c2w, 0.5, width, max_samples, False)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.render_frame(c2w, 0.5, width, max_samples, False)
    plain_frame_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.render_frame(c2w, 0.5, width, max_samples, False)
        torch.cuda.synchronize()
        prof_frame_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    rows_, device_ms = device_time_by_kernel(prof)
    passes = server.last_frame["passes_per_chunk"]
    print(json.dumps({label: {
        "config": server.cfg.family, "width": width,
        "max_samples": max_samples, "frame_ms": plain_frame_ms,
        "profiled_frame_ms": prof_frame_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / prof_frame_ms,
        "chunks": len(passes), "passes": sum(map(sum, passes)),
        "passes_per_chunk": passes}}), flush=True)
    for key, count, ms in rows_[:15]:
        print(json.dumps({"kernel": key[:90], "frame": label, "calls": count,
                          "device_ms": ms,
                          "share": ms / device_ms if device_ms else None}),
              flush=True)
    os.makedirs(out, exist_ok=True)
    name = ("" if label == "frame" else label + "_") + "key_averages.txt"
    with open(os.path.join(out, name), "w") as fh:
        fh.write(card + "\n")
        fh.write(events.table(sort_by="self_cuda_time_total", row_limit=60))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/profile_serving")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_serving: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import (ModelFlags, dnerf_config,
                                             hypernerf_config)
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.ops.brick_grid import _level_geom, level_tables
    from cednerf_torch.ops.cuda_build import build_all
    from cednerf_torch.utils.bench import card_name, cuda_ms, fill_occupancy
    from cednerf_torch.viewer.server import ViewerServer

    card = card_name()
    print(card, flush=True)
    build_all()
    cfg = dnerf_config()
    flags = ModelFlags(use_time_embedding=True, use_time_attenuation=True,
                       use_feat_predict=True, use_div_offsets=True)
    field = build_field(cfg, flags, device="cuda", seed=args.seed)
    occ = fill_occupancy(field, cfg, args.seed, "cuda")

    # 1. components at one full pass
    n = cfg.eval_chunk_seg * 64
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    lo = torch.tensor(cfg.aabb[:3], device="cuda")
    hi = torch.tensor(cfg.aabb[3:], device="cuda")
    pos = lo + (hi - lo) * torch.rand((n, 3), device="cuda", generator=gen)
    t = torch.full((n, 1), 0.5, device="cuda")
    dirs = torch.nn.functional.normalize(
        torch.randn((n, 3), device="cuda", generator=gen), dim=-1)
    xn = torch.rand((n, 3), device="cuda", generator=gen)
    enc = field.hash_encoder
    spec = enc.bspec
    lay = spec.level_layout()
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    level_rows = [l["rows"] for l in lay]
    with torch.inference_mode():
        rows = torch.stack([_level_geom(xn, scales[i], nbs[i], l["hashed"],
                                        l["rows"])[0]
                            for i, l in enumerate(lay)]).contiguous()
        table = torch.cat([tb.to(torch.bfloat16) for tb in
                           level_tables(enc.tables(), spec)]).contiguous()
        comp = {
            "n": n,
            "field_forward_ms": cuda_ms(lambda: field(pos, t, dirs), 10),
            "brick_encode_ms": cuda_ms(lambda: enc(xn), 10),
            "k5_ms": cuda_ms(lambda: ek.fused_encode_fwd(
                xn, table, rows, scales, nbs, level_rows, spec.n_features),
                10),
        }
    comp["encoder_prep_ms"] = comp["brick_encode_ms"] - comp["k5_ms"]
    comp["field_rest_ms"] = comp["field_forward_ms"] - comp["brick_encode_ms"]
    print(json.dumps({"components": comp}), flush=True)

    # 2. one 400x400 seg-eval frame under the profiler
    server = ViewerServer(field, occ, cfg, wh=(400, 400),
                          render_bkgd=(1, 1, 1))
    profile_frame(server, "frame", card, args.out)
    del server, field, occ
    torch.cuda.empty_cache()

    # 3. one 400x400 HyperNeRF lattice frame under the profiler
    hcfg = hypernerf_config("vrig_3dprinter")
    hfield = build_field(hcfg, flags, device="cuda", seed=args.seed)
    hocc = fill_occupancy(hfield, hcfg, args.seed, "cuda")
    profile_frame(ViewerServer(hfield, hocc, hcfg, wh=(400, 400)),
                  "hypernerf_frame", card, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
