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
     frame's passes and host syncs.

Prints JSON lines; writes the profiler's table under --out.
"""

import argparse
import json
import os
import sys
import time


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
    from cednerf_torch.engine.config import ModelFlags, dnerf_config
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.ops.brick_grid import _level_geom, level_tables
    from cednerf_torch.utils.bench import (card_name, cuda_ms, fill_occupancy,
                                           orbit_c2w)
    from cednerf_torch.viewer.server import ViewerServer

    card = card_name()
    print(card, flush=True)
    ek.build()
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

    # 2. one 400x400 frame under the profiler
    server = ViewerServer(field, occ, cfg, wh=(400, 400),
                          render_bkgd=(1, 1, 1))
    c2w = orbit_c2w()
    server.render_frame(c2w, 0.5, 400, 128, False)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.render_frame(c2w, 0.5, 400, 128, False)
    plain_frame_ms = (time.perf_counter() - t0) * 1e3
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.render_frame(c2w, 0.5, 400, 128, False)
        torch.cuda.synchronize()
        prof_frame_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # kernel rows only: an operator row (aten::...) repeats its kernels' time
    rows_ = sorted(((e.key, e.count, dev_us(e) / 1e3) for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and dev_us(e) > 0), key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows_)
    passes = server.last_frame["passes_per_chunk"]
    print(json.dumps({"frame": {
        "width": 400, "max_samples": 128, "frame_ms": plain_frame_ms,
        "profiled_frame_ms": prof_frame_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / prof_frame_ms,
        "chunks": len(passes), "passes": sum(map(sum, passes)),
        "passes_per_chunk": passes}}), flush=True)
    for key, count, ms in rows_[:15]:
        print(json.dumps({"kernel": key[:90], "calls": count,
                          "device_ms": ms,
                          "share": ms / device_ms if device_ms else None}),
              flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "key_averages.txt"), "w") as fh:
        fh.write(card + "\n")
        fh.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
