#!/usr/bin/env python3
"""Where a train step's time goes on the card (cednerf_torch, one GPU).

    python3 profile_training.py [--seed 0] [--steps 288] [--profile-steps 8]
                                [--interp | --hash4d | --triplane]
                                [--out results/profile_training]
    python3 profile_training.py --chunk [--steps-per-call 16] [--steps 448]

The configuration of chip_smoke.py's training phase: dnerf_config() with
-te -ta -f -ae -df -d (L8 F4, dst resolution 1024, 2^21 hashmap, 16384-row
cap, budget 262,144 samples, 1024 march steps, 128^3 occupancy), random
weights from --seed, BallCloudScene; with --hash4d the 4D keyframe
encoder (--grid_type hash4d, K = 4: 4x the tables, a plain PyTorch forward
and the K3 table-gradient scatter in its backward); with --triplane the
tri-plane encoder (--grid_type triplane: plane resolution 1024, F = 4, 8
levels, plain PyTorch with K3 summing the texel gradient). Then:

  1. --steps steps of Trainer.run_step (by default past the 256-step
     all-cells occupancy warmup, so that the grid has carved and the ray
     bucket has adapted), ms per step on the host clock;
  2. --profile-steps further steps under torch.profiler: device time by
     kernel, the sum of device time against the steps' wall time (the
     device's busy share; the profiler's own host overhead lowers it, so
     step 1's unprofiled ms beside the device ms is the fairer ratio),
     kernel launches per step, the host-side operators by CPU time, and
     the share of the port's kernels (K5/K6/K4, K1/K2/K4 with --interp,
     K3/K4 with --hash4d);
  3. components at the last step's shapes, CUDA events: the field forward
     and forward+backward at the budget, K6 (3D only) and K4 alone; in 3D
     also the step's encoder backward (K6, or K2 with --interp) on one more
     step's own batch (`k6_step_ms` / `k2_step_ms`); with --triplane,
     on one more step's own encoder inputs, the encoder's forward and
     backward (`plane_interp_fwd_bwd_ms`), and the texel gradient's sum
     alone on those indices with random f32 terms: K3 (`texel_k3_ms`),
     its stable sort alone (`texel_sort_ms`, key_sort; torch.sort's
     `texel_torch_sort_ms`) and index_add_ (`texel_index_add_ms`).

With --chunk it compares the two ways the Trainer steps instead, in one
process on one card: run_step (a host batch uploaded and the metrics read
back every step) and run_chunk (BallCloudScene's device sampler,
--steps-per-call steps a dispatch, one metrics read a chunk), each for
--steps steps from the same seed, in the order step, chunk, chunk, step.
It reports, for each run, the host ms per step over the --steps-per-call
step windows after the occupancy warmup (each window holds one occupancy
update, for either path) and their median, then over one window past
them (--profile-steps steps of run_step, one chunk of run_chunk) the
device ms and kernel launches per step under torch.profiler and the host
syncs per step (synchronizing calls counted under
torch.cuda.set_sync_debug_mode("warn")), and the steady lattice that
run_chunk's adaptation reached.

Prints JSON lines; writes the profiler's table under --out.
"""

import argparse
import dataclasses
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=None,
                    help="steps to run (default 288; 448 with --chunk)")
    ap.add_argument("--profile-steps", type=int, default=8)
    ap.add_argument("--interp", action="store_true",
                    help="take the K1/K2 route (interp_impl='interp')")
    ap.add_argument("--hash4d", action="store_true",
                    help="train the 4D keyframe encoder (grid_type hash4d)")
    ap.add_argument("--triplane", action="store_true",
                    help="train the tri-plane encoder (grid_type triplane)")
    ap.add_argument("--out", default="results/profile_training")
    ap.add_argument("--chunk", action="store_true",
                    help="compare run_chunk with run_step (see above)")
    ap.add_argument("--steps-per-call", type=int, default=16)
    args = ap.parse_args(argv)
    if args.steps is None:
        args.steps = 448 if args.chunk else 288
    if args.chunk:
        return chunk_main(args)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_training: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cednerf_torch.datasets.procedural import BallCloudScene
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags, dnerf_config
    from cednerf_torch.engine.train import Trainer
    from cednerf_torch.ops import compact_kernels as ck
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.ops import scatter_kernels as sk
    from cednerf_torch.ops.brick_grid import _level_geom
    from cednerf_torch.ops.cuda_build import build_all
    from cednerf_torch.utils.bench import (HASH4D_FLAGS, TRAIN_FLAGS,
                                           card_name, cuda_ms,
                                           device_time_by_kernel)

    card = card_name()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    cfg = dnerf_config()
    if args.interp:
        cfg = dataclasses.replace(cfg, interp_impl="interp")
    flags = ModelFlags(**(HASH4D_FLAGS if args.hash4d else TRAIN_FLAGS))
    if args.triplane:
        flags = dataclasses.replace(flags, grid_type="triplane")
    field = build_field(cfg, flags, device="cuda", seed=args.seed)
    trainer = Trainer(field, cfg, flags, BallCloudScene(seed=args.seed),
                      seed=args.seed, device="cuda")

    # 1. steps on the host clock
    ms = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.run_step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    tail = ms[cfg.occ_warmup_steps:] or ms
    print(json.dumps({"steps": {
        "grid_type": flags.grid_type, "n": args.steps, "median_ms": float(np.median(ms)),
        "median_ms_after_warmup": float(np.median(tail)),
        "last": m}}), flush=True)

    # 2. steady steps under the profiler
    from torch.profiler import ProfilerActivity, profile
    for mod in (ek, ck, sk):
        mod.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = [trainer.run_step() for _ in range(args.profile_steps)]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, device_ms = device_time_by_kernel(prof)
    ours = [r for r in rows if any(k in r[0] for k in (
        "fused_encode", "interp_fwd", "encode_bwd", "compact_select",
        "table_reduce", "rows_reduce", "scatter_rows",
        "fold_cells", "keysort"))]
    cpu_ops = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CPU),
                     key=lambda e: -e.self_cpu_time_total)
    print(json.dumps({"profile": {
        "steps": args.profile_steps, "wall_ms_per_step":
        wall_ms / args.profile_steps,
        "device_ms_per_step": device_ms / args.profile_steps,
        "device_busy_share": device_ms / wall_ms,
        "unprofiled_busy_share": device_ms / args.profile_steps
        / float(np.median(tail)),
        "kernel_launches_per_step":
        sum(r[1] for r in rows) / args.profile_steps,
        "port_kernels_ms_per_step":
        sum(r[2] for r in ours) / args.profile_steps,
        "launches": {**ek.launches, **ck.launches, **sk.launches},
        "num_rays": [r["num_rays"] for r in recs],
        "n_samples": [r["n_samples"] for r in recs],
        "n_valid": [r["n_valid"] for r in recs]}}), flush=True)
    for key, count, dms in rows[:25]:
        print(json.dumps({"kernel": key[:90], "calls": count,
                          "device_ms_per_step": dms / args.profile_steps,
                          "share": dms / device_ms if device_ms else None}),
              flush=True)
    for e in cpu_ops[:12]:
        print(json.dumps({"host_op": e.key[:60], "calls": e.count,
                          "self_cpu_ms_per_step": e.self_cpu_time_total
                          / 1e3 / args.profile_steps}), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "key_averages.txt"), "w") as fh:
        fh.write(card + "\n")
        fh.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                           row_limit=80))
        fh.write("\n")
        fh.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                           row_limit=40))

    # 3. components at the budget
    n = cfg.sample_budget
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    lo = torch.tensor(cfg.aabb[:3], device="cuda")
    hi = torch.tensor(cfg.aabb[3:], device="cuda")
    pos = lo + (hi - lo) * torch.rand((n, 3), device="cuda", generator=gen)
    t = torch.rand((n, 1), device="cuda", generator=gen)
    dirs = torch.nn.functional.normalize(
        torch.randn((n, 3), device="cuda", generator=gen), dim=-1)

    def fwd_bwd():
        rgb, res = field(pos, t, dirs, return_internal=True)
        (rgb.sum() + res["density"].sum()
         + res["internal"]["latent_losses"].sum()).backward()

    valid = torch.rand((m["num_rays"], cfg.max_march_steps), device="cuda",
                       generator=gen) < m["n_valid"] / (
                           m["num_rays"] * cfg.max_march_steps)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: field(pos, t, dirs), 10)
    comp = {
        "n": n, "field_forward_ms": fwd_ms,
        "field_forward_backward_ms": cuda_ms(fwd_bwd, 10),
        "k4_ms": cuda_ms(lambda: ck.compact_select_kernel(
            valid, cfg.sample_budget), 10),
        "k4_lattice": list(valid.shape)}
    if args.triplane:
        comp.update(_texel_components(trainer, gen, cuda_ms))
        print(json.dumps({"components": comp}), flush=True)
        return 0
    spec = field.hash_encoder.bspec
    lay = spec.level_layout()
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    level_rows = [l["rows"] for l in lay]
    xn = torch.rand((n, 3), device="cuda", generator=gen)
    rows = torch.stack([_level_geom(xn, scales[i], nbs[i], l["hashed"],
                                    l["rows"])[0]
                        for i, l in enumerate(lay)]).contiguous()
    table = torch.zeros((sum(level_rows), spec.row_width),
                        dtype=torch.bfloat16, device="cuda")
    g = torch.randn((n, spec.output_dim), device="cuda",
                    generator=gen).to(torch.bfloat16)
    if not args.hash4d:
        comp["k6_ms"] = cuda_ms(lambda: ek.fused_encode_bwd(
            xn, g, rows, table, scales, nbs, level_rows, spec.n_features), 10)
        # one more step, keeping the inputs of its encoder backward: K6, or
        # K2 on the interp route (one kernel body)
        name, tag = (("interp_bwd_fused", "k2") if args.interp
                     else ("fused_encode_bwd", "k6"))
        kern, seen = getattr(ek, name), {}

        def keep(*a):
            seen["args"] = a
            return kern(*a)

        setattr(ek, name, keep)
        try:
            trainer.run_step()
        finally:
            setattr(ek, name, kern)
        comp[f"{tag}_step_ms"] = cuda_ms(lambda: kern(*seen["args"]), 10)
    print(json.dumps({"components": comp}), flush=True)
    return 0


def _texel_components(trainer, gen, cuda_ms):
    """The tri-plane encoder's backward on one more step's own inputs
    (kept by wrapping _PlaneInterp.apply for that step), and the texel
    gradient's sum alone at that shape."""
    import torch
    from cednerf_torch.ops import scatter_kernels as sk
    from cednerf_torch.ops import triplane as tp

    interp, seen = tp._PlaneInterp.apply, {}

    def keep(*a):
        seen["args"] = a
        return interp(*a)

    tp._PlaneInterp.apply = keep
    try:
        trainer.run_step()
    finally:
        del tp._PlaneInterp.apply
    planes, idx, w2, dtype = seen["args"]
    n_rows, f = planes.shape
    flat = idx.reshape(-1)
    rows32 = flat.to(torch.int32)
    terms = torch.randn((flat.numel(), f), device="cuda", generator=gen)
    p = planes.detach().requires_grad_()
    w2 = w2.detach().requires_grad_()
    out = interp(p, idx, w2, dtype)
    cot = torch.randn(out.shape, device="cuda", generator=gen).to(out.dtype)

    def fwd_bwd():
        interp(p, idx, w2, dtype).backward(cot)

    return {
        "texel_entries": flat.numel(), "texel_rows": n_rows,
        "texel_cols": f, "samples": idx.shape[0],
        "plane_interp_fwd_bwd_ms": cuda_ms(fwd_bwd, 10),
        "texel_k3_ms": cuda_ms(
            lambda: sk.scatter_add_rows(rows32, terms, n_rows), 10),
        "texel_sort_ms": cuda_ms(lambda: sk.key_sort(rows32, n_rows), 10),
        "texel_torch_sort_ms": cuda_ms(
            lambda: torch.sort(rows32, stable=True), 10),
        "texel_index_add_ms": cuda_ms(lambda: torch.zeros(
            (n_rows, f), device="cuda").index_add_(0, flat, terms), 10)}


def chunk_main(args):
    """run_step against run_chunk at full width (the --chunk mode)."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_training: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch.profiler import ProfilerActivity, profile

    from cednerf_torch.datasets.procedural import BallCloudScene
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags, dnerf_config
    from cednerf_torch.engine.train import Trainer
    from cednerf_torch.ops.cuda_build import build_all
    from cednerf_torch.utils.bench import (TRAIN_FLAGS, card_name,
                                           device_time_by_kernel, sync_calls)

    card = card_name()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    cfg = dnerf_config()
    flags = ModelFlags(**TRAIN_FLAGS)
    k = args.steps_per_call

    def trainer(chunked):
        scene = BallCloudScene(seed=args.seed)
        return Trainer(build_field(cfg, flags, device="cuda", seed=args.seed),
                       cfg, flags, scene, seed=args.seed, device="cuda",
                       steps_per_call=k,
                       device_sampler=scene.device_sampler() if chunked
                       else None)

    runs = []
    for path in ("run_step", "run_chunk", "run_chunk", "run_step"):
        tr = trainer(path == "run_chunk")
        one = tr.run_chunk if path == "run_chunk" else tr.run_step
        per = k if path == "run_chunk" else 1
        calls = []                       # (first step, ms) per call
        while tr.step < args.steps:
            step0 = tr.step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = one()
            torch.cuda.synchronize()
            calls.append((step0, (time.perf_counter() - t0) * 1e3))
        # ms per step over k-step windows from a multiple of k, so that each
        # window holds one occupancy update for either path
        windows = {}
        for step0, ms in calls:
            if step0 >= cfg.occ_warmup_steps:
                windows.setdefault(step0 // k, []).append(ms)
        win = [sum(v) / k for v in windows.values() if len(v) == k // per]
        window = per if path == "run_chunk" else args.profile_steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(window // per):
                one()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        rows, dev_ms = device_time_by_kernel(prof)
        _, syncs = sync_calls(one)
        rec = {
            "path": path, "steps": tr.step,
            "ms_per_step_windows": win,
            "median_ms_per_step": float(np.median(win)),
            "median_ms_per_call_after_warmup": float(np.median(
                [ms for s0, ms in calls if s0 >= cfg.occ_warmup_steps])),
            "device_ms_per_step": dev_ms / window,
            "profiled_wall_ms_per_step": prof_ms / window,
            "kernel_launches_per_step": sum(r[1] for r in rows) / window,
            "syncs_per_step": len(syncs) / per,
            "lattice": tr.steady_march, "bucket": tr.bucket,
            "last": {x: m[x] for x in ("num_rays", "n_valid", "n_samples",
                                       "complete_frac", "psnr")}}
        runs.append(rec)
        print(json.dumps(rec), flush=True)
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"{path}_{len(runs)}_key_averages"
                               ".txt"), "w") as fh:
            fh.write(card + "\n")
            fh.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=60))
        del tr, one
        torch.cuda.empty_cache()
    print(json.dumps({"chunk_vs_step": {
        "card": card, "order": [r["path"] for r in runs],
        **{key: [r[key] for r in runs] for key in (
            "median_ms_per_step", "device_ms_per_step",
            "kernel_launches_per_step", "syncs_per_step", "lattice")}}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
