"""Proposal-path quality / time-to-quality validation on the procedural
scenes — port of the JAX package's tools/validate_prop.py.

    python -m cednerf_torch.tools.validate_prop [--steps 2000] [--rays 4096]
        [--scene ball|cloud|texture] [--ttq_db 24,28,30] [--host]
        [--debug] [--grad_clip G] [--weight_decay W] [--density_clamp C]
        [--anneal_steps N] [-o] [--steps_per_call K] [--device cuda]
        [--out DIR]

Trains the flagship field (-te -ta -f -ae -df -d, -o on request) with
proposal-network sampling on a procedural scene: PropTrainer on the
scene's device sampler, --steps_per_call steps a chunk (the loop
train_prop_real uses), or with --host one make_prop_train_step a step on
host batches. Then it renders a held-out view (a novel camera at t = 0.43)
through make_prop_eval_render_fn with the trainer's eval-culling grid and
without it, and a train view (camera 0 at a training time), and prints one
JSON line with the JAX tool's keys plus the device. --ttq_db adds the
seconds to each train-PSNR threshold (TTQTracker); --out writes the held-out
view's PNGs and result.json.
"""

import argparse
import dataclasses
import json
import pathlib
import time

import numpy as np
import torch

from ..datasets.procedural import BallCloudScene, BallScene, TexturedCloudScene
from ..engine.cli import build_field
from ..engine.config import ModelFlags, dnerf_config
from ..engine.renderer import render_image
from ..engine.train_prop import (PropConfig, PropTrainer, build_prop_networks,
                                 create_prop_train_state,
                                 make_prop_eval_render_fn,
                                 make_prop_train_step)
from ..utils.device import resolve_device
from ..utils.metrics import psnr
from .validate_synthetic import TTQTracker


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--rays", type=int, default=4096)
    ap.add_argument("--scene", choices=("ball", "cloud", "texture"),
                    default="ball")
    ap.add_argument("--ttq_db", default="",
                    help="comma-separated PSNR thresholds; records "
                         "wall-clock to first crossing")
    ap.add_argument("--host", action="store_true",
                    help="per-step host sampling (the pre-scan loop; for "
                         "dispatch-overhead A/Bs only)")
    ap.add_argument("--debug", action="store_true",
                    help="per-chunk NaN-source telemetry (sigma_max, "
                         "finite flags) for divergence diagnosis")
    ap.add_argument("--grad_clip", type=float, default=0.0,
                    help="global-norm gradient clip (0 = off)")
    ap.add_argument("--weight_decay", type=float, default=0.0,
                    help="L2 weight decay (0 = off)")
    ap.add_argument("--density_clamp", type=float, default=-1.0,
                    help="pre-activation clamp on the density exp "
                         "(-1 = PropConfig default 20; 0 = off)")
    ap.add_argument("--anneal_steps", type=int, default=0,
                    help="override the proposal anneal schedule (0 = keep "
                         "the 1000-step default)")
    ap.add_argument("-o", "--use_opacity_loss", action="store_true",
                    help="add the reference's opacity loss (-o)")
    ap.add_argument("--steps_per_call", type=int, default=16,
                    help="steps a chunk")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    ap.add_argument("--out", default="")
    return ap


def _train_host(field, props, cfg, flags, pcfg, scene, args, dev, ttq):
    """--host: one train step a call on the scene's host batches; (trained
    field, final train PSNR, steps)."""
    state = create_prop_train_state(field, props, cfg, pcfg, device=dev)
    step_fn = make_prop_train_step(field, props, cfg, flags, pcfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    m = {}
    for step in range(args.steps):
        batch = {k: torch.as_tensor(np.asarray(v), device=dev)
                 for k, v in scene.sample(args.rays).items()}
        state, m = step_fn(state, batch, step, generator=gen)
        if step % 16 == 15:
            mh = {k: float(v) for k, v in m.items()}
            ttq.update(step + 1, mh["psnr"])
            if step % 256 == 255:
                print(f"step={step + 1} psnr={mh['psnr']:.2f} "
                      f"loss={mh['loss']:.4f}", flush=True)
    return float(m["psnr"]), args.steps


def run(args) -> dict:
    dev = resolve_device(args.device)
    flags = ModelFlags(
        use_div_offsets=True, use_feat_predict=True, use_time_embedding=True,
        use_time_attenuation=True, distortion_loss=True,
        acc_entropy_loss=True, use_opacity_loss=args.use_opacity_loss)
    cfg = dnerf_config(max_steps=args.steps)
    field = build_field(cfg, flags, device=dev)
    pcfg = PropConfig.for_family("dnerf")
    pcfg = dataclasses.replace(
        pcfg, debug=args.debug, grad_clip=args.grad_clip,
        weight_decay=args.weight_decay,
        anneal_steps=args.anneal_steps or pcfg.anneal_steps)
    clamp = (pcfg.density_clamp if args.density_clamp < 0
             else args.density_clamp)
    props = build_prop_networks(cfg, pcfg, device=dev)
    if clamp > 0:
        for mod in (field,) + props:
            mod.density_clamp = clamp
    scene = {"ball": BallScene, "cloud": BallCloudScene,
             "texture": TexturedCloudScene}[args.scene](
        n_cams=8, wh=128, n_times=8)

    ttq = TTQTracker([float(t) for t in args.ttq_db.split(",") if t])
    t0 = time.perf_counter()
    first_chunk_s = None
    occ = None
    if args.host:
        final_train_psnr, steps_done = _train_host(
            field, props, cfg, flags, pcfg, scene, args, dev, ttq)
    else:
        trainer = PropTrainer(field, props, cfg, flags, pcfg,
                              scene.device_sampler(dev), n_rays=args.rays,
                              seed=0, steps_per_call=args.steps_per_call,
                              device=dev)
        m = {}
        while trainer.step < args.steps:
            m = trainer.run_chunk()
            if first_chunk_s is None:
                first_chunk_s = time.perf_counter() - t0
                print(f"# first chunk ({trainer.steps_per_call} steps) in "
                      f"{first_chunk_s:.1f}s", flush=True)
            ttq.update(trainer.step, m["psnr"])
            if args.debug or trainer.step % 256 < trainer.steps_per_call:
                extra = ""
                if args.debug:
                    extra = (f" smax={m['sigma_max']:.3g}"
                             f" wmax={m['w_max']:.3g}"
                             f" pwmax={m['prop_w_max']:.3g}"
                             f" tfin={m['t_finite']:.0f}"
                             f" gfin={m['grads_finite']:.0f}"
                             f" pfin={m['params_finite']:.0f}")
                print(f"step={trainer.step} psnr={m['psnr']:.2f} "
                      f"loss={m['loss']:.4f} "
                      f"nsamp={int(m['n_samples'])}" + extra, flush=True)
        final_train_psnr, steps_done = m["psnr"], trainer.step
        occ = trainer.occ
    train_s = time.perf_counter() - t0

    render_fn = make_prop_eval_render_fn(field, props, cfg, pcfg)
    white = np.ones(3, np.float32)
    gt, origins, viewdirs = scene.eval_view(theta=0.33 * np.pi, t=0.43)
    rgb, _, _ = render_image(field, occ, render_fn, origins, viewdirs, 0.43,
                             white)
    eval_psnr = eval_psnr_raw = psnr(rgb, gt).item()
    if occ is not None:
        # the un-culled frame (the fog-damage diagnostic)
        rgb_raw, _, _ = render_image(field, None, render_fn, origins,
                                     viewdirs, 0.43, white)
        eval_psnr_raw = psnr(rgb_raw, gt).item()
    # a train view through the same eval path: an eval-renderer fault shows
    # here, novel-view damage (floaters) does not
    t_train = float(scene.times[3])
    tv = scene.image_rays(0, t_train)
    rgb_tv, _, _ = render_image(field, occ, render_fn, tv["origins"],
                                tv["viewdirs"], t_train, white)
    result = {
        "steps": steps_done,
        "rays": args.rays,
        "scene": args.scene,
        "sampler": "prop",
        "loop": "host" if args.host else "scanned",
        "train_seconds": round(train_s, 1),
        "final_train_psnr": round(final_train_psnr, 2),
        "train_view_psnr": round(psnr(rgb_tv, tv["pixels"]).item(), 2),
        "eval_psnr": round(eval_psnr, 2),
        "eval_psnr_raw": round(eval_psnr_raw, 2),
        "steps_per_call": args.steps_per_call,
        "first_chunk_s": round(first_chunk_s or 0.0, 1),
        "device": str(dev),
    }
    if ttq.thresholds:
        result.update(ttq.result())
    if args.out:
        from ..utils.image import write_png

        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        write_png(out / "eval_rgb.png", rgb)
        write_png(out / "eval_gt.png", gt)
        (out / "result.json").write_text(json.dumps(result, indent=2))
    return result


def main(argv=None):
    print(json.dumps(run(build_parser().parse_args(argv))))


if __name__ == "__main__":
    main()
