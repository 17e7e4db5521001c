"""Dataset-free quality validation on the procedural scenes — port of the
JAX package's tools/validate_synthetic.py.

    python -m cednerf_torch.tools.validate_synthetic [--steps 2000]
        [--levels 16] [--features 2] [--scene ball|cloud|texture|mono]
        [--impl brick|gather] [--grid_type hash3d|hash4d|triplane]
        [--row_layout brick|cell|cellz|cellfused] [--remat_feats]
        [--device cuda] [--out DIR] [...]

Trains the flagship field (the published flags -te -ta -f -ae -df -d) on
a procedural scene through Trainer.run_chunk (the scene's device sampler,
16 steps a chunk) and prints one JSON line with the same keys as the JAX
tool: the training PSNR of the last logged chunk, a train view rendered
through the eval path (camera 0 at a training time: an eval-renderer fault
shows here, undertraining does not) and a held-out view (a novel camera at
t = 0.43; for the monocular scene at the nearest training time, the vrig
protocol). --ttq_db adds the seconds to each PSNR threshold. --out writes
the rendered and ground-truth PNGs and result.json.

--scene texture is the textured cloud, the encoder gate of the JAX
rounds; --impl gather the exact per-corner encoder. The JAX tool's
--scatter_impl,
--interp_impl and --compact_impl pick among its TPU routes; the port takes
no such flag, runs the preset's kernels and reports the preset's values
under the same keys.
"""

import argparse
import dataclasses
import json
import pathlib
import time

import numpy as np

from ..datasets.procedural import (BallCloudScene, BallScene,
                                   MonocularOrbitScene, TexturedCloudScene)
from ..engine.cli import build_field
from ..engine.config import ModelFlags, dnerf_config
from ..engine.renderer import eval_chunk_for, make_eval_render_fn, render_image
from ..engine.train import Trainer
from ..utils.device import resolve_device
from ..utils.metrics import psnr


class TTQTracker:
    """Wall-clock seconds and step at which the per-chunk train PSNR first
    crosses each threshold (the JAX tools' tools/ttq.py)."""

    def __init__(self, thresholds_db):
        self.thresholds = sorted(float(t) for t in thresholds_db)
        self.hits = {}
        self._chunk_times = []
        self._t0 = self._t_last = time.perf_counter()

    def update(self, step: int, psnr_db: float):
        now = time.perf_counter()
        self._chunk_times.append(now - self._t_last)
        self._t_last = now
        for th in self.thresholds:
            if th not in self.hits and psnr_db >= th:
                self.hits[th] = (round(now - self._t0, 1), step)

    def result(self) -> dict:
        times = sorted(self._chunk_times)
        med = times[len(times) // 2] if times else 0.0
        first = self._chunk_times[0] if self._chunk_times else 0.0
        return {
            "ttq_s": {f"{th:g}": (list(self.hits[th]) if th in self.hits
                                  else None) for th in self.thresholds},
            "compile_s_estimate": round(max(first - med, 0.0), 1),
            "median_chunk_s": round(med, 3),
        }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--levels", type=int, default=16)
    ap.add_argument("--features", type=int, default=2)
    ap.add_argument("--scene", choices=("ball", "cloud", "texture", "mono"),
                    default="ball")
    ap.add_argument("--grid_type", choices=("hash3d", "hash4d", "triplane"),
                    default="hash3d")
    ap.add_argument("--impl", choices=("brick", "gather"), default="brick")
    ap.add_argument("--log2", type=int, default=0,
                    help="override log2_hashmap_size (e.g. 21 = reference)")
    ap.add_argument("--grad_accum", choices=("bfloat16", "float32"),
                    default=None, help="override encoder grad accumulator")
    ap.add_argument("--budget", type=int, default=0,
                    help="override target_sample_batch_size")
    ap.add_argument("--fine_from_level", type=int, default=0,
                    help="first level --fine_table_rows applies to "
                         "(0 = keep the preset default 5)")
    ap.add_argument("--fine_table_rows", type=int, default=0,
                    help="fine-level brick-table rows")
    ap.add_argument("--march_seg", type=int, default=-1,
                    help="override two-stage segment marching (0 = off)")
    ap.add_argument("--remat_feats", action="store_true")
    ap.add_argument("--row_layout", default=None,
                    choices=("brick", "cell", "cellz", "cellfused"))
    ap.add_argument("--ttq_db", default="",
                    help="comma-separated PSNR thresholds (e.g. '24,28,30')")
    ap.add_argument("--steady_march", type=int, default=0,
                    help="steady_march_steps (0 = full max_march_steps)")
    ap.add_argument("--mini", action="store_true",
                    help="small shapes (wh 64, budget 16k, march 256, table "
                         "rows 2048, log2 16): a quick run, not the gate")
    ap.add_argument("--eval_chunk", type=int, default=0,
                    help="override the eval chunk (rays)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    return ap


def _config(args):
    cfg = dnerf_config(max_steps=args.steps)
    if args.mini:
        # render_step_size scales with the march-step cut so rays still
        # cover the full aabb diagonal (3*sqrt(3) / 2e-2 ~= 260 steps)
        cfg = dataclasses.replace(
            cfg, target_sample_batch_size=16384, max_march_steps=256,
            render_step_size=2e-2, grid_resolution=64, max_table_rows=2048,
            log2_hashmap_size=16, occ_warmup_steps=64)
    upd = {"hash_n_levels": args.levels, "hash_n_features": args.features}
    for key, val in (("log2_hashmap_size", args.log2),
                     ("grad_accum_dtype", args.grad_accum),
                     ("target_sample_batch_size", args.budget),
                     ("fine_table_rows", args.fine_table_rows),
                     ("fine_from_level", args.fine_from_level),
                     ("steady_march_steps", args.steady_march),
                     ("row_layout", args.row_layout),
                     ("remat_feats", args.remat_feats)):
        if val:
            upd[key] = val
    if args.march_seg >= 0:
        upd["march_seg"] = args.march_seg
    if args.eval_chunk:
        upd["eval_chunk"] = upd["eval_chunk_seg"] = args.eval_chunk
    return dataclasses.replace(cfg, **upd)


def run(args) -> dict:
    dev = resolve_device(args.device)
    cfg = _config(args)
    flags = ModelFlags(
        use_div_offsets=True, use_feat_predict=True, use_time_embedding=True,
        use_time_attenuation=True, distortion_loss=True,
        acc_entropy_loss=True, grid_type=args.grid_type)
    field = build_field(cfg, flags, device=dev, seed=args.seed,
                        encoder_impl=args.impl)
    wh = 64 if args.mini else 128
    if args.scene == "mono":
        # the vrig capture regime: one camera per time (a 32-frame orbit)
        scene = MonocularOrbitScene(n_frames=32, wh=wh)
    else:
        scene = {"ball": BallScene, "cloud": BallCloudScene,
                 "texture": TexturedCloudScene}[args.scene](
            n_cams=8, wh=wh, n_times=8)
    trainer = Trainer(field, cfg, flags, scene, seed=args.seed, device=dev,
                      device_sampler=scene.device_sampler(dev),
                      steps_per_call=16)
    ttq = TTQTracker([float(t) for t in args.ttq_db.split(",") if t])
    t0 = time.perf_counter()
    history = []
    while trainer.step < args.steps:
        m = trainer.run_chunk()
        ttq.update(trainer.step, m["psnr"])
        if trainer.step % 256 < trainer.steps_per_call:
            history.append((trainer.step, m["psnr"]))
            print(f"step={trainer.step} psnr={m['psnr']:.2f} "
                  f"rays={m['num_rays']} nsamp={int(m['n_samples'])}",
                  flush=True)
    train_s = time.perf_counter() - t0

    fn = make_eval_render_fn(field, cfg)
    occ = trainer.state.occ
    bkgd = np.ones(3, np.float32)
    t_train = float(scene.times[3])
    tv = scene.image_rays(0, t_train)
    rgb_tv, _, _ = render_image(field, occ, fn, tv["origins"], tv["viewdirs"],
                                t_train, bkgd, chunk=eval_chunk_for(cfg))
    t_eval = 0.43
    if scene.monocular:
        t_eval = float(scene.times[np.argmin(np.abs(scene.times - t_eval))])
    gt, origins, viewdirs = scene.eval_view(theta=0.33 * np.pi, t=t_eval)
    rgb, _, _ = render_image(field, occ, fn, origins, viewdirs, t_eval, bkgd,
                             chunk=eval_chunk_for(cfg))
    result = {
        "steps": args.steps, "mini": args.mini, "levels": args.levels,
        "features": args.features, "scene": args.scene, "impl": args.impl,
        "log2": args.log2 or cfg.log2_hashmap_size,
        "grad_accum": cfg.grad_accum_dtype,
        "budget": cfg.target_sample_batch_size,
        "scatter_impl": cfg.scatter_impl, "interp_impl": cfg.interp_impl,
        "compact_impl": cfg.compact_impl,
        "fine_table_rows": cfg.fine_table_rows, "march_seg": cfg.march_seg,
        "train_seconds": round(train_s, 1),
        "final_train_psnr": round(history[-1][1], 2) if history else None,
        "train_view_psnr": round(psnr(rgb_tv, tv["pixels"]).item(), 2),
        "eval_psnr": round(psnr(rgb, gt).item(), 2),
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
        write_png(out / "train_view_rgb.png", rgb_tv)
        write_png(out / "train_view_gt.png", tv["pixels"])
        (out / "result.json").write_text(json.dumps(result, indent=2))
    return result


def main(argv=None):
    print(json.dumps(run(build_parser().parse_args(argv))))


if __name__ == "__main__":
    main()
