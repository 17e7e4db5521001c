"""Proposal-network training CLI of the port — the counterpart of the JAX
package's train_prop_real.py: the same flags (plus --device),
output lines and checkpoint contract, on CUDA unless --device cpu is given.

Usage:
  python -m cednerf_torch.train_prop_real --data_root <dir> --scene lego \\
      -te -ta -f
  python -m cednerf_torch.train_prop_real --scene lego --load_model \\
      --render_video -te -ta -f

Sampling is hierarchical proposal PDF-resampling (engine/train_prop.py)
in place of the occupancy grid: PropTrainer, 16 steps a call, on the
loader's device sampler (D-NeRF, HyperNeRF) or on stacked host batches
(DyNeRF's importance sampling); the family's PropConfig (--grad_clip and
--density_clamp -1 keep its defaults; the clamp applies to the radiance
field and the proposal fields). Then a checkpoint in --model_path (prop
checkpoint: field, proposal fields, optimizer, the eval-culling occupancy
grid, step, generator), PSNR and MS-SSIM over every test image with the
first one's rgb_test.png, depth_test.png and rgb_error.png, through
make_prop_eval_render_fn. `--load_model` loads --model_path ("loaded prop
checkpoint at step N") and goes on to --render_video without evaluating,
as the JAX CLI does. CEDNERF_CFG holds SceneConfig overrides as JSON. The
last line printed is one JSON object {"train_prop_real": {...}}: steps,
train time, the kernels' launch counts of training and evaluation, the
evaluation's means.
"""

import argparse
import dataclasses
import json
import pathlib
import time

import torch

from .datasets import DNERF_SYNTHETIC_SCENES, DYNERF_SCENES, HYPERNERF_SCENES
from .engine.cli import get_model_args
from .train_real import _evaluate, _prepare, _render_video
from .utils.bench import kernel_counts, reset_kernel_counts


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train a dynamic NeRF with proposal-network sampling "
                    "(cednerf_torch)")
    parser.add_argument(
        "--data_root", type=str,
        default=str(pathlib.Path.cwd() / "data/dnerf_synthetic"))
    parser.add_argument("--train_split", type=str, default="train",
                        choices=["train", "trainval"])
    parser.add_argument(
        "--scene", type=str, default="lego",
        choices=list(DNERF_SYNTHETIC_SCENES) + list(DYNERF_SCENES)
        + list(HYPERNERF_SCENES))
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--num_rays", type=int, default=8192,
                        help="fixed ray batch (the proposal path needs no "
                             "dynamic sample batching: shapes are dense)")
    parser.add_argument("--model_path", type=str, default="model_prop_ckpt",
                        help="checkpoint dir (saved at the end of training; "
                             "--load_model restores it)")
    parser.add_argument("--grad_clip", type=float, default=-1.0,
                        help="global-norm gradient clip for the joint "
                             "field+proposal optimizer (-1 = family "
                             "default; 0 = off)")
    parser.add_argument("--density_clamp", type=float, default=-1.0,
                        help="pre-activation cap on the density exp "
                             "(-1 = family default; 0 = off)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain "
                             "versions (tests)")
    parser.add_argument("--seed", type=int, default=42,
                        help="the nets' initial weights and every draw of "
                             "the training loop (the JAX CLI's fixed 42)")
    return get_model_args(parser)


def main(argv=None) -> dict:
    """Run the CLI on `argv` (sys.argv by default); returns the summary
    that the last printed line carries."""
    from .engine.checkpoint import load_prop_checkpoint, save_prop_checkpoint
    from .engine.train_prop import (PropConfig, PropTrainer,
                                    build_prop_networks,
                                    create_prop_train_state,
                                    make_prop_eval_render_fn)
    from .ops.occupancy import create_occ_grid

    args = build_parser().parse_args(argv)
    device, cfg, flags, field, (Loader, loader_kw), test_dataset = \
        _prepare(args)
    pcfg = PropConfig.for_family(cfg.family)
    if args.grad_clip >= 0:
        pcfg = dataclasses.replace(pcfg, grad_clip=args.grad_clip)
    clamp = (pcfg.density_clamp if args.density_clamp < 0
             else args.density_clamp)
    props = build_prop_networks(cfg, pcfg, device=device, seed=args.seed)
    if clamp > 0:
        for mod in (field,) + props:
            mod.density_clamp = clamp

    summary = {"scene": args.scene, "device": str(device),
               "prop_config": dataclasses.asdict(pcfg)}
    if args.load_model:
        # as the JAX CLI: load, then --render_video; no evaluation
        state = create_prop_train_state(field, props, cfg, pcfg,
                                        device=device)
        occ = create_occ_grid(cfg.aabb, cfg.grid_resolution, cfg.grid_nlvl,
                              device=device)
        state, occ, step, _ = load_prop_checkpoint(args.model_path, state,
                                                   occ)
        print(f"loaded prop checkpoint at step {step} from "
              f"{args.model_path}")
        summary["step"] = step
    else:
        train_dataset = Loader(subject_id=args.scene, root_fp=args.data_root,
                               split=args.train_split, num_rays=args.num_rays,
                               **loader_kw)
        sampler = (train_dataset.device_sampler(device)
                   if hasattr(train_dataset, "device_sampler") else None)
        trainer = PropTrainer(field, props, cfg, flags, pcfg, sampler,
                              n_rays=args.num_rays, seed=args.seed,
                              steps_per_call=16,
                              dataset=None if sampler else train_dataset,
                              device=device)
        summary["sampler"] = "device" if sampler else "stacked_host"

        def now():
            if device.type == "cuda":
                torch.cuda.synchronize()
            return time.time()

        reset_kernel_counts()
        tic = now()
        m = {"loss": 0.0, "psnr": 0.0, "n_samples": 0.0}
        while trainer.step < cfg.max_steps:
            m = trainer.run_chunk()
            if trainer.step % 10000 < trainer.steps_per_call:
                print(f"elapsed_time={time.time() - tic:.2f}s | "
                      f"step={trainer.step} | loss={m['loss']:.5f} | "
                      f"psnr={m['psnr']:.2f} | "
                      f"n_rendering_samples={int(m['n_samples'])} |")
        train_s = now() - tic
        print(f"train time: {train_s:.2f}s")
        launches, plain = kernel_counts()
        state, occ = trainer.state, trainer.occ
        save_prop_checkpoint(args.model_path, state, occ, trainer.step,
                             trainer.generator.get_state())
        print(f"saved {args.model_path}")
        summary.update(step=trainer.step, steps=trainer.step,
                       train_s=train_s,
                       ms_per_step=train_s * 1e3 / max(trainer.step, 1),
                       last_chunk=m, launches=launches,
                       plain_cuda_calls=plain)

    render_chunk = make_prop_eval_render_fn(state.field, state.props, cfg,
                                            pcfg)
    if not args.load_model:
        reset_kernel_counts()
        summary["eval"] = _evaluate(state.field, occ, render_chunk,
                                    cfg.eval_chunk, test_dataset)
        summary["eval"]["launches"], summary["eval"]["plain_cuda_calls"] = \
            kernel_counts()
    if args.render_video:
        summary["video"] = _render_video(state.field, occ, render_chunk,
                                         cfg.eval_chunk, test_dataset)
    print(json.dumps({"train_prop_real": summary}))
    return summary


if __name__ == "__main__":
    main()
