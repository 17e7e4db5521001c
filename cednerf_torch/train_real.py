"""Occupancy-grid training CLI of the port — the counterpart of the JAX
package's train_real.py: the same flags (plus --device), artifacts and
checkpoint contract, on CUDA unless --device cpu is given.

Usage:
  python -m cednerf_torch.train_real --data_root <dir> --scene lego \\
      -te -ta -f -ae -df -d
  python -m cednerf_torch.train_real --scene lego --load_model --render_video

Per family: the D-NeRF and HyperNeRF loaders put their image stacks on the
device and train through the scanned path (Trainer.run -> run_chunk with
the loader's device sampler); DyNeRF samples on the host (the native C++
importance sampler) and runs the same path on stacked host batches. Then a
final checkpoint in --model_path, PSNR and MS-SSIM over every test image,
and rgb_test.png, depth_test.png and rgb_error.png of the first test image
in the working directory. `--load_model` loads --model_path and goes on to
--render_video / --gui without evaluating, as the JAX CLI does;
`evaluate_checkpoint(argv)` evaluates a checkpoint in the calling process
through the train branch's evaluation (the reload checks); `--render_video`
renders the loader's render path into rgb_render / depth_render (mp4, or
per-frame PNGs without an mp4 writer); `--gui` serves the viewer on port
8890. The environment variable CEDNERF_CFG holds SceneConfig overrides as
JSON (tiny shapes for tests). The last line printed is one JSON object
{"train_real": {...}}: steps, train time, the kernels' launch counts of
the training run and of the evaluation, the evaluation's means and the
run's per-chunk log (`chunks`: Trainer.chunk_log).

--dp trains with ray-sharded data parallelism (parallel/mesh.py) over the
ranks of `python -m torch.distributed.run --nproc_per_node N -m
cednerf_torch.train_real --dp ...` (NCCL, one card a rank), or alone over
a one-rank group: cfg.compact_blocks = the mesh size, the evaluation
renders each chunk's rows across the ranks, and only rank 0 writes the
checkpoints, the PNGs and the summary line.
"""

import argparse
import dataclasses
import json
import os
import pathlib
import time

import numpy as np
import torch

from .datasets import DNERF_SYNTHETIC_SCENES, DYNERF_SCENES, HYPERNERF_SCENES
from .engine.cli import (apply_perf_overrides, build_field, flags_from_args,
                         get_model_args)
from .engine.config import config_for_scene
from .utils.bench import kernel_counts, reset_kernel_counts
from .utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train and evaluate a dynamic NeRF (cednerf_torch)")
    parser.add_argument(
        "--data_root", type=str,
        default=str(pathlib.Path.cwd() / "data/dnerf_synthetic"),
        help="the root dir of the dataset",
    )
    parser.add_argument("--train_split", type=str, default="train",
                        choices=["train", "trainval"])
    parser.add_argument(
        "--scene", type=str, default="lego",
        choices=list(DNERF_SYNTHETIC_SCENES) + list(DYNERF_SCENES)
        + list(HYPERNERF_SCENES)
        + ["procedural", "procedural_cloud"],  # dataset-free analytic scenes
    )
    parser.add_argument("--max_steps", type=int, default=None,
                        help="override the preset step count")
    parser.add_argument("--model_path", type=str, default="model_ckpt",
                        help="checkpoint directory (reference: model.pth)")
    parser.add_argument("--gui", action="store_true",
                        help="launch the interactive viewer after training")
    parser.add_argument("--resume", action="store_true",
                        help="resume mid-run from --model_path (step, "
                             "generator state and ray bucket restored)")
    parser.add_argument("--ckpt_every", type=int, default=10000,
                        help="rolling-checkpoint interval in steps (0 = only "
                             "the final save, the reference's behavior)")
    parser.add_argument("--isg2ist_step", type=int, default=0,
                        help="DyNeRF: switch ISG->IST importance sampling at "
                             "this step (reference dnerf_3d_video_IS.py:308 "
                             "switch_to_ist; 0 = never)")
    parser.add_argument("--dp", action="store_true",
                        help="ray-sharded data parallelism over the ranks of "
                             "torch.distributed.run (one card each; alone: "
                             "one rank); gradients summed over the ranks")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="trace 64 steady-state steps with "
                             "torch.profiler into this directory "
                             "(trace.json, a Chrome trace)")
    parser.add_argument("--mark_invisible", action="store_true",
                        help="mark occupancy cells outside all train frustums "
                             "invisible (always on for DyNeRF --gui runs, "
                             "reference train_real.py:205-211)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain "
                             "versions (tests)")
    return get_model_args(parser)


class _Trace:
    """torch.profiler over a window of steps, exported as a Chrome trace
    (out_dir/trace.json) when the window closes."""

    def __init__(self, out_dir: str, device: torch.device):
        self.out_dir = out_dir
        self.acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            self.acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = None

    def start(self):
        self.prof = torch.profiler.profile(activities=self.acts)
        self.prof.start()

    def stop(self):
        if self.prof is not None:
            self.prof.stop()
            os.makedirs(self.out_dir, exist_ok=True)
            self.prof.export_chrome_trace(
                os.path.join(self.out_dir, "trace.json"))
            self.prof = None


def _loader(scene: str, cfg, device):
    """(Loader class, train kwargs, test kwargs) of a scene's family."""
    if scene.startswith("procedural"):
        from .datasets.procedural import ProceduralLoader as Loader
        kw = {}
    elif scene in DNERF_SYNTHETIC_SCENES:
        from .datasets.dnerf_synthetic import DNeRFSyntheticDataset as Loader
        kw = {}
    elif scene in HYPERNERF_SCENES:
        from .datasets.hypernerf import HyperNeRFDataset as Loader
        kw = dict(color_bkgd_aug="black", factor=cfg.dataset_factor,
                  add_cam=cfg.add_cam)
    else:
        from .datasets.dynerf import DyNeRFDataset as Loader
        kw = dict(factor=cfg.dataset_factor, device=device)
    test_kw = dict(kw)
    if scene in DYNERF_SCENES:
        kw["color_bkgd_aug"] = cfg.train_bkgd_aug
        test_kw["color_bkgd_aug"] = cfg.test_bkgd_aug
    return Loader, kw, test_kw


def _evaluate(field, occ, render_chunk, chunk: int, test_dataset,
              mesh=None) -> dict:
    """PSNR and MS-SSIM over every test image (train_real.py:443-520)
    rendered by render_image through `render_chunk` in chunks of `chunk`
    rays (each chunk's rows across the ranks of `mesh`, if given), the
    first image's rgb / depth / error PNGs written to the working
    directory (by rank 0)."""
    from .engine.renderer import render_image
    from .utils.image import write_png
    from .utils.metrics import depth_to_img, ms_ssim, psnr

    psnrs, ssims, finite = [], [], True
    for i in range(len(test_dataset)):
        data = test_dataset.image_rays(i)
        rgb, _, depth = render_image(
            field, occ, render_chunk, data["origins"], data["viewdirs"],
            float(data["timestamp"]), data["color_bkgd"], chunk=chunk,
            mesh=mesh)
        finite &= bool(np.isfinite(rgb).all() and np.isfinite(depth).all())
        psnrs.append(psnr(rgb, data["pixels"]).item())
        ssims.append(ms_ssim(rgb, data["pixels"]).item())
        if i == 0 and (mesh is None or mesh.rank == 0):
            write_png("rgb_test.png", rgb)
            write_png("depth_test.png", depth_to_img(depth))
            err = np.linalg.norm(rgb - data["pixels"], axis=-1)
            write_png("rgb_error.png",
                      (np.clip(err, 0, 1) * 255).astype(np.uint8))
    print(f"evaluation: psnr_avg={np.mean(psnrs)}, ssim_avg={np.mean(ssims)}")
    return {"psnr_avg": float(np.mean(psnrs)),
            "ssim_avg": float(np.mean(ssims)), "psnrs": psnrs,
            "n_test": len(psnrs), "finite": finite}


def _render_video(field, occ, render_chunk, chunk: int,
                  test_dataset) -> dict:
    """The loader's render path (train_real.py:523-558) through
    `render_chunk` on a black background, frames flipped left-right as the
    reference writes them."""
    from .engine.renderer import render_image
    from .utils.image import write_video
    from .utils.metrics import depth_to_img

    poses = test_dataset.render_poses()
    bkgd = np.zeros(3, np.float32)
    rgb_frames, depth_frames = [], []
    for i in range(len(poses["c2w"])):
        data = test_dataset.pose_rays(poses, i)
        rgb, _, depth = render_image(
            field, occ, render_chunk, data["origins"], data["viewdirs"],
            float(data["timestamp"]), bkgd, chunk=chunk)
        rgb_frames.append(np.flip((rgb * 255).astype(np.uint8), axis=1))
        depth_frames.append(np.flip(depth_to_img(depth), axis=1))
    mp4 = write_video("rgb_render.mp4", rgb_frames, fps=20)
    write_video("depth_render.mp4", depth_frames, fps=20)
    return {"frames": len(rgb_frames), "mp4": mp4}


def _eval_renderer(field, cfg):
    """(chunk renderer, rays a chunk) of the occupancy-grid evaluation."""
    from .engine.renderer import eval_chunk_for, make_eval_render_fn

    return make_eval_render_fn(field, cfg), eval_chunk_for(cfg)


def _prepare(args, device=None):
    """(device, cfg, flags, field, (Loader, train kwargs), test dataset) of
    a parsed command line (on `device` if given, else --device); stops at
    once when --render_video is asked of a loader without a render path."""
    device = resolve_device(device or args.device)
    cfg = config_for_scene(args.scene, args.max_steps)
    if args.hash_levels or args.hash_features:
        cfg = dataclasses.replace(
            cfg,
            hash_n_levels=args.hash_levels or cfg.hash_n_levels,
            hash_n_features=args.hash_features or cfg.hash_n_features,
        )
    cfg = apply_perf_overrides(cfg, args)
    env_cfg = os.environ.get("CEDNERF_CFG")
    if env_cfg:
        # SceneConfig field overrides for tests and experiments (tiny-shape
        # end-to-end runs); an unknown key fails
        cfg = dataclasses.replace(cfg, **json.loads(env_cfg))
        print(f"cfg overrides from CEDNERF_CFG: {env_cfg}")
    flags = flags_from_args(args)
    field = build_field(cfg, flags, device=device, seed=42)
    Loader, loader_kw, test_kw = _loader(args.scene, cfg, device)
    test_dataset = Loader(subject_id=args.scene, root_fp=args.data_root,
                          split="test", num_rays=None, **test_kw)
    if args.render_video and not hasattr(test_dataset, "render_poses"):
        # before any training: the video needs the loader's render path
        raise SystemExit(
            f"--render_video: the {type(test_dataset).__name__} loader of "
            f"--scene {args.scene} has no render path (render_poses); run "
            "without --render_video")
    return device, cfg, flags, field, (Loader, loader_kw), test_dataset


def _load(args, cfg, field, device):
    """The train state of --model_path (the --load_model path): (state,
    step)."""
    from .engine.checkpoint import load_checkpoint
    from .engine.train import create_train_state

    state = create_train_state(field, cfg, device=device)
    state, step = load_checkpoint(args.model_path, state)
    print(f"loaded checkpoint at step {step} from {args.model_path}")
    return state, step


def evaluate_checkpoint(argv) -> dict:
    """Load --model_path of the command line `argv` as --load_model does
    and evaluate it in this process with the train branch's evaluation
    (PSNR and MS-SSIM over every test image, the three PNGs): the check
    that a reload reproduces the trained run's metrics."""
    args = build_parser().parse_args(argv)
    device, cfg, _, field, _, test_dataset = _prepare(args)
    state, step = _load(args, cfg, field, device)
    reset_kernel_counts()
    out = _evaluate(state.field, state.occ, *_eval_renderer(state.field, cfg),
                    test_dataset)
    out["step"] = step
    out["launches"], out["plain_cuda_calls"] = kernel_counts()
    return out


def main(argv=None) -> dict:
    """Run the CLI on `argv` (sys.argv by default); returns the summary
    that the last printed line carries."""
    args = build_parser().parse_args(argv)
    mesh, own_group = None, False
    if args.dp and not args.load_model:
        import torch.distributed as dist

        from .parallel import make_mesh

        own_group = not dist.is_initialized()
        mesh = make_mesh(device=args.device)
    device, cfg, flags, field, (Loader, loader_kw), test_dataset = \
        _prepare(args, mesh.device if mesh else None)
    from .engine.train import Trainer

    lead = mesh is None or mesh.rank == 0
    summary = {"scene": args.scene, "device": str(device)}
    train_dataset = None
    if args.load_model:
        # as the JAX CLI: load, then --render_video / --gui; no evaluation
        state, summary["step"] = _load(args, cfg, field, device)
    else:
        tic = time.time()
        train_dataset = Loader(subject_id=args.scene, root_fp=args.data_root,
                               split=args.train_split,
                               num_rays=cfg.init_batch_size, **loader_kw)
        load = {"loader": time.time() - tic}
        # loaders whose data fit the card sample inside the scanned loop;
        # the others (DyNeRF's importance sampling) run the same loop on
        # stacked host batches, assembled while the card runs
        device_sampler = (train_dataset.device_sampler(device)
                          if hasattr(train_dataset, "device_sampler")
                          else None)
        load["device_data"] = time.time() - tic - load["loader"]
        if mesh is not None:
            # shard-local budget compaction (one block per rank)
            cfg = dataclasses.replace(cfg, compact_blocks=mesh.size)
            print(f"data parallel over {mesh.size} device(s)")
            summary["dp"] = mesh.size
        trainer = Trainer(field, cfg, flags, train_dataset, seed=42,
                          device=device, device_sampler=device_sampler,
                          stacked_host=device_sampler is None, mesh=mesh)
        load["trainer"] = time.time() - tic - sum(load.values())
        summary["load_s"] = load
        summary["sampler"] = "device" if device_sampler else "stacked_host"

        if args.scene in DYNERF_SCENES and (args.gui or args.mark_invisible):
            # frustum-cull the occupancy grid (reference train_real.py:205-211)
            from .ops.occupancy import mark_invisible_cells

            cam_poses = train_dataset.poses[::train_dataset.images_per_video]
            trainer.state.occ = mark_invisible_cells(
                trainer.state.occ, train_dataset.K, cam_poses,
                train_dataset.width, train_dataset.height,
                near_plane=cfg.near_plane)

        hooks = []
        if args.isg2ist_step and hasattr(train_dataset, "switch_to_ist"):
            hooks.append((args.isg2ist_step, train_dataset.switch_to_ist))
        trace = None
        if args.profile_dir:
            # a steady-state window (past warmup and bucket settling)
            trace = _Trace(args.profile_dir, device)
            t0 = cfg.occ_warmup_steps + 512
            hooks += [(t0, trace.start), (t0 + 64, trace.stop)]

        if args.resume:
            print(f"resumed at step {trainer.resume(args.model_path)}")
        step0 = trainer.step

        def now():
            if device.type == "cuda":
                torch.cuda.synchronize()
            return time.time()

        # the clock at the end of the occupancy warmup: train time splits
        # into warmup and steady steps
        steady = {}
        hooks.append((cfg.occ_warmup_steps,
                      lambda: steady.update(t=now(), step=trainer.step)))
        reset_kernel_counts()
        tic = now()
        trainer.run(cfg.max_steps, log_every=10000, hooks=hooks,
                    checkpoint_dir=args.model_path,
                    checkpoint_every=args.ckpt_every)
        toc = now()
        train_s = toc - tic
        if trainer.step > steady.get("step", trainer.step):
            summary["warmup_s"] = steady["t"] - tic
            summary["steady_ms_per_step"] = (
                (toc - steady["t"]) * 1e3 / (trainer.step - steady["step"]))
        if trace is not None:
            trace.stop()
        launches, plain = kernel_counts()
        state = trainer.state
        trainer.save(args.model_path)
        print(f"train time: {train_s:.2f}s; saved {args.model_path}")
        steps = trainer.step - step0
        summary.update(step=trainer.step, steps=steps, train_s=train_s,
                       steps_per_s=steps / train_s if train_s else None,
                       launches=launches, plain_cuda_calls=plain,
                       chunks=trainer.chunk_log)

        reset_kernel_counts()
        summary["eval"] = _evaluate(state.field, state.occ,
                                    *_eval_renderer(state.field, cfg),
                                    test_dataset, mesh=mesh)
        summary["eval"]["launches"], summary["eval"]["plain_cuda_calls"] = \
            kernel_counts()

    if own_group:
        dist.destroy_process_group()
    if not lead:
        return summary

    if args.render_video:
        summary["video"] = _render_video(state.field, state.occ,
                                         *_eval_renderer(state.field, cfg),
                                         test_dataset)

    print(json.dumps({"train_real": summary}))

    if args.gui:
        # web orbit viewer with a time scrubber (reference gui.py parity)
        from .viewer.server import ViewerServer

        train_poses = (np.asarray(train_dataset.camtoworlds)
                       if train_dataset is not None
                       and hasattr(train_dataset, "camtoworlds") else None)
        server = ViewerServer(
            state.field, state.occ, cfg, train_poses=train_poses,
            K=getattr(test_dataset, "K", None),
            wh=(test_dataset.width, test_dataset.height),
            render_bkgd=(np.ones(3, np.float32) if cfg.family == "dnerf"
                         else np.zeros(3, np.float32)))
        server.serve(port=8890)
    return summary


if __name__ == "__main__":
    main()
