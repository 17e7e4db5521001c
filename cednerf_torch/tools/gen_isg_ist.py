"""Precompute ISG/IST importance-sampling weight maps for a DyNeRF scene —
port of the JAX package's tools/gen_isg_ist.py (the reference's
gen_isg_ist.ipynb notebook): the same flags and output files.

ISG weights are psi(diff^2 / (diff^2 + gamma^2)) against per-camera median
images (gamma 2e-2, or 1e-3 for keyframe runs), normalized to a
distribution; IST weights are max |frame - frame+-s| over shifts s <= 25
clamped at 0.1. Saved as {isg,ist}_weights.npy next to the scene data
(shape [n_cams * n_frames, h, w], float32, normalized).

    python -m cednerf_torch.tools.gen_isg_ist --data_root data/dynerf \\
        --scene flame_salmon_1 [--factor 4] [--gamma 2e-2] [--what both]

The weights come from the port's C++ (datasets/native.py, streamed per
pixel) where it builds, else from the numpy versions in datasets/dynerf.py,
as the JAX tool falls back; on a machine with a CUDA card a failed C++
build raises instead, as the port's DyNeRF loader does there.
"""

import argparse
import os

import numpy as np
import torch

from ..datasets import native
from ..datasets.dynerf import isg_weights, ist_weights, load_dynerf_scene


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_root", required=True)
    p.add_argument("--scene", required=True)
    p.add_argument("--factor", type=int, default=4)
    p.add_argument("--gamma", type=float, default=2e-2)
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--frame_shift", type=int, default=25)
    p.add_argument("--what", choices=["isg", "ist", "both"], default="both")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    data = load_dynerf_scene(args.data_root, args.scene, factor=args.factor,
                             split="train")
    imgs = data["images"]
    n_cams = data["n_cameras"]
    n_frames = data["n_frames_per_cam"]
    h, w = imgs.shape[1:3]
    basedir = os.path.join(
        args.data_root,
        "flame_salmon_1" if "flame_salmon" in args.scene else args.scene,
    )
    use_native = native.available(required=torch.cuda.is_available())

    if args.what in ("isg", "both"):
        if use_native and n_frames <= 4096:
            med = native.native_median_images(imgs, n_cams)
        else:
            med = np.median(
                imgs.reshape(n_cams, n_frames, h, w, 3), axis=1
            ).astype(np.uint8)
        wts = (native.native_isg_weights(imgs, med, gamma=args.gamma)
               if use_native else
               isg_weights(imgs, med, gamma=args.gamma).astype(np.float32))
        wts = wts / wts.sum()
        out = os.path.join(basedir, "isg_weights.npy")
        np.save(out, wts.reshape(-1, h, w))
        print(f"wrote {out} shape={wts.shape}")

    if args.what in ("ist", "both"):
        wts = (native.native_ist_weights(imgs, n_cams, alpha=args.alpha,
                                         frame_shift=args.frame_shift)
               if use_native else
               ist_weights(imgs, n_cams, alpha=args.alpha,
                           frame_shift=args.frame_shift).astype(np.float32))
        wts = wts / wts.sum()
        out = os.path.join(basedir, "ist_weights.npy")
        np.save(out, wts.reshape(-1, h, w))
        print(f"wrote {out} shape={wts.shape}")


if __name__ == "__main__":
    main()
