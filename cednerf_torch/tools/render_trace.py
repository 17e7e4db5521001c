"""Op-by-op trace of one evaluation frame, to find where two renders of
the same checkpoint part.

    python -m cednerf_torch.tools.render_trace --ckpt DIR --out A.pt \\
        [--train_steps N]        # train N steps first and save DIR
    python -m cednerf_torch.tools.render_trace --compare A.pt B.pt

Renders one held-out view (BallCloudScene, eval_view) of the full-width
D-NeRF field (dnerf_config, -te -ta -f -ae -df -d) through
train_real's evaluation renderer (make_eval_render_fn + render_image)
twice, under a TorchDispatchMode that records every ATen op's name, output
shapes and a digest of its outputs' bits (the integer sum of the bits of
each output, so any changed bit changes it). Left out: the allocation ops,
whose contents are undefined, and the view ops, whose outputs are bits an
earlier op wrote (or undefined ones, for a view of a fresh allocation).
The port's CUDA kernels run outside ATen; their outputs enter the trace at
the first op that reads them. With --train_steps the process trains the
field that far (the scanned path on the scene's device sampler), saves DIR
and then renders, as `train_real` trains, saves and evaluates; without it,
it loads DIR, as `--load_model` does. It prints one JSON line: the two renders' PSNR and
the first op at which they part. --compare prints the same for the first
render of two files, which two processes wrote.
"""

import argparse
import json
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# ops whose outputs hold no defined values
_ALLOC = ("aten.empty", "aten.empty_like", "aten.empty_strided",
          "aten.new_empty", "aten.new_empty_strided")
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _digest(t: torch.Tensor) -> torch.Tensor:
    """int64 sum of the tensor's bits (bool as 0/1), on its device."""
    if t.dtype == torch.bool:
        return t.sum(dtype=torch.int64)
    if t.is_complex():
        t = torch.view_as_real(t)
    bits = t.contiguous().view(_BITS[t.element_size()])
    return bits.to(torch.int64).sum()


class OpTrace(TorchDispatchMode):
    """Records (op name, output shapes) and the outputs' digests of every
    ATen op run under it."""

    def __init__(self):
        super().__init__()
        self.ops, self.digests = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        if not (func.is_view or name.startswith(_ALLOC)):
            ts = [t for t in tree_flatten(out)[0]
                  if isinstance(t, torch.Tensor) and t.numel()]
            if ts:
                self.ops.append((name, [tuple(t.shape) for t in ts]))
                self.digests.append(torch.stack([_digest(t) for t in ts]))
        return out

    def result(self):
        return {"ops": self.ops,
                "digests": [d.cpu().tolist() for d in self.digests]}


def first_difference(a: dict, b: dict) -> dict:
    """Where two traces part: the first op whose name, shapes or digest
    differ, with the ops just before it, and how many ops differ."""
    n = min(len(a["ops"]), len(b["ops"]))
    diff = [i for i in range(n)
            if a["ops"][i] != b["ops"][i]
            or a["digests"][i] != b["digests"][i]]
    out = {"ops": [len(a["ops"]), len(b["ops"])], "n_differ": len(diff)}
    if diff:
        i = diff[0]
        out.update(first=i, op=a["ops"][i], op_b=b["ops"][i],
                   before=[a["ops"][j][0] for j in range(max(0, i - 6), i)])
    return out


def _build(cfg, flags, device, seed):
    from ..engine.cli import build_field
    return build_field(cfg, flags, device=device, seed=seed)


def run(args) -> dict:
    from ..datasets.procedural import BallCloudScene
    from ..engine.checkpoint import load_checkpoint
    from ..engine.config import ModelFlags, dnerf_config
    from ..engine.renderer import (eval_chunk_for, make_eval_render_fn,
                                   render_image)
    from ..engine.train import Trainer, create_train_state
    from ..utils.bench import TRAIN_FLAGS
    from ..utils.device import resolve_device
    from ..utils.metrics import psnr

    dev = resolve_device(args.device)
    cfg = dnerf_config(max_steps=max(args.train_steps, 1))
    flags = ModelFlags(**TRAIN_FLAGS)
    scene = BallCloudScene(seed=args.seed)
    field = _build(cfg, flags, dev, args.seed)
    if args.train_steps:
        trainer = Trainer(field, cfg, flags, scene, seed=args.seed,
                          device=dev, device_sampler=scene.device_sampler(dev),
                          steps_per_call=16)
        trainer.run(args.train_steps, log_every=0)
        trainer.save(args.ckpt)
        state = trainer.state
    else:
        state = create_train_state(field, cfg, device=dev)
        state, _ = load_checkpoint(args.ckpt, state)
    gt, origins, viewdirs = scene.eval_view(theta=0.33 * np.pi, t=0.43)
    fn = make_eval_render_fn(state.field, cfg)
    renders = []
    for _ in range(2):
        tracer = OpTrace()
        t0 = time.perf_counter()
        with tracer:
            rgb, _, _ = render_image(state.field, state.occ, fn, origins,
                                     viewdirs, 0.43, np.ones(3, np.float32),
                                     chunk=eval_chunk_for(cfg))
        renders.append({**tracer.result(), "psnr": psnr(rgb, gt).item(),
                        "s": time.perf_counter() - t0})
    torch.save(renders, args.out)
    return {"psnr": [r["psnr"] for r in renders],
            "in_process": first_difference(renders[0], renders[1])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--out", default="render_trace.pt")
    ap.add_argument("--train_steps", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare", nargs=2, default=None)
    args = ap.parse_args(argv)
    if args.compare:
        a, b = (torch.load(p, weights_only=False)[0] for p in args.compare)
        res = {"psnr": [a["psnr"], b["psnr"]],
               "psnr_diff_db": b["psnr"] - a["psnr"],
               "across_files": first_difference(a, b)}
    else:
        res = run(args)
    print(json.dumps({"render_trace": res}))
    return res


if __name__ == "__main__":
    main()
