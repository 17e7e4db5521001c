"""One rank of the port's ray data parallelism on the CPU, for
tests/test_torch_parallel.py.

    python tests/torch_mesh_worker.py STORE RANK SIZE IN_DIR OUT_DIR CASE...

Joins a gloo group of SIZE ranks through a FileStore at STORE, makes the
mesh (cednerf_torch.parallel.make_mesh(device="cpu")), runs each CASE
(step, chunk, prop) and saves this rank's results to
OUT_DIR/CASE_RANK.pt. Each case is a function of (mesh, IN_DIR); called
with mesh=None it runs the one-process program the ranks must reproduce
(cfg.compact_blocks = 2 all the same), which the test runs in its own
process. Imports torch and cednerf_torch only.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from cednerf_torch.bridge import occ_from_numpy  # noqa: E402
from cednerf_torch.datasets.procedural import BallScene  # noqa: E402
from cednerf_torch.engine import train as tt  # noqa: E402
from cednerf_torch.engine import train_prop as tp  # noqa: E402
from cednerf_torch.engine.cli import build_field  # noqa: E402
from cednerf_torch.engine.config import ModelFlags, dnerf_config  # noqa: E402
from cednerf_torch.engine.renderer import (make_eval_render_fn,  # noqa: E402
                                           render_image)

FLAGS = dict(use_div_offsets=True, use_feat_predict=True,
             use_time_embedding=True, use_time_attenuation=True,
             distortion_loss=True, acc_entropy_loss=True)
SMALL = dict(target_sample_batch_size=4096, grid_resolution=16,
             render_step_size=2e-2, max_march_steps=128,
             hash_dst_resolution=128, log2_hashmap_size=14,
             max_table_rows=512, hash_n_levels=4, compact_blocks=2)
# the step case's inputs (written by the test): 128 rays, budget 4096
STEP_RAYS, STEP_BUDGET = 128, 4096
# the chunk case: a warmup chunk (all-cells occupancy updates), then a
# steady one (empty-space skipping), 4 steps each
CHUNK = dict(SMALL, occ_warmup_steps=4, occ_update_interval=2,
             eval_s_max=64, eval_chunk_seg=64)
PROP = dict(target_sample_batch_size=4096, grid_resolution=16,
            hash_dst_resolution=128, log2_hashmap_size=14,
            max_table_rows=512, hash_n_levels=4)
PROP_PCFG = dict(prop_resolutions=(64,), prop_samples=(32,), n_final=16,
                 anneal_steps=8)


def step_config(**kw):
    return dataclasses.replace(dnerf_config(), grad_accum_dtype="float32",
                               **SMALL, **kw)


def case_step(mesh, in_dir):
    """One step's loss and gradients from the test's weights, grid, batch
    and jitter (loss: this rank's part, the gradients summed)."""
    inp = torch.load(os.path.join(in_dir, "step_inputs.pt"),
                     weights_only=False)
    cfg = step_config()
    flags = ModelFlags(**FLAGS)
    field = build_field(cfg, flags, device="cpu")
    field.load_state_dict(inp["params"], strict=True)
    state = tt.create_train_state(field, cfg, device="cpu")
    state.occ = occ_from_numpy(inp["occs"], inp["bins"], inp["aabbs"],
                               device="cpu")
    loss_and_grads = tt._make_loss_fn(cfg, flags, STEP_BUDGET, mesh=mesh)
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    loss, aux = loss_and_grads(state, batch,
                               jitter=torch.from_numpy(inp["jitter"]))
    return {"loss": loss.item(), "n_valid": aux["n_valid"].item(),
            "grads": {n: p.grad.clone() for n, p in field.named_parameters()}}


def case_chunk(mesh, in_dir=None):
    """Two run_chunks of the scanned Trainer on BallScene's device sampler
    (compact_blocks 2), then one 16x16 frame through the seg renderer with
    the mesh and without it."""
    cfg = dataclasses.replace(dnerf_config(), **CHUNK)
    flags = ModelFlags(**FLAGS)
    scene = BallScene(n_cams=4, wh=16, n_times=4)
    tr = tt.Trainer(build_field(cfg, flags, device="cpu", seed=0), cfg,
                    flags, scene, seed=3, device="cpu",
                    device_sampler=scene.device_sampler("cpu"),
                    steps_per_call=4, mesh=mesh)
    chunks = [tr.run_chunk() for _ in range(2)]
    out = {"chunks": chunks, "log": tr.chunk_log, "step": tr.step,
           "bucket": tr.bucket, "steady": tr.steady_march,
           "params": {k: v.clone() for k, v in
                      tr.field.state_dict().items()},
           "occs": tr.state.occ.occs.clone(),
           "binaries": tr.state.occ.binaries.clone()}
    img = scene.image_rays(0, 0.5)
    fn = make_eval_render_fn(tr.field, cfg)
    args = (tr.field, tr.state.occ, fn, img["origins"], img["viewdirs"],
            0.5, np.ones(3, np.float32))
    out["frame"] = render_image(*args, chunk=64)
    if mesh is not None:
        out["frame_mesh"] = render_image(*args, chunk=64, mesh=mesh)
    return out


def case_prop(mesh, in_dir=None):
    """One PropTrainer chunk (2 steps at 64 rays) on BallScene's device
    sampler."""
    cfg = dataclasses.replace(dnerf_config(), **PROP)
    pcfg = tp.PropConfig(**PROP_PCFG)
    flags = ModelFlags(use_time_embedding=True, distortion_loss=True)
    field = build_field(cfg, flags, device="cpu", seed=0)
    props = tp.build_prop_networks(cfg, pcfg, device="cpu", seed=1)
    scene = BallScene(n_cams=4, wh=16, n_times=4)
    tr = tp.PropTrainer(field, props, cfg, flags, pcfg,
                        scene.device_sampler("cpu"), n_rays=64, seed=5,
                        steps_per_call=2, mesh=mesh, device="cpu")
    m = tr.run_chunk()
    return {"metrics": m,
            "params": [p.detach().clone() for p in tr.state.optimizer.params],
            "occs": tr.occ.occs.clone()}


CASES = {"step": case_step, "chunk": case_chunk, "prop": case_prop}


def main(argv):
    import torch.distributed as dist

    from cednerf_torch.parallel import make_mesh

    store_path, rank, size, in_dir, out_dir = argv[:5]
    rank, size = int(rank), int(size)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, size),
                            rank=rank, world_size=size)
    mesh = make_mesh(device="cpu")
    for case in argv[5:]:
        torch.save(CASES[case](mesh, in_dir),
                   os.path.join(out_dir, f"{case}_{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
