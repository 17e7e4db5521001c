"""The real-data slice as a whole: `python -m cednerf_torch.train_real`
(its main(), in process, --device cpu) on on-disk D-NeRF, HyperNeRF and
DyNeRF scenes in the real file formats, painted with a ball along each
loader's own rays (tests/test_e2e_disk.py's painters), at a tiny
CEDNERF_CFG. Per family: train (its eval PSNR, the three PNGs and the
checkpoint), --resume from the saved step (training on raises the eval
PSNR by more than 1 dB), --load_model (loads without evaluating, as the
JAX CLI; `train_real.evaluate_checkpoint`, the train branch's evaluation
of the loaded checkpoint in this process, gives the same PSNR within 1e-4
dB). tests/test_torch_jax_checkpoint.py renders a checkpoint
of the JAX package's Trainer through the same entry point.
"""

import json
import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from cednerf_torch import train_real
from cednerf_torch.utils.image import read_png
from test_datasets import (make_dnerf_fixture, make_dynerf_fixture,
                           make_hypernerf_fixture)
from test_e2e_disk import _ball_gt, _focus_point

FLAGS = ["-te", "-ta", "-f", "-ae", "-df", "-d"]
# SceneConfig overrides (CEDNERF_CFG): tiny batches, lattice and grid, and a
# 4-level 128-resolution encoder with small tables
TINY = {"target_sample_batch_size": 4096, "init_batch_size": 64,
        "grid_resolution": 16, "max_march_steps": 128,
        "render_step_size": 2e-2, "occ_warmup_steps": 8,
        "occ_update_interval": 4, "eval_s_max": 64, "eval_chunk": 256,
        "eval_chunk_seg": 256, "hash_dst_resolution": 128,
        "log2_hashmap_size": 14, "max_table_rows": 512, "hash_n_levels": 4}
PSNR_RELOAD_DB = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Hundreds of small CPU ops: with torch's default of one thread per
    core in each of the suite's worker processes the threads oversubscribe
    the cores (as in tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _paint(loader_cls, root, scene, kw, path_of, radius_frac=None,
           radius=0.5, bkgd=(1.0, 1.0, 1.0)):
    """Paint the train and test images of an on-disk scene with a ball at
    the train cameras' focus, along each image's loader rays, on the
    family's background (test_e2e_disk's ball; D-NeRF frames as RGBA).
    Returns the ball's (center, radius)."""
    train = loader_cls(scene, root, "train", num_rays=64, **kw)
    center = _focus_point(train, range(len(train)))
    if radius_frac is not None:
        o0 = np.asarray(train.image_rays(0)["origins"]).reshape(-1, 3)[0]
        radius = radius_frac * float(np.linalg.norm(center - o0))
    for split, ds in (("train", train),
                      ("test", loader_cls(scene, root, "test", **kw))):
        for i in range(len(ds)):
            rays = ds.image_rays(i)
            o = np.asarray(rays["origins"]).reshape(-1, 3)
            rgb = _ball_gt(o, np.asarray(rays["viewdirs"]).reshape(-1, 3),
                           float(rays["timestamp"]), center, radius)
            hit = np.any(rgb != 1.0, axis=-1)
            assert hit.mean() > 0.02, (split, i, hit.mean())
            rgb[~hit] = bkgd
            img = (rgb.reshape(ds.height, ds.width, 3) * 255).astype(np.uint8)
            if scene == "lego":
                img = np.concatenate([img, np.full_like(img[..., :1], 255)],
                                     axis=-1)
            imageio.imwrite(path_of(split, i), img)
    return center, radius


def _box(center, radius, scale):
    """SceneConfig overrides that fit the grid to the ball (test_e2e_disk's
    _train_cfg): a one-level box of `scale` radii, ~96 steps across it."""
    r = scale * radius
    aabb = np.concatenate([center - r, center + r])
    return {"aabb": aabb.tolist(), "grid_nlvl": 1,
            "render_step_size": float(np.linalg.norm(2 * r * np.ones(3))
                                      / 96)}


def _dnerf(root):
    from cednerf_torch.datasets.dnerf_synthetic import DNeRFSyntheticDataset

    make_dnerf_fixture(root, scene="lego", n_frames=4, wh=16, ring=True)
    ball = _paint(DNeRFSyntheticDataset, root, "lego", {},
                  lambda split, i: os.path.join(root, "lego",
                                                f"{split}_{i:03d}.png"))
    return root, _box(*ball, scale=3)


def _hypernerf(root):
    from cednerf_torch.datasets.hypernerf import HyperNeRFDataset

    make_hypernerf_fixture(root, scene="vrig_chicken", n_imgs=12, wh=16,
                           ring=True)
    ids = {"train": [f"{i:06d}" for i in range(0, 12, 2)],
           "test": [f"{i:06d}" for i in range(1, 12, 2)]}
    inner = os.path.join(root, "vrig_chicken", "chicken", "rgb", "2x")
    ball = _paint(HyperNeRFDataset, root, "vrig_chicken",
                  dict(factor=2, add_cam=True),
                  lambda split, i: os.path.join(inner, f"{ids[split][i]}.png"),
                  radius_frac=0.3, bkgd=(0.0, 0.0, 0.0))
    return root, _box(*ball, scale=3)


def _dynerf(root):
    from cednerf_torch.datasets.dynerf import DyNeRFDataset

    make_dynerf_fixture(root, scene="cook_spinach", n_cams=4, n_frames=4,
                        wh=16, ring=True)
    frames = os.path.join(root, "cook_spinach", "frames")
    # train: cameras 1-3, every frame; test: camera 0, every 10th frame
    ball = _paint(DyNeRFDataset, root, "cook_spinach",
                  dict(factor=4, sampling="uniform", device="cpu"),
                  lambda split, i: os.path.join(
                      frames, f"c{i // 4 + 1}_f{i % 4}.png"
                      if split == "train" else "c0_f0.png"),
                  radius_frac=0.3, bkgd=(0.0, 0.0, 0.0))
    return root, _box(*ball, scale=4)


FAMILIES = {"lego": _dnerf, "vrig_chicken": _hypernerf,
            "cook_spinach": _dynerf}
EXTRA = {"lego": [], "vrig_chicken": [],
         "cook_spinach": ["--mark_invisible", "--isg2ist_step", "16"]}


def _short_render_path(monkeypatch, n=2):
    """Render only the first n poses of each loader's video path (the
    first frame, its pose and its time are the full path's)."""
    from cednerf_torch.datasets import dnerf_synthetic, dynerf

    for cls in (dnerf_synthetic.DNeRFSyntheticDataset,
                dynerf.DyNeRFDataset):
        full = cls.render_poses
        monkeypatch.setattr(
            cls, "render_poses",
            lambda self, _full=full: {"c2w": _full(self)["c2w"][:n]})


def _run(capsys, argv):
    summary = train_real.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == {
        "train_real": json.loads(json.dumps(summary))}
    return summary, out


@pytest.mark.parametrize("scene", list(FAMILIES))
def test_train_resume_reload(scene, tmp_path, monkeypatch, capsys):
    root, box = FAMILIES[scene](str(tmp_path / "data"))
    work = tmp_path / "run"
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setenv("CEDNERF_CFG", json.dumps(TINY | box))
    ckpt = str(tmp_path / "ckpt")
    base = ["--data_root", root, "--scene", scene, "--model_path", ckpt,
            "--ckpt_every", "0"] + FLAGS + EXTRA[scene]

    first, _ = _run(capsys, base + ["--max_steps", "16"])
    assert first["step"] == first["steps"] == 32     # 2 chunks of 16
    assert first["sampler"] == ("stacked_host" if scene == "cook_spinach"
                                else "device")
    assert first["eval"]["finite"]
    for name in ("rgb_test.png", "depth_test.png", "rgb_error.png"):
        img = read_png(work / name)
        assert img.shape[:2] == (16, 16) or img.shape[:2] == (24, 24), name
    assert os.path.exists(os.path.join(ckpt, "state.pt"))

    resumed, out = _run(capsys, base + ["--max_steps", "80", "--resume"])
    assert "resumed at step 32" in out
    assert resumed["step"] == 96 and resumed["steps"] == 64
    assert resumed["eval"]["psnr_avg"] > first["eval"]["psnr_avg"] + 1.0, (
        first["eval"]["psnrs"], resumed["eval"]["psnrs"])

    video = ["--render_video"] if scene == "cook_spinach" else []
    if video:
        _short_render_path(monkeypatch)
    for name in ("rgb_test.png", "depth_test.png", "rgb_error.png"):
        os.remove(work / name)
    reloaded, out = _run(capsys, base + ["--load_model"] + video)
    assert "loaded checkpoint at step 96" in out
    assert reloaded["step"] == 96 and "eval" not in reloaded
    assert not (work / "rgb_test.png").exists()
    evaluated = train_real.evaluate_checkpoint(base + ["--device", "cpu"])
    assert evaluated["step"] == 96 and evaluated["finite"]
    assert abs(evaluated["psnr_avg"]
               - resumed["eval"]["psnr_avg"]) <= PSNR_RELOAD_DB
    if video:
        assert reloaded["video"]["frames"] == 2
        for stem in ("rgb_render", "depth_render"):
            assert (os.path.exists(work / f"{stem}.mp4")
                    or os.path.exists(work / f"{stem}_0001.png")), stem
