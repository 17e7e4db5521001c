"""A checkpoint of the JAX package's Trainer, converted to a port checkpoint
through the bridge (cednerf_torch.bridge.params_from_numpy /
occ_from_numpy), renders in `python -m cednerf_torch.train_real
--load_model --render_video` (main(), in process, --device cpu) the same
first video frame as JAX's render_image of the same pose: within the seg
renderer's parity tolerance (tests/test_torch_renderer.py: rgb 5e-3), plus
one uint8 step for the truncation of each side's frame to 8 bits. The
scene is test_torch_train_real.py's painted D-NeRF one at its tiny
CEDNERF_CFG.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np

from cednerf_torch.utils.image import read_png
from test_torch_train_real import (FLAGS, TINY, _dnerf,  # noqa: F401
                                   _one_torch_thread, _run,
                                   _short_render_path)


def test_jax_checkpoint_renders_in_port(tmp_path, monkeypatch, capsys):
    """A few steps of the JAX package's Trainer, its save_checkpoint, the
    checkpoint converted through the bridge into a port checkpoint; then
    `--load_model --render_video` in the port: its first video frame
    against JAX's render_image of the same pose."""
    from cednerf_tpu.datasets.dnerf_synthetic import (
        DNeRFSyntheticDataset as JDNeRF)
    from cednerf_tpu.engine import checkpoint as j_ckpt
    from cednerf_tpu.engine.cli import build_field as j_build_field
    from cednerf_tpu.engine.config import ModelFlags as JFlags
    from cednerf_tpu.engine.config import dnerf_config as j_dnerf_config
    from cednerf_tpu.engine.renderer import eval_chunk_for as j_chunk
    from cednerf_tpu.engine.renderer import make_eval_render_fn as j_make_fn
    from cednerf_tpu.engine.renderer import render_image as j_render_image
    from cednerf_tpu.engine.train import Trainer as JTrainer
    from cednerf_tpu.engine.train import create_train_state as j_state
    from cednerf_torch.bridge import occ_from_numpy, params_from_numpy
    from cednerf_torch.engine.checkpoint import save_checkpoint
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags, dnerf_config
    from cednerf_torch.engine.train import create_train_state

    root, _ = _dnerf(str(tmp_path / "data"))
    flag_kw = dict(use_div_offsets=True, use_feat_predict=True,
                   use_time_embedding=True, use_time_attenuation=True,
                   distortion_loss=True, acc_entropy_loss=True)
    jcfg = dataclasses.replace(j_dnerf_config(16), **TINY)
    jfield = j_build_field(jcfg, JFlags(**flag_kw))
    trainer = JTrainer(jfield, jcfg, JFlags(**flag_kw),
                       JDNeRF("lego", root, "train", num_rays=64), seed=0)
    for _ in range(6):
        trainer.run_step()
    j_ckpt.save_checkpoint(str(tmp_path / "jax_ckpt"), trainer.state,
                           trainer.step)
    jstate, step = j_ckpt.load_checkpoint(
        str(tmp_path / "jax_ckpt"), j_state(jfield, jcfg,
                                            jax.random.PRNGKey(42)))
    assert step == 6

    # the conversion: JAX params and occupancy -> a port checkpoint
    cfg = dataclasses.replace(dnerf_config(16), **TINY)
    field = build_field(cfg, ModelFlags(**flag_kw), device="cpu")
    field.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate.params)))
    state = create_train_state(field, cfg, device="cpu")
    state.occ = occ_from_numpy(np.asarray(jstate.occ.occs),
                               np.asarray(jstate.occ.binaries),
                               np.asarray(jstate.occ.aabbs), device="cpu")
    save_checkpoint(str(tmp_path / "port_ckpt"), state, step)

    work = tmp_path / "run"
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setenv("CEDNERF_CFG", json.dumps(TINY))
    _short_render_path(monkeypatch)
    summary, _ = _run(capsys, ["--data_root", root, "--scene", "lego",
                               "--load_model", "--render_video",
                               "--model_path", str(tmp_path / "port_ckpt")]
                      + FLAGS)
    assert summary["step"] == 6 and summary["video"]["frames"] == 2
    got = read_png(work / "rgb_render_0000.png")

    test = JDNeRF("lego", root, "test", num_rays=None)
    rays = test.pose_rays(test.render_poses(), 0)
    rgb, opac, _ = j_render_image(
        jfield, jstate.params, jstate.occ, j_make_fn(jfield, jcfg),
        rays["origins"], rays["viewdirs"], jnp.float32(rays["timestamp"]),
        jnp.zeros(3), chunk=j_chunk(jcfg))
    assert 0.05 < float(np.mean(opac)) < 0.95         # a non-trivial frame
    want = np.flip((np.asarray(rgb) * 255).astype(np.uint8), axis=1)
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 5e-3 * 255 + 1, diff.max()
