"""The port's DNGPRadianceField against the flax field on bridged weights,
plus the param bridge round trip and the port's own initializer.

Tolerances (bf16 MLPs on both sides, rounded at different places: XLA and
torch's CPU bf16 matmuls accumulate and round in their own order, and the
port's encoder keeps its lane math in f32): density within 3% relative
(plus 1e-3 absolute), rgb within 1e-2 absolute after the sigmoid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.engine.config import ModelFlags as JModelFlags
from cednerf_tpu.engine.config import dnerf_config as j_dnerf_config
from cednerf_tpu.models.field import DNGPRadianceField as JField
from cednerf_torch.bridge import occ_from_numpy, params_from_numpy, \
    params_to_numpy
from cednerf_torch.engine.cli import build_field
from cednerf_torch.engine.config import ModelFlags, dnerf_config
from cednerf_torch.models.field import DNGPRadianceField
from cednerf_torch.ops.occupancy import create_occ_grid

FIELD_KW = dict(aabb=(-1.5, -1.5, -1.5, 1.5, 1.5, 1.5), n_levels=4,
                n_features_per_level=4, base_resolution=16,
                dst_resolution=128, log2_hashmap_size=14, max_table_rows=512,
                moving_step=1e-2)
FLAG_SETS = [
    dict(use_div_offsets=True, use_feat_predict=True,
         use_time_embedding=True, use_time_attenuation=True),
    dict(use_time_embedding=True, time_inject_before_sigma=False,
         use_weight_predict=True),
    dict(),
    dict(grid_type="hash4d", use_div_offsets=True, use_feat_predict=True,
         use_time_embedding=True, use_time_attenuation=True),
    # the secondary encoders and options
    dict(hash4motion=True, use_div_offsets=True, use_feat_predict=True,
         use_time_embedding=True, use_time_attenuation=True),
    dict(grid_type="triplane", use_div_offsets=True, use_feat_predict=True,
         use_time_embedding=True, use_time_attenuation=True),
    dict(encoder_impl="gather", use_div_offsets=True, use_feat_predict=True,
         use_time_embedding=True, use_time_attenuation=True),
    dict(grid_type="hash4d", encoder_impl="gather", use_time_embedding=True),
    dict(row_layout="cell", hash4motion=True, use_feat_predict=True,
         use_time_embedding=True),
]


def _jax_params(flags, seed=0, table_scale=1.0, motion_scale=None):
    jf = JField(**FIELD_KW, **flags)
    params = jf.init(jax.random.PRNGKey(seed), jnp.zeros((4, 3)),
                     jnp.zeros((4, 1)), jnp.ones((4, 3)),
                     return_internal=True)
    params = jax.tree_util.tree_map(np.asarray, params)
    # lift the tables off their +-1e-4 init so the encoder moves the output
    rng = np.random.default_rng(seed)
    for mod, scale in (("hash_encoder", table_scale),
                       ("motion_grid", motion_scale)):
        enc = params["params"].get(mod, {}) if scale else {}
        for k in enc:
            enc[k] = rng.uniform(-scale, scale,
                                 enc[k].shape).astype(np.float32)
    return jf, params


def _port(flags, params):
    f = DNGPRadianceField(**FIELD_KW, **flags)
    f.load_state_dict(params_from_numpy(params), strict=True)
    return f.eval()


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_bridge_round_trip_bit_equal(flags):
    _, params = _jax_params(flags)
    back = params_to_numpy(_port(flags, params).state_dict())
    want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_field_forward_matches_flax(flags):
    jf, params = _jax_params(flags, seed=1)
    rng = np.random.default_rng(1)
    n = 2048
    pos = rng.uniform(-1.8, 1.8, (n, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    rgb_j, res_j = jax.jit(lambda p, a, b, c: jf.apply(p, a, b, c))(
        params, pos, t, d)
    with torch.no_grad():
        rgb_t, res_t = _port(flags, params)(
            torch.from_numpy(pos), torch.from_numpy(t), torch.from_numpy(d))
    dens_j = np.asarray(res_j["density"])
    np.testing.assert_allclose(res_t["density"].numpy(), dens_j, rtol=3e-2,
                               atol=1e-3)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-2)
    # well outside the aabb (beyond any warp) the selector zeroes density
    out = np.any(np.abs(pos) >= 1.7, axis=-1)
    assert out.any() and np.all(res_t["density"].numpy()[out] == 0)


@pytest.mark.parametrize("flags", [f for f in FLAG_SETS
                                   if f.get("hash4motion")])
def test_hash4motion_move_matches_flax(flags):
    """The hash-grid motion warp with its motion_grid tables at +-1: the
    move within the internals test's limits. (The whole field's output is
    compared with the motion grid at its +-1e-4 init: a bf16-sized
    difference of the move can carry a sample across a hashed brick's
    edge, where the brick layout's features jump.)"""
    jf, params = _jax_params(flags, seed=2, motion_scale=1.0)
    rng = np.random.default_rng(2)
    n = 1024
    pos = rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    move_j = jax.jit(lambda p, a, b: jf.apply(p, a, b, method=jf.query_move))(
        params, pos, t)[1]
    with torch.no_grad():
        move_t = _port(flags, params).query_move(torch.from_numpy(pos),
                                                 torch.from_numpy(t))[1]
    move_j = np.asarray(move_j)
    assert np.abs(move_j).max() > 1e-2          # the grid moves the warp
    np.testing.assert_allclose(move_t.numpy(), move_j, rtol=3e-2, atol=2e-4)


@pytest.mark.parametrize("flags", FLAG_SETS[:2])
def test_field_internals_match_flax(flags):
    """return_internal: move, selector and the prediction heads' losses
    (the same bf16 tolerances as the forward: the heads read the encoder's
    bf16 features; move is the motion MLP's bf16 output times moving_step
    1e-2, so a near-zero move carries an absolute bf16 error up to ~2e-4)."""
    jf, params = _jax_params(flags, seed=2)
    rng = np.random.default_rng(2)
    n = 1024
    pos = rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    _, res_j = jax.jit(lambda p, a, b, c: jf.apply(
        p, a, b, c, return_internal=True))(params, pos, t, d)
    with torch.no_grad():
        _, res_t = _port(flags, params)(
            torch.from_numpy(pos), torch.from_numpy(t), torch.from_numpy(d),
            return_internal=True)
    ij, it = res_j["internal"], res_t["internal"]
    assert set(ij) == set(it)
    np.testing.assert_array_equal(it["selector"].numpy(),
                                  np.asarray(ij["selector"]))
    np.testing.assert_allclose(it["move"].numpy(), np.asarray(ij["move"]),
                               rtol=3e-2, atol=2e-4)
    for k in ("latent_losses", "weight_losses"):
        if k in ij:
            np.testing.assert_allclose(it[k].numpy(), np.asarray(ij[k]),
                                       rtol=3e-2, atol=2e-2, err_msg=k)


def test_config_copy_matches_jax():
    """Every preset and the scene lists, field for field: dnerf_config,
    hypernerf_config for every HyperNeRF scene (add_cam follows "vrig"),
    dynerf_config, and config_for_scene for every scene name and the
    procedural ones (an unknown name raises on both sides)."""
    import dataclasses

    import cednerf_torch.datasets as tds
    from cednerf_tpu import datasets as jds
    from cednerf_tpu.engine import config as jcfg
    from cednerf_torch.engine import config as tcfg

    def same(a, b):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.ray_buckets() == b.ray_buckets()

    same(dnerf_config(123), j_dnerf_config(123))
    same(dnerf_config(), j_dnerf_config())
    assert dataclasses.asdict(ModelFlags()) == dataclasses.asdict(
        JModelFlags())
    for name in ("DNERF_SYNTHETIC_SCENES", "DYNERF_SCENES",
                 "HYPERNERF_SCENES"):
        assert getattr(tds, name) == getattr(jds, name), name
    for scene in tds.HYPERNERF_SCENES:
        c = tcfg.hypernerf_config(scene)
        same(c, jcfg.hypernerf_config(scene))
        assert c.add_cam == ("vrig" in scene)
    same(tcfg.hypernerf_config("vrig_broom", 123),
         jcfg.hypernerf_config("vrig_broom", 123))
    same(tcfg.dynerf_config(123), jcfg.dynerf_config(123))
    same(tcfg.dynerf_config(), jcfg.dynerf_config())
    names = (tds.DNERF_SYNTHETIC_SCENES + tds.DYNERF_SCENES
             + tds.HYPERNERF_SCENES + ["procedural", "procedural_cloud"])
    for scene in names:
        for steps in (None, 77):
            same(tcfg.config_for_scene(scene, steps),
                 jcfg.config_for_scene(scene, steps))
    for mod in (tcfg, jcfg):
        with pytest.raises(ValueError, match="unknown scene"):
            mod.config_for_scene("no_such_scene")


def test_build_field_matches_flax_shapes_and_init():
    """The port's own initializer follows the flax shapes and
    distributions: tables uniform +-1e-4, Dense lecun-normal, zero bias."""
    from cednerf_tpu.engine.cli import build_field as j_build_field
    cfg = dnerf_config()
    flags = ModelFlags(use_div_offsets=True, use_feat_predict=True,
                       use_time_embedding=True, use_time_attenuation=True)
    f = build_field(cfg, flags, device="cpu", seed=3)
    jf = j_build_field(j_dnerf_config(), JModelFlags(**vars(flags)))
    shapes = jax.eval_shape(lambda: jf.init(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.zeros((4, 1)),
        jnp.ones((4, 3)), return_internal=True))
    want = {".".join(str(getattr(p, "key", p)) for p in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = params_to_numpy(f.state_dict())
    got = {".".join(str(getattr(p, "key", p)) for p in path): leaf.shape
           for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert got == want
    sd = f.state_dict()
    assert sd["hash_encoder.bricks_7"].abs().max() <= 1e-4
    assert sd["hash_encoder.bricks_7"].std() > 5e-5
    w = sd["mlp_head.hidden_1.weight"]
    assert abs(w.std().item() - (1 / 64) ** 0.5) < 0.02
    assert w.abs().max() <= 2 * (1 / 64) ** 0.5 / 0.8796 + 1e-6
    assert torch.count_nonzero(sd["mlp_head.hidden_1.bias"]) == 0
    g = build_field(cfg, flags, device="cpu", seed=3).state_dict()
    assert all(torch.equal(sd[k], g[k]) for k in sd)


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = dnerf_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_field(cfg, ModelFlags())
    with pytest.raises(RuntimeError, match="CUDA"):
        create_occ_grid(cfg.aabb, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        occ_from_numpy(np.zeros((1, 8)), np.zeros((1, 2, 2, 2), bool),
                       np.asarray([cfg.aabb], np.float32))


def test_unported_field_options_raise():
    """The options that raised before they were ported build the flax
    field's parameter tree (names and shapes), and query_density runs;
    values that neither package has still raise."""
    for kw in (dict(hash4motion=True), dict(grid_type="triplane"),
               dict(grid_type="hash4d", hash4motion=True),
               dict(grid_type="hash4d", row_layout="cell"),
               dict(encoder_impl="gather", hash4motion=True)):
        _, params = _jax_params(kw)
        want = params_from_numpy(params)
        f = DNGPRadianceField(**FIELD_KW, **kw)
        got = f.state_dict()
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}, kw
        with torch.no_grad():
            d = f.query_density(torch.zeros(4, 3), torch.zeros(4, 1))
        assert d["density"].shape == (4, 1)
    with pytest.raises(ValueError, match="grid_type"):
        DNGPRadianceField(**FIELD_KW, grid_type="hash5d")
    with pytest.raises(ValueError, match="impl"):
        DNGPRadianceField(**FIELD_KW, encoder_impl="dense")


def test_occ_from_numpy():
    occs = np.random.default_rng(0).uniform(size=(1, 8 ** 3)).astype(
        np.float32)
    bins = occs.reshape(1, 8, 8, 8) > 0.5
    aabbs = np.asarray([[-1, -1, -1, 1, 1, 1]], np.float32)
    st = occ_from_numpy(occs, bins, aabbs, device="cpu")
    assert st.binaries.dtype == torch.bool and st.resolution == 8
    np.testing.assert_array_equal(st.occs.numpy(), occs)
    np.testing.assert_array_equal(st.binaries.numpy(), bins)
