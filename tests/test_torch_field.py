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
]


def _jax_params(flags, seed=0, table_scale=1.0):
    jf = JField(**FIELD_KW, **flags)
    params = jf.init(jax.random.PRNGKey(seed), jnp.zeros((4, 3)),
                     jnp.zeros((4, 1)), jnp.ones((4, 3)),
                     return_internal=True)
    params = jax.tree_util.tree_map(np.asarray, params)
    # lift the tables off their +-1e-4 init so the encoder moves the output
    rng = np.random.default_rng(seed)
    enc = params["params"]["hash_encoder"]
    for k in enc:
        enc[k] = rng.uniform(-table_scale, table_scale,
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


def test_config_copy_matches_jax():
    import dataclasses
    assert dataclasses.asdict(dnerf_config(123)) == \
        dataclasses.asdict(j_dnerf_config(123))
    assert dataclasses.asdict(ModelFlags()) == dataclasses.asdict(
        JModelFlags())
    assert dnerf_config().ray_buckets() == j_dnerf_config().ray_buckets()


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
    with pytest.raises(NotImplementedError):
        DNGPRadianceField(**FIELD_KW, hash4motion=True)
    with pytest.raises(NotImplementedError):
        DNGPRadianceField(**FIELD_KW, grid_type="hash4d")
    f = DNGPRadianceField(**FIELD_KW)
    with pytest.raises(NotImplementedError, match="training"):
        f.query_density(torch.zeros(2, 3), torch.zeros(2, 1),
                        return_internal=True)


def test_occ_from_numpy():
    occs = np.random.default_rng(0).uniform(size=(1, 8 ** 3)).astype(
        np.float32)
    bins = occs.reshape(1, 8, 8, 8) > 0.5
    aabbs = np.asarray([[-1, -1, -1, 1, 1, 1]], np.float32)
    st = occ_from_numpy(occs, bins, aabbs, device="cpu")
    assert st.binaries.dtype == torch.bool and st.resolution == 8
    np.testing.assert_array_equal(st.occs.numpy(), occs)
    np.testing.assert_array_equal(st.binaries.numpy(), bins)
