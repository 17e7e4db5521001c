"""The port's ray data parallelism (cednerf_torch/parallel/mesh.py, the mesh
paths of Trainer, PropTrainer and render_image, blocked K4's plain
version) against the JAX package's mesh and against the port's own
one-process program.

Two ranks run as two processes of a gloo group on a FileStore under
pytest's tmp_path (tests/torch_mesh_worker.py), on the CPU. The contract is
JAX's (docs/PARALLELISM.md): N ranks train the same model as one process
with compact_blocks = N. All draws come from numpy with fixed seeds; the
weights cross over through bridge.params_from_numpy.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from cednerf_tpu.datasets.procedural import BallScene as JBall
from cednerf_tpu.engine import renderer as jr
from cednerf_tpu.engine import train as jt
from cednerf_tpu.engine.cli import build_field as j_build_field
from cednerf_tpu.engine.config import ModelFlags as JFlags
from cednerf_tpu.engine.config import dnerf_config as j_dnerf_config
from cednerf_tpu.ops.occupancy import create_occ_grid as j_create_occ
from cednerf_tpu.parallel import make_mesh as j_make_mesh
from cednerf_tpu.parallel import replicate as j_replicate
from cednerf_tpu.parallel import shard_batch as j_shard_batch
from cednerf_torch.bridge import params_from_numpy, params_to_numpy
from cednerf_torch.ops import compact_kernels as ck
from cednerf_torch.parallel import mesh as pm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grad_capture():
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    import optax
    return optax.GradientTransformation(
        lambda p: {"g": zeros(p)}, lambda g, s, p=None: (zeros(g), {"g": g}))


def _step_inputs():
    """JAX weights (tables uniform(-1, 1)), a grid with 30% of its cells
    occupied, a BallScene batch of 128 rays and the march jitter, as
    test_torch_train.py's _step_parity draws them."""
    jcfg = dataclasses.replace(j_dnerf_config(), grad_accum_dtype="float32",
                               **W.SMALL)
    jfield = j_build_field(jcfg, JFlags(**W.FLAGS))
    params = jax.tree_util.tree_map(np.array, jt.create_train_state(
        jfield, jcfg, jax.random.PRNGKey(0)).params)
    rng = np.random.default_rng(0)
    enc = params["params"]["hash_encoder"]
    for k in enc:
        enc[k] = rng.uniform(-1, 1, enc[k].shape).astype(np.float32)
    occ = j_create_occ(jcfg.aabb, jcfg.grid_resolution, jcfg.grid_nlvl)
    bins = rng.uniform(size=occ.binaries.shape) < 0.3
    occs = np.where(bins, 0.5, 0.0).astype(np.float32).reshape(
        jcfg.grid_nlvl, -1)
    occ = occ._replace(occs=jnp.asarray(occs), binaries=jnp.asarray(bins))
    batch = {k: np.asarray(v) for k, v in
             JBall(n_cams=4, wh=32, n_times=4).sample(W.STEP_RAYS).items()}
    key = jax.random.PRNGKey(3)
    k_march, = jax.random.split(key, 1)          # as the JAX step splits
    jitter = np.asarray(jax.random.uniform(k_march, (W.STEP_RAYS,)))
    return dict(jcfg=jcfg, jfield=jfield, params=params, occ=occ, key=key,
                batch=batch, jitter=jitter, occs=occs, bins=bins,
                aabbs=np.asarray(occ.aabbs))


def _jax_mesh_step(inp):
    """JAX's step on a 2-device mesh (rays sharded, state replicated,
    compact_blocks 2): (loss, numpy gradients)."""
    cap = _grad_capture()
    one = jt._make_one_step(inp["jfield"], inp["jcfg"], JFlags(**W.FLAGS),
                            W.STEP_BUDGET, cap)
    state = jt.TrainState(
        params=jax.tree_util.tree_map(jnp.asarray, inp["params"]),
        opt_state=cap.init(inp["params"]), occ=inp["occ"])
    mesh = j_make_mesh(2)
    out, m = jax.jit(one)(j_replicate(state, mesh),
                          j_shard_batch({k: jnp.asarray(v) for k, v in
                                         inp["batch"].items()}, mesh),
                          inp["key"])
    return float(m["loss"]), jax.tree_util.tree_map(np.asarray,
                                                    out.opt_state["g"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-rank results of every case (started first, in the
    background), the one-process results beside them, and JAX's."""
    tmp = tmp_path_factory.mktemp("mesh")
    inp = _step_inputs()
    torch.save({"params": params_from_numpy(inp["params"]),
                "occs": inp["occs"], "bins": inp["bins"],
                "aabbs": inp["aabbs"], "batch": inp["batch"],
                "jitter": inp["jitter"]}, tmp / "step_inputs.pt")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"),
         str(tmp / "store"), str(rank), "2", str(tmp), str(tmp), "step",
         "chunk", "prop"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        one = {case: W.CASES[case](None, str(tmp)) for case in W.CASES}
        jax_loss, jax_grads = _jax_mesh_step(inp)
        for p in procs:
            out = p.communicate(timeout=300)[0]
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    two = {case: [torch.load(tmp / f"{case}_{r}.pt", weights_only=False)
                  for r in range(2)] for case in W.CASES}
    return dict(one=one, two=two, jax_loss=jax_loss, jax_grads=jax_grads)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_two_rank_step_matches_jax_mesh(runs):
    """The port's 2-rank gloo step against JAX's step on a 2-device mesh
    (conftest's virtual devices), same weights, batch and jitter: loss
    rtol 1e-3, each gradient within 8% of its L2 norm
    (test_torch_train.py's limits)."""
    two = runs["two"]["step"]
    loss = two[0]["loss"] + two[1]["loss"]
    np.testing.assert_allclose(loss, runs["jax_loss"], rtol=1e-3)
    got = params_to_numpy(two[0]["grads"])
    want = dict(jax.tree_util.tree_flatten_with_path(runs["jax_grads"])[0])
    got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert want.keys() == got.keys()
    for k in want:
        assert np.linalg.norm(want[k]) > 0, jax.tree_util.keystr(k)
        assert _rel(got[k], want[k]) < 0.08, jax.tree_util.keystr(k)


def test_two_rank_step_matches_one_process(runs):
    """Against the port's own one-process compact_blocks=2 step: loss rtol
    1e-6, the global demand exact, the two ranks' summed gradients
    bit-equal, and each gradient within a limit of its norm set by the
    arithmetic that forms it: the hash tables' (f32 accumulation, K6's
    plain version) within 1e-4 (read: <= 4.7e-5, the packed distortion
    loss's prefixes start at each rank's own buffer); the MLPs' within
    1e-2, since their weight gradients come out of bf16 matmuls, so each
    rank's partial is rounded to bf16 (2^-8 relative) before the sum
    where the one process rounds the whole (read: <= 4.0e-3)."""
    one, two = runs["one"]["step"], runs["two"]["step"]
    np.testing.assert_allclose(two[0]["loss"] + two[1]["loss"], one["loss"],
                               rtol=1e-6)
    assert two[0]["n_valid"] == two[1]["n_valid"] == one["n_valid"]
    for name, g in one["grads"].items():
        a, b = two[0]["grads"][name], two[1]["grads"][name]
        assert torch.equal(a, b), name
        limit = 1e-4 if name.startswith("hash_encoder.") else 1e-2
        assert _rel(a.numpy(), g.numpy()) < limit, name


def test_two_rank_chunks_bit_equal_and_match_one_process(runs):
    """Two run_chunks (warmup, then steady) of Trainer(mesh=...): both
    ranks end with bit-equal parameters and occupancy grids and took the
    same host decisions; the chunks' loss, PSNR and demand match the
    one-process compact_blocks=2 Trainer's."""
    one, (r0, r1) = runs["one"]["chunk"], runs["two"]["chunk"]
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k
    assert torch.equal(r0["occs"], r1["occs"])
    assert torch.equal(r0["binaries"], r1["binaries"])
    assert r0["log"] == r1["log"]
    assert (r0["step"], r0["bucket"], r0["steady"]) == (
        one["step"], one["bucket"], one["steady"]) == (8, r1["bucket"],
                                                       r1["steady"])
    for got, want in zip(r0["chunks"], one["chunks"]):
        for k in ("loss", "mse", "psnr", "complete_frac"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(got["n_valid"], want["n_valid"],
                                   rtol=1e-6)
    assert torch.equal(r0["binaries"], one["binaries"])


def test_render_image_mesh_matches_single(runs):
    """render_image(mesh=...) against mesh=None on the same trained field:
    rgb and opacity within 1e-5, depth within 1e-5 of itself where the
    opacity is at least 1e-2 (a transparent ray's depth divides by its
    opacity); every rank gets the whole frame. Each rank's pass loop runs
    on its own rows, so the passes group a ray's samples differently."""
    for r in runs["two"]["chunk"]:
        (rgb0, op0, dep0), (rgb1, op1, dep1) = r["frame"], r["frame_mesh"]
        assert rgb1.shape == rgb0.shape == (16, 16, 3)
        np.testing.assert_allclose(rgb1, rgb0, atol=1e-5)
        np.testing.assert_allclose(op1, op0, atol=1e-5)
        seen = op0 >= 1e-2
        assert seen.any()
        np.testing.assert_allclose(dep1[seen], dep0[seen], rtol=1e-5)


def test_prop_trainer_mesh_matches_one_process(runs):
    """One PropTrainer(mesh=...) chunk on 2 ranks: the networks and the
    eval grid bit-equal across the ranks, the chunk's loss, mse, PSNR and
    samples within 1e-5 of the one-process chunk's. (Parameters after
    Adam are not compared across the two programs: Adam scales a gradient
    that is ~0 on one reduction order and exactly 0 on the other to a
    full step, as tests/test_parallel.py notes.)"""
    one, (r0, r1) = runs["one"]["prop"], runs["two"]["prop"]
    for a, b in zip(r0["params"], r1["params"]):
        assert torch.equal(a, b)
    assert torch.equal(r0["occs"], r1["occs"])
    for k in ("loss", "mse", "psnr", "n_samples"):
        np.testing.assert_allclose(r0["metrics"][k], one["metrics"][k],
                                   rtol=1e-5, err_msg=k)


def _blocked_lattice(r, m, n_blocks, seed):
    """[r, m] at ~40% valid with block 0 empty and the last block full
    (it overflows its budget share)."""
    v = np.random.default_rng(seed).uniform(size=(r, m)) < 0.4
    rb = r // n_blocks
    v[:rb] = False
    v[-rb:] = True
    return v


@pytest.mark.parametrize("n_blocks", [2, 4, 8])
def test_blocked_compact_select_matches_jax(n_blocks):
    """Blocked K4's plain version (and the kernel wrapper on CPU tensors)
    against JAX's compact_select(n_blocks): an empty block, an overflowing
    one, and a block size (R*M / n_blocks) that is no multiple of 16;
    integers exact."""
    r, m, budget = 8 * 15, 77, 8 * 512
    v = _blocked_lattice(r, m, n_blocks, seed=n_blocks)
    sel, kept, rank = ck.compact_select(torch.from_numpy(v), budget,
                                        n_blocks)
    js, jk, jrk = jr.compact_select(jnp.asarray(v), budget,
                                    n_blocks=n_blocks)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(js))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(rank.numpy()[v], np.asarray(jrk)[v])
    bb = budget // n_blocks
    assert (sel.numpy()[:bb] == r * m).all()          # the empty block
    assert (sel.numpy()[-bb:] < r * m).all()          # the overflowing one
    ks, kk = ck.compact_select_kernel(torch.from_numpy(v), budget, n_blocks)
    assert torch.equal(ks, sel) and torch.equal(kk, kept)
    with pytest.raises(ValueError, match="split"):
        ck.compact_select_kernel(torch.from_numpy(v[:-1]), budget, n_blocks)


def test_mesh_helpers_one_rank():
    """make_mesh alone makes a one-rank gloo group; shard_batch keeps JAX's
    rule (axis 0 divisible: split; n_rows: only leaves of that length);
    the collectives of one rank return their inputs."""
    import torch.distributed as dist

    made = not dist.is_initialized()
    try:
        mesh = pm.make_mesh(device="cpu")
        assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, "gloo")
        batch = {"o": torch.arange(8.0).reshape(4, 2),
                 "bkgd": torch.ones(3), "s": torch.tensor(1.0)}
        assert pm.shard_batch(batch, mesh)["o"].shape == (4, 2)
        assert pm.shard_batch(batch, mesh, n_rows=4)["bkgd"].shape == (3,)
        t = torch.arange(6.0)
        assert torch.equal(pm.global_sum(t, mesh), t)
        assert torch.equal(pm.all_gather_rows(t[:, None], mesh), t[:, None])
        lin = torch.nn.Linear(2, 2)
        lin.weight.grad = torch.ones(2, 2)
        pm.all_reduce_grads(lin.parameters(), mesh)
        assert torch.equal(lin.weight.grad, torch.ones(2, 2))
        assert pm.replicate({"m": lin, "b": torch.zeros(2, dtype=torch.bool)},
                            mesh)["m"] is lin
        with pytest.raises(ValueError, match="n_devices"):
            pm.make_mesh(n_devices=2, device="cpu")
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def test_mesh_rows_split():
    mesh = pm.Mesh(size=4, rank=2, device=torch.device("cpu"), group=None,
                   backend="gloo")
    assert mesh.rows(16) == slice(8, 12)
    with pytest.raises(ValueError, match="split"):
        mesh.rows(10)
    batch = {"x": np.arange(16), "c": np.ones(3), "k": np.arange(8)}
    out = pm.shard_batch(batch, mesh)
    assert list(out["x"]) == [8, 9, 10, 11] and out["c"].shape == (3,)
    assert list(out["k"]) == [4, 5]
    assert pm.shard_batch(batch, mesh, n_rows=16)["k"].shape == (8,)
