"""The port's proposal path against the JAX package's.

  * ops/proposal.py: s_to_t, uniform_edges, sample_from_weights (both
    sampling types, spiky, zero and tied weights), _outer_measure with
    query edges on envelope edges, proposal_loss, anneal_factor and
    proposal_sampling, JAX's own jitter draws fed to the port;
  * contract_to_unisphere and NGPDensityField (bounded and unbounded)
    through the bridge;
  * one prop train step against JAX's step body for both families'
    configs at tiny widths (loss and every gradient);
  * PropOptimizer against optax's apply_if_finite(add_decayed_weights ->
    clip_by_global_norm -> adam(schedule)): a non-finite gradient leaves
    the parameters, the moments and both counts as they were;
  * mirrors of tests/test_proposal.py's loop tests on the port
    (PropTrainer's scanned chunks, stacked host batches, occupancy culling
    in the eval renderer), 256 rays.

Tolerances. Ops: indices exact (torch.searchsorted against JAX's
compare-all search on the same arrays), values rtol 1e-6 (atol 1e-7 where a
value can be 0). NGPDensityField: test_torch_field.py's bf16 limits
(density within 3% relative plus 1e-3 absolute). Train step: those of
test_torch_train.py (loss and mse rtol 1e-3, each gradient within 8% of its
L2 norm). The optimizer on equal f32 gradients: rtol 1e-5, atol 1e-8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cednerf_tpu.engine import train_prop as jtp
from cednerf_tpu.engine.cli import build_field as j_build_field
from cednerf_tpu.engine.config import ModelFlags as JFlags
from cednerf_tpu.engine.config import dnerf_config as j_dnerf_config
from cednerf_tpu.engine.config import hypernerf_config as j_hyper_config
from cednerf_tpu.models import field as jfield_mod
from cednerf_tpu.ops import proposal as jp
from cednerf_tpu.datasets.procedural import BallScene as JBall
from cednerf_torch.bridge import (params_from_numpy, params_to_numpy,
                                  prop_params_from_numpy,
                                  prop_params_to_numpy)
from cednerf_torch.datasets.procedural import BallScene
from cednerf_torch.engine import train_prop as tp
from cednerf_torch.engine.cli import build_field
from cednerf_torch.engine.config import (ModelFlags, dnerf_config,
                                         hypernerf_config)
from cednerf_torch.engine.renderer import render_image
from cednerf_torch.models.field import NGPDensityField, contract_to_unisphere
from cednerf_torch.ops import proposal as pp

FLAGS = dict(use_div_offsets=True, use_feat_predict=True,
             use_time_embedding=True, use_time_attenuation=True,
             distortion_loss=True, acc_entropy_loss=True)
SMALL = dict(target_sample_batch_size=4096, grid_resolution=16,
             render_step_size=2e-2, max_march_steps=128,
             hash_dst_resolution=128, log2_hashmap_size=14,
             max_table_rows=512, hash_n_levels=4, grad_accum_dtype="float32")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Hundreds of small CPU ops: one torch thread per suite worker (as in
    tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _jitter(key, r, n):
    """JAX's jitter draw (uniform_edges / sample_from_weights)."""
    u = jax.random.uniform(key, (r, n + 1), minval=-0.5, maxval=0.5)
    return np.asarray(u.at[:, 0].set(0.0).at[:, -1].set(0.0))


def _close(got, want, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=atol)


# ------------------------------------------------------------------ ops --

@pytest.mark.parametrize("sampling_type", ["uniform", "lindisp"])
def test_s_to_t_matches_jax(sampling_type):
    rng = np.random.default_rng(0)
    s = rng.uniform(size=(5, 9)).astype(np.float32)
    s[:, 0], s[:, -1] = 0.0, 1.0
    near = rng.uniform(0.1, 2.0, 5).astype(np.float32)
    far = near + rng.uniform(0.5, 50.0, 5).astype(np.float32)
    for n_, f_ in ((0.2, 7.3), (near, far)):
        want = jp.s_to_t(jnp.asarray(s), jnp.asarray(n_), jnp.asarray(f_),
                         sampling_type)
        got = pp.s_to_t(_t(s), _t(n_) if isinstance(n_, np.ndarray) else n_,
                        _t(f_) if isinstance(f_, np.ndarray) else f_,
                        sampling_type)
        _close(got, want)


@pytest.mark.parametrize("n", [16, 48, 96])
def test_uniform_edges_match_jax(n):
    key = jax.random.PRNGKey(n)
    want = jp.uniform_edges(7, n, key)
    got = pp.uniform_edges(7, n, jitter=_t(_jitter(key, 7, n)))
    _close(got, want)
    np.testing.assert_array_equal(pp.uniform_edges(3, n).numpy(),
                                  np.asarray(jp.uniform_edges(3, n)))
    e = pp.uniform_edges(64, n, generator=torch.Generator().manual_seed(0))
    assert (e[:, 0] == 0).all() and (e[:, -1] == 1).all()
    assert (torch.diff(e, dim=-1) >= 0).all()


def _weights(rng, r, n, kind):
    if kind == "spiky":
        w = rng.uniform(size=(r, n)) ** 8
        w[:, ::3] = 0.0                  # exact-zero bins
    elif kind == "zero":
        w = np.zeros((r, n))             # every bin at its padding alone
    else:
        # ties: padded weights of exactly 1, so the CDF is k / n and lies
        # on the query grid i / n_new (n a multiple of n_new)
        pad = np.float32(0.01 / n)
        w = np.full((r, n), np.float32(1.0) - pad)
        assert (w + pad == 1.0).all()
    return w.astype(np.float32)


def _jax_cdf(w, padding=0.01):
    n = w.shape[-1]
    wp = jnp.asarray(w) + padding / n
    pdf = wp / jnp.sum(wp, axis=-1, keepdims=True)
    cdf = jnp.concatenate([jnp.zeros((w.shape[0], 1)), jnp.cumsum(pdf, -1)],
                          -1)
    return np.asarray(cdf.at[:, -1].set(1.0))


@pytest.mark.parametrize("kind", ["spiky", "zero", "ties"])
@pytest.mark.parametrize("jittered", [True, False])
def test_sample_from_weights_matches_jax(kind, jittered):
    """padded_cdf against JAX's CDF; invert_cdf on JAX's CDF and queries
    against JAX's resampled edges, and the bin of every query
    (torch.searchsorted against jnp.searchsorted(method='compare_all'),
    ties at the clipped ends 0 and 1 and, for "ties", at every query);
    then sample_from_weights end to end, whose CDF scan sums in another
    order than XLA's: an edge may move by its bin's width times the rows'
    largest CDF difference over the bin's CDF step."""
    rng = np.random.default_rng(1)
    r, n, n_new = 6, 32, 16 if kind == "ties" else 24
    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    edges = np.asarray(jp.uniform_edges(r, n, k1))
    w = _weights(rng, r, n, kind)
    ju = _jitter(k2, r, n_new) if jittered else None
    want = np.asarray(jp.sample_from_weights(
        jnp.asarray(edges), jnp.asarray(w), n_new,
        key=k2 if jittered else None))

    cdf = _jax_cdf(w)
    got_cdf = pp.padded_cdf(_t(w)).numpy()
    _close(got_cdf, cdf)
    u = np.broadcast_to(np.asarray(jnp.linspace(0.0, 1.0, n_new + 1)),
                        (r, n_new + 1))
    np.testing.assert_array_equal(pp._grid(n_new, torch.empty(0)).numpy(),
                                  u[0])
    if jittered:
        u = np.clip(u + ju * np.float32(1.0 / n_new), 0.0, 1.0)
    u = np.ascontiguousarray(u, np.float32)
    if kind == "ties" and not jittered:
        assert np.isin(u[0], cdf[0]).all()
    _close(pp.invert_cdf(_t(edges), _t(cdf), _t(u)), want)
    j_idx = np.asarray(jax.vmap(lambda c, q: jnp.searchsorted(
        c, q, method="compare_all"))(jnp.asarray(cdf), jnp.asarray(u)))
    np.testing.assert_array_equal(torch.searchsorted(_t(cdf), _t(u)).numpy(),
                                  j_idx)

    got = pp.sample_from_weights(_t(edges), _t(w), n_new,
                                 jitter=None if ju is None else _t(ju))
    idx = np.clip(j_idx - 1, 0, n - 1)
    rows = np.arange(r)[:, None]
    width = edges[rows, idx + 1] - edges[rows, idx]
    step = cdf[rows, idx + 1] - cdf[rows, idx]
    d_cdf = np.abs(got_cdf - cdf).max(-1, keepdims=True)
    bound = 2 * width * d_cdf / step + 1e-6 * np.abs(want)
    assert (np.abs(got.numpy() - want) <= bound).all()
    assert (torch.diff(got, dim=-1) >= 0).all()


def test_outer_measure_matches_jax():
    """Envelope edges and query edges that coincide in part (ties on both
    sides of the search), plus the clipped ends."""
    rng = np.random.default_rng(3)
    r = 5
    t_env = np.asarray(jp.uniform_edges(r, 16, jax.random.PRNGKey(4)))
    w_env = _weights(rng, r, 16, "spiky")
    q = np.sort(rng.uniform(size=(r, 25)).astype(np.float32), axis=-1)
    q[:, 3:9] = t_env[:, 2:8]                # queries on envelope edges
    q = np.sort(q, axis=-1)
    q[:, 0], q[:, -1] = 0.0, 1.0
    want = jp._outer_measure(jnp.asarray(t_env), jnp.asarray(w_env),
                             jnp.asarray(q))
    got = pp._outer_measure(_t(t_env), _t(w_env), _t(q))
    # differences of one cumsum, summed in another order than XLA's: two
    # f32 ulps of the row's total
    ulp2 = 2 * 2.0 ** -23 * w_env.sum(-1, keepdims=True)
    assert (np.abs(got.numpy() - np.asarray(want))
            <= 1e-6 * np.abs(np.asarray(want)) + ulp2).all()
    for side, right, qq in (("right", True, q[:, :-1]),
                            ("left", False, q[:, 1:])):
        j_idx = np.asarray(jax.vmap(lambda e, x: jnp.searchsorted(
            e, x, side=side, method="compare_all"))(
                jnp.asarray(t_env), jnp.asarray(qq)))
        t_idx = torch.searchsorted(_t(t_env), _t(np.ascontiguousarray(qq)),
                                   right=right).numpy()
        np.testing.assert_array_equal(t_idx, j_idx)


def test_proposal_loss_and_anneal_match_jax():
    rng = np.random.default_rng(5)
    r = 4
    recs_j, recs_t = [], []
    for n, k in ((16, 6), (8, 7)):
        e = np.asarray(jp.uniform_edges(r, n, jax.random.PRNGKey(k)))
        w = _weights(rng, r, n, "spiky")
        recs_j.append(jp.PropSamples(jnp.asarray(e), jnp.asarray(w)))
        recs_t.append(pp.PropSamples(_t(e), _t(w)))
    fe = np.asarray(jp.uniform_edges(r, 12, jax.random.PRNGKey(8)))
    fw = rng.uniform(size=(r, 12)).astype(np.float32) * 0.3
    want = float(jp.proposal_loss(recs_j, jnp.asarray(fe), jnp.asarray(fw)))
    got = pp.proposal_loss(recs_t, _t(fe), _t(fw)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert want > 0
    for step in (0, 1, 37, 999, 1000, 5000):
        np.testing.assert_allclose(
            pp.anneal_factor(step, 1000).item(),
            float(jp.anneal_factor(step, 1000)), rtol=1e-6)
        np.testing.assert_allclose(
            pp.anneal_factor(torch.tensor(step, dtype=torch.int32), 50).item(),
            float(jp.anneal_factor(step, 50)), rtol=1e-6)


def _blob_density(lib):
    """An analytic density: a shell of radius 0.6 around the origin over a
    floor of 0.5, so that no ray's weights sit at rounding level."""
    def fn(x):
        r = lib.sqrt(lib.sum(x * x, -1, keepdims=True) + 1e-12)
        return 0.5 + 30.0 * lib.exp(-((r - 0.6) / 0.15) ** 2)
    return fn


@pytest.mark.parametrize("sampling_type", ["uniform", "lindisp"])
@pytest.mark.parametrize("anneal", [1.0, 0.37])
def test_proposal_sampling_matches_jax(sampling_type, anneal):
    """Two proposal levels on an analytic density, JAX's draws fed in: each
    level's edges and weights and the final intervals. Level 0's edges are
    exact; after it the weights (transmittance scans and exps in XLA's and
    torch's rounding) and each resampling's CDF scan differ by f32 ulps,
    which a resampled edge carries times its bin's width over the bin's CDF
    step: s-edges within 1e-4, weights within 1e-5, and the final
    intervals within 1e-4 of the span in t ("uniform") or in disparity
    ("lindisp", linear in s). The floor density keeps every weight far
    above rounding level: below anneal 1 the power lifts a weight of
    2^-24 (a grazing ray where 1 - exp(-sigma dt) rounds to 0 on one side)
    toward the padding's scale, and the resampled edge moves by bins."""
    scene = JBall(n_cams=4, wh=16, n_times=2, seed=3)
    b = scene.sample(64)
    o, d = b["origins"], b["viewdirs"]
    near, far = (2.0, 6.0) if sampling_type == "uniform" else (0.5, 20.0)
    samples, n_final = (32, 16), 12
    key = jax.random.PRNGKey(9)
    keys = jax.random.split(key, 3)
    jit = [_jitter(k, 64, n) for k, n in zip(keys, (32, 16, 12))]
    j0, j1, jrec = jp.proposal_sampling(
        [_blob_density(jnp)] * 2, list(samples), n_final, jnp.asarray(o),
        jnp.asarray(d), near, far, sampling_type=sampling_type, key=key,
        anneal=anneal)
    t0, t1, trec = pp.proposal_sampling(
        [_blob_density(torch)] * 2, list(samples), n_final, _t(o), _t(d),
        near, far, sampling_type=sampling_type,
        jitters=[_t(j) for j in jit],
        anneal=anneal if anneal == 1.0 else torch.tensor(anneal))
    np.testing.assert_array_equal(trec[0].s_edges.numpy(),
                                  np.asarray(jrec[0].s_edges))
    for a, b_ in zip(trec, jrec):
        np.testing.assert_allclose(a.s_edges, np.asarray(b_.s_edges),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(a.weights, np.asarray(b_.weights),
                                   rtol=0, atol=1e-5)
    f = (lambda t: t) if sampling_type == "uniform" else (lambda t: 1.0 / t)
    span = abs(f(far) - f(near))
    for got, want in ((t0, j0), (t1, j1)):
        np.testing.assert_allclose(f(got.numpy()), f(np.asarray(want)),
                                   rtol=0, atol=1e-4 * span)
    assert float(jnp.max(jrec[0].weights)) > 0.1     # the shell is hit


# ------------------------------------------------------- density field --

def test_contract_to_unisphere_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.uniform(-20, 20, (4000, 3)).astype(np.float32)
    x[:1000] /= 20.0                               # inside the aabb too
    lo, hi = np.float32([-1.5, -1, -2]), np.float32([1.5, 2, 2])
    want = jfield_mod.contract_to_unisphere(jnp.asarray(x), lo, hi)
    got = contract_to_unisphere(_t(x), _t(lo), _t(hi))
    _close(got, want, atol=1e-7)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


@pytest.mark.parametrize("unbounded", [False, True])
def test_ngp_density_field_matches_flax(unbounded):
    aabb = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
    kw = dict(aabb=aabb, unbounded=unbounded, max_resolution=128,
              log2_hashmap_size=14, density_clamp=3.0)
    jn = jfield_mod.NGPDensityField(**kw)
    p = jax.tree_util.tree_map(np.array, jn.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((8, 3))))
    rng = np.random.default_rng(7)
    g = p["params"]["grid"]
    for k in g:          # tables the MLP feels
        g[k] = rng.uniform(-1, 1, g[k].shape).astype(np.float32)
    p["params"]["mlp"]["out"]["bias"][0] = 1.5
    tn = NGPDensityField(**kw)
    tn.load_state_dict(params_from_numpy(p), strict=True)
    pts = rng.uniform(-4, 4, (6000, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jn.apply)(p, jnp.asarray(pts)))
    got = tn(_t(pts)).detach().numpy()
    assert got.shape == want.shape == (6000, 1)
    np.testing.assert_allclose(got, want, rtol=0.03, atol=1e-3)
    inside = np.all(np.abs(pts) < 1.5, -1)
    assert (want[~inside] == 0).all() != unbounded
    assert want.max() <= np.exp(3.0) * 1.01


# ------------------------------------------------------------- one step --

def _grad_capture():
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(
        lambda p: {"g": zeros(p)}, lambda g, s, p=None: (zeros(g), {"g": g}))


STEP_CASES = {
    "dnerf": (j_dnerf_config, dnerf_config,
              dict(prop_resolutions=(64,), prop_samples=(32,), n_final=16,
                   anneal_steps=50), {}),
    "hypernerf": (lambda: j_hyper_config("vrig_3dprinter"),
                  lambda: hypernerf_config("vrig_3dprinter"),
                  dict(prop_resolutions=(64, 128), prop_samples=(32, 16),
                       n_final=12), dict(use_weight_predict=True)),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_prop_step_matches_jax(case, monkeypatch):
    """One step of JAX's prop step body (its optimizer swapped for one that
    keeps the gradients) and of the port's, from the same bridged weights,
    batch and jitter: loss, mse, n_samples and every gradient of the field
    and the proposal fields. The field's tables are uniform(-1, 1); the
    proposal fields keep their +-1e-4 init, their density e^1 from the
    MLP's bias raised to 2. With tables the MLP feels, the two sides' bf16
    MLPs differ by ~1% of a weight (test_torch_field.py's limits), and the
    resampling carries that into the final samples' positions and the
    field's table gradients (15% on a D-NeRF level, read);
    test_ngp_density_field_matches_flax holds the fields with lifted
    tables. A density of 1 would leave 1.7% of the lindisp rays'
    transmittance to their last interval (to t = 1e4), whose weight both
    sides form as cumsum - x near 1e4, 1e-3 apart in f32."""
    jcfg_fn, tcfg_fn, pkw, extra_flags = STEP_CASES[case]
    jcfg = dataclasses.replace(jcfg_fn(), **SMALL)
    tcfg = dataclasses.replace(tcfg_fn(), **SMALL)
    pcfg_kw = {**dataclasses.asdict(jtp.PropConfig.for_family(jcfg.family)),
               **pkw, "density_clamp": 20.0}
    jpcfg, tpcfg = jtp.PropConfig(**pcfg_kw), tp.PropConfig(**pcfg_kw)
    flags = {**FLAGS, **extra_flags}
    cap = _grad_capture()
    monkeypatch.setattr(jtp, "make_prop_optimizer", lambda *a, **k: cap)

    jf = j_build_field(jcfg, JFlags(**flags))
    jprops = jtp.build_prop_networks(jcfg, jpcfg)
    params = jax.tree_util.tree_map(np.array, jtp.create_prop_train_state(
        jf, jprops, jcfg, jax.random.PRNGKey(0), jpcfg).params)
    rng = np.random.default_rng(0)
    enc = params["field"]["params"]["hash_encoder"]
    for k in enc:
        enc[k] = rng.uniform(-1, 1, enc[k].shape).astype(np.float32)
    for q in params["props"]:
        q["params"]["mlp"]["out"]["bias"][0] = 2.0
    scene = JBall(n_cams=4, wh=32, n_times=4)
    batch = scene.sample(128)
    # a step past the anneal (factor 1): see test_proposal_sampling_matches_jax
    key, step = jax.random.PRNGKey(3), jpcfg.anneal_steps + 13
    k_samp, = jax.random.split(key, 1)
    keys = jax.random.split(k_samp, len(jpcfg.prop_samples) + 1)
    counts = list(jpcfg.prop_samples) + [jpcfg.n_final]
    jitters = [_t(_jitter(k, 128, n)) for k, n in zip(keys, counts)]

    step_fn = jtp._make_prop_step_impl(jf, jprops, jcfg, JFlags(**flags),
                                       jpcfg)
    jstate = jtp.PropTrainState(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        opt_state=cap.init(params))
    out, jm = jax.jit(step_fn)(jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()}, key, step)
    jgrads = jax.tree_util.tree_map(np.asarray, out.opt_state["g"])

    field = build_field(tcfg, ModelFlags(**flags), device="cpu")
    props = tp.build_prop_networks(tcfg, tpcfg, device="cpu")
    fsd, psds = prop_params_from_numpy(params)
    field.load_state_dict(fsd, strict=True)
    for p, sd in zip(props, psds):
        p.load_state_dict(sd, strict=True)
    state = tp.create_prop_train_state(field, props, tcfg, tpcfg,
                                       device="cpu")
    loss_fn = tp._make_prop_loss_fn(field, tcfg, ModelFlags(**flags), tpcfg)
    loss, aux = loss_fn(state, {k: _t(v) for k, v in batch.items()},
                        torch.tensor(step, dtype=torch.int32),
                        jitters=jitters)
    np.testing.assert_allclose(loss.item(), float(jm["loss"]), rtol=1e-3)
    np.testing.assert_allclose(aux["mse"].item(), float(jm["mse"]),
                               rtol=1e-3)
    assert aux["n_samples"].item() == float(jm["n_samples"])
    grads = [params_to_numpy({n: q.grad for n, q in m.named_parameters()})
             for m in (field,) + tuple(props)]
    tgrads = {"field": grads[0], "props": tuple(grads[1:])}
    want = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(tgrads)[0])
    assert want.keys() == got.keys()
    for k in want:
        w, g = want[k], got[k]
        assert np.linalg.norm(w) > 0, jax.tree_util.keystr(k)
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel < 0.08, (jax.tree_util.keystr(k), rel)


# ------------------------------------------------------------ optimizer --

@pytest.mark.parametrize("grad_clip,weight_decay", [(0.0, 0.0), (0.5, 1e-3)])
def test_prop_optimizer_matches_optax(grad_clip, weight_decay):
    """PropOptimizer against the JAX make_prop_optimizer on the same
    gradients; step 3 carries a NaN (params, moments and both counts stay),
    step 5 an inf; with max_consecutive_errors 1 the second of two
    non-finite steps in a row is applied, as optax does."""
    cfg = dnerf_config(max_steps=8)              # milestones 4, 6, 7
    jcfg = j_dnerf_config(max_steps=8)
    rng = np.random.default_rng(0)
    shapes = {"a": (33,), "b": (4, 5)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in
          shapes.items()}
    for max_err in (1000, 1):
        tx = (jtp.make_prop_optimizer(jcfg, grad_clip, weight_decay)
              if max_err == 1000 else optax.apply_if_finite(
                  _inner(jcfg, grad_clip, weight_decay), max_err))
        jparams = {k: jnp.asarray(v) for k, v in p0.items()}
        js = tx.init(jparams)
        tparams = [torch.nn.Parameter(torch.from_numpy(p0[k].copy()))
                   for k in shapes]
        opt = tp.PropOptimizer(tparams, cfg, grad_clip, weight_decay,
                               max_consecutive_errors=max_err)
        for step in range(8):
            grads = {k: (rng.normal(size=s) * 10.0 ** rng.integers(-3, 1, s))
                     .astype(np.float32) for k, s in shapes.items()}
            if step in (3, 4):
                grads["b"][1, 2] = np.nan if step == 3 else np.inf
            before = ([p.detach().clone() for p in tparams],
                      [m.clone() for m in opt.mu], opt.count.item(),
                      opt.schedule_count.item())
            upd, js = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                js, jparams)
            jparams = optax.apply_updates(jparams, upd)
            for p, k in zip(tparams, shapes):
                p.grad = torch.from_numpy(grads[k])
            opt.step()
            for p, k in zip(tparams, shapes):
                np.testing.assert_allclose(p.detach().numpy(),
                                           np.asarray(jparams[k]), rtol=1e-5,
                                           atol=1e-8, err_msg=f"{k} {step}")
            inner_state = js.inner_state
            adam = [s for s in jax.tree_util.tree_leaves(
                inner_state, is_leaf=lambda s: hasattr(s, "mu"))
                if hasattr(s, "mu")][0]
            for m, v, k in zip(opt.mu, opt.nu, shapes):
                np.testing.assert_allclose(m.numpy(), np.asarray(adam.mu[k]),
                                           rtol=1e-5, atol=1e-8)
                np.testing.assert_allclose(v.numpy(), np.asarray(adam.nu[k]),
                                           rtol=1e-5, atol=1e-8)
            assert opt.count.item() == int(adam.count)
            assert opt.notfinite_count.item() == int(js.notfinite_count)
            assert opt.total_notfinite.item() == int(js.total_notfinite)
            assert bool(opt.last_finite) == bool(js.last_finite)
            if step == 3 or (step == 4 and max_err == 1000):
                for a, b in zip(before[0], tparams):
                    assert torch.equal(a, b.detach())
                for a, b in zip(before[1], opt.mu):
                    assert torch.equal(a, b)
                assert (opt.count.item(), opt.schedule_count.item()) == \
                    before[2:]
        assert opt.count.item() == (6 if max_err == 1000 else 7)
        assert opt.schedule_count.item() == opt.count.item()


def _inner(jcfg, grad_clip, weight_decay):
    """The chain inside the JAX make_prop_optimizer's apply_if_finite."""
    from cednerf_tpu.engine.train import make_optimizer

    inner = make_optimizer(jcfg)
    if grad_clip > 0:
        inner = optax.chain(optax.clip_by_global_norm(grad_clip), inner)
    if weight_decay > 0:
        inner = optax.chain(optax.add_decayed_weights(weight_decay), inner)
    return inner


# ------------------------------------------------ the loops (port-side) --

def _tiny():
    """tests/test_proposal.py's loop setup (a 4-level 64-resolution field,
    one 64-resolution proposal field, anneal over 50 steps) with 32
    proposal and 16 final samples a ray and a 16^3 eval-culling grid, so
    that each CPU step takes ~0.5 s (the plain encoder backward)."""
    cfg = dataclasses.replace(dnerf_config(max_steps=300),
                              target_sample_batch_size=4096,
                              grid_resolution=16, occ_warmup_steps=16,
                              eval_chunk_seg=256, eval_chunk=256)
    pcfg = tp.PropConfig(prop_resolutions=(64,), prop_samples=(32,),
                         n_final=16, anneal_steps=50)
    from cednerf_torch.models.field import DNGPRadianceField
    field = DNGPRadianceField(aabb=cfg.aabb, n_levels=4, dst_resolution=64,
                              base_resolution=8, log2_hashmap_size=12,
                              moving_step=cfg.moving_step)
    field.reset_parameters(torch.Generator().manual_seed(0))
    return cfg, pcfg, field, tp.build_prop_networks(cfg, pcfg, device="cpu")


def test_prop_scanned_loop_trains():
    """tests/test_proposal.py::test_prop_scanned_loop_trains on the port:
    PropTrainer, 8 steps a chunk on the device sampler, 4 chunks; the
    optimizer's device count follows the steps."""
    cfg, pcfg, field, props = _tiny()
    scene = BallScene(wh=32)
    trainer = tp.PropTrainer(field, props, cfg, ModelFlags(), pcfg,
                             scene.device_sampler("cpu"), n_rays=256, seed=0,
                             steps_per_call=8, device="cpu")
    first = trainer.run_chunk()
    assert np.isfinite(first["loss"]) and trainer.step == 8
    for _ in range(3):
        last = trainer.run_chunk()
    assert trainer.step == 32
    assert last["mse"] < 0.6 * first["mse"], (first["mse"], last["mse"])
    assert trainer.state.optimizer.count.item() == 32


def test_prop_stacked_host_loop_trains():
    """The stacked-host PropTrainer (host batches, K a call) improves over
    4 chunks; with PropConfig.debug its chunks carry the NaN-source
    telemetry (all finite here)."""
    cfg, pcfg, field, props = _tiny()
    pcfg = dataclasses.replace(pcfg, debug=True)
    scene = BallScene(wh=32)
    trainer = tp.PropTrainer(field, props, cfg, ModelFlags(), pcfg, None,
                             n_rays=256, seed=0, steps_per_call=8,
                             dataset=scene, device="cpu")
    first = trainer.run_chunk()
    for _ in range(3):
        last = trainer.run_chunk()
    assert trainer.step == 32
    assert np.isfinite(last["loss"])
    assert last["mse"] < 0.8 * first["mse"], (first["mse"], last["mse"])
    assert {k: last[k] for k in ("t_finite", "grads_finite",
                                 "params_finite")} == dict.fromkeys(
        ("t_finite", "grads_finite", "params_finite"), 1.0)
    assert 0 < last["w_max"] <= 1 and 0 < last["prop_w_max"] <= 1
    assert np.isfinite(last["sigma_max"])


def test_prop_occ_eval_culling():
    """The eval-culling grid carves after the warmup, and the culled render
    of a train view is no worse than the raw one (JAX's test)."""
    cfg, pcfg, field, props = _tiny()
    scene = BallScene(wh=32)
    trainer = tp.PropTrainer(field, props, cfg, ModelFlags(), pcfg,
                             scene.device_sampler("cpu"), n_rays=256, seed=0,
                             steps_per_call=8, device="cpu")
    assert trainer.occ is not None
    for _ in range(4):       # all cells through step 16, sampled after
        trainer.run_chunk()
    bins = trainer.occ.binaries.numpy()
    assert 0 < bins.sum() < bins.size
    fn = tp.make_prop_eval_render_fn(trainer.field, trainer.props, cfg, pcfg)
    t = float(scene.times[1])
    tv = scene.image_rays(0, t)
    culled, _, _ = render_image(trainer.field, trainer.occ, fn,
                                tv["origins"], tv["viewdirs"], t, np.ones(3),
                                chunk=256)
    raw, _, _ = render_image(trainer.field, None, fn, tv["origins"],
                             tv["viewdirs"], t, np.ones(3), chunk=256)
    mse_c = float(np.mean((culled - tv["pixels"]) ** 2))
    mse_r = float(np.mean((raw - tv["pixels"]) ** 2))
    assert np.isfinite(mse_c) and mse_c <= mse_r * 1.5 + 1e-3, (mse_c, mse_r)
