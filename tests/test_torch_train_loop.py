"""The port's scanned train path: the K-step loop, the Trainer's chunked
run with its host adaptation, and checkpoints.

  * a K-step loop against K single steps fed the same draws; the stacked
    host sampler and its one-copy upload;
  * the Trainer's host adaptation (ray bucket, steady lattice) against the
    JAX Trainer's on scripted per-chunk metrics;
  * the JAX package's scanned-path tests (tests/test_train_loop.py) on the
    port's CPU Trainer: training, run's dispatch, hooks, the stacked host
    path, shrink-from-full, the pinned lattice, the doubling repair,
    bit-exact kill-and-resume, the shape-mismatch error and one hash4d
    chunk.

Exactness. Bucket and lattice decisions are exact. The loop-vs-steps and
resume comparisons are bit-exact: one CPU process, the same ops in the same
order. (The steady march and step: tests/test_torch_steady_march.py.)
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.datasets.procedural import BallScene as JBall
from cednerf_tpu.engine import train as jt
from cednerf_tpu.engine.cli import build_field as j_build_field
from cednerf_tpu.engine.config import ModelFlags as JFlags
from cednerf_tpu.engine.config import dnerf_config as j_dnerf_config
from cednerf_torch.datasets.procedural import BallScene
from cednerf_torch.engine import train as tt
from cednerf_torch.engine.cli import build_field
from cednerf_torch.engine.config import ModelFlags, dnerf_config
from cednerf_torch.engine.sampling import make_stacked_sampler, upload_stacked

# the port's CPU Trainer runs (the JAX tests' tiny_cfg, a smaller field)
TINY = dict(target_sample_batch_size=4096, grid_resolution=32,
            render_step_size=2e-2, max_march_steps=256,
            occ_warmup_steps=24, occ_update_interval=8,
            hash_dst_resolution=64, log2_hashmap_size=12,
            max_table_rows=512, hash_n_levels=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The CPU steps are hundreds of small ops: one OpenMP thread per core
    in each of the suite's worker processes would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_stacked_sampler_slices_by_step():
    sample = make_stacked_sampler()
    host = {"origins": np.arange(24.0).reshape(4, 2, 3),
            "color_bkgd": np.arange(12.0).reshape(4, 3)}
    data = upload_stacked(host, torch.device("cpu"))
    assert data["origins"].dtype == torch.float32
    out = sample(data, None, 2, 2)
    np.testing.assert_array_equal(out["origins"].numpy(),
                                  host["origins"][2])
    np.testing.assert_array_equal(out["color_bkgd"].numpy(),
                                  host["color_bkgd"][2])


def _tiny(**kw):
    return dataclasses.replace(dnerf_config(max_steps=200), **{**TINY, **kw})


def _trainer(cfg, seed=0, flags=None, scene=None, **kw):
    flags = flags or ModelFlags()
    scene = scene or BallScene(wh=32)
    field = build_field(cfg, flags, device="cpu", seed=seed)
    if "stacked_host" not in kw:
        kw.setdefault("device_sampler", scene.device_sampler(device="cpu"))
    kw.setdefault("steps_per_call", 8)
    return tt.Trainer(field, cfg, flags, scene, seed=seed, device="cpu",
                      **kw)


def _params(trainer):
    return {k: v.detach().clone() for k, v in
            trainer.field.state_dict().items()}


def test_loop_matches_single_steps():
    """One 8-step chunk (across the end of an 8-step warmup, so both
    occupancy branches run) equals 8 single steps fed the same draws in
    the loop's order: occupancy update, batch, march jitter."""
    cfg = _tiny(occ_warmup_steps=8, occ_update_interval=4)
    a = _trainer(cfg, seed=5)
    b = _trainer(cfg, seed=5)
    a.step = b.step = 4              # steps 4..11: warmup, then sampled
    a.run_chunk()
    data, sample_fn = b.device_sampler
    step_fn = tt.make_train_step(b.field, cfg, b.flags)
    rows = []
    for i in range(8):
        step = 4 + i
        if step % cfg.occ_update_interval == 0:
            fn = b._occ_warm if step < cfg.occ_warmup_steps \
                else b._occ_sampled
            b.state.occ = fn(b.state.occ, b.timestamps_pool, b.generator)
        batch = sample_fn(data, b.generator, b.bucket, i)
        b.state, m = step_fn(b.state, batch, generator=b.generator)
        rows.append([m[k].item() for k in tt.METRICS])
    pa, pb = _params(a), _params(b)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert torch.equal(a.state.occ.occs, b.state.occ.occs)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _scripted(seq):
    """Per-chunk scripted metrics: each entry (n_valid_per_ray,
    complete_frac, span_slots) -> one chunk of K identical steps."""
    return [dict(nvr=v, cf=c, span=s) for v, c, s in seq]


ADAPT = {
    # shrink-from-full: 3 complete chunks after the warmup shrink the full
    # lattice to the span plus the margin; the cooldown holds it; a later
    # run of incomplete chunks doubles it back
    "shrink": (dict(max_march_steps=512),
               [(40.0, 0.7, 500)] * 6 + [(30.0, 1.0, 180)] * 3
               + [(30.0, 1.0, 60)] * 4 + [(30.0, 0.98, 60)] * 4
               + [(35.0, 1.0, 40)] * 3),
    # an explicit short lattice doubles after 3 incomplete chunks, to the
    # full lattice at most; auto stays off
    "double": (dict(steady_march_steps=32),
               [(20.0, 0.95, 100)] * 12 + [(20.0, 0.4, 100)] * 2),
    # an explicit full-width lattice: never shrunk, never doubled
    "pinned": (dict(steady_march_steps=256), [(25.0, 1.0, 20)] * 8),
}


@pytest.mark.parametrize("case", sorted(ADAPT))
def test_host_adaptation_matches_jax(case, monkeypatch):
    """The Trainer's per-chunk host logic against the JAX Trainer's: both
    loops are replaced by one that returns the same scripted metrics, and
    (bucket, steady lattice) must agree after every chunk."""
    cfg_kw, seq = ADAPT[case]
    K = 4
    tcfg = _tiny(**cfg_kw)
    jcfg = dataclasses.replace(j_dnerf_config(max_steps=200),
                               **{**TINY, **cfg_kw})
    for k in ("hash_dst_resolution", "log2_hashmap_size", "hash_n_levels"):
        assert getattr(jcfg, k) == getattr(tcfg, k)
    jscene = JBall(wh=8)
    jtr = jt.Trainer(j_build_field(jcfg, JFlags()), jcfg, JFlags(), jscene,
                     seed=0, device_sampler=jscene.device_sampler(),
                     steps_per_call=K)
    ttr = _trainer(tcfg, steps_per_call=K, scene=BallScene(wh=8))
    assert jtr.steady_march == ttr.steady_march
    script = _scripted(seq)

    def rows(i, n_rays):
        s = script[i]
        return dict(loss=0.1, mse=0.05, n_samples=1000.0,
                    n_valid=s["nvr"] * n_rays, max_depth=1.0,
                    complete_frac=s["cf"], span_slots=float(s["span"]),
                    psnr=13.0)

    calls = {"j": 0, "t": 0}

    def j_loop(n_rays):
        def fn(state, data, pool, key, step0):
            r = rows(calls["j"], n_rays)
            calls["j"] += 1
            return state, {k: jnp.full((K,), v, jnp.float32)
                           for k, v in r.items() if k != "psnr"}
        return fn

    def t_loop(n_rays):
        def fn(state, data, pool, gen, step0):
            r = rows(calls["t"], n_rays)
            calls["t"] += 1
            return state, torch.tensor([[r[k] for k in tt.METRICS]] * K)
        return fn

    monkeypatch.setattr(jtr, "_loop_fn", j_loop)
    monkeypatch.setattr(ttr, "_loop_fn", t_loop)
    trace = []
    with pytest.warns() if case == "double" else _no_warning():
        for _ in script:
            mj = jtr.run_chunk()
            mt = ttr.run_chunk()
            assert (ttr.step, ttr.bucket, ttr.steady_march) == (
                jtr.step, jtr.bucket, jtr.steady_march)
            for k in ("n_valid", "complete_frac", "num_rays"):
                np.testing.assert_allclose(mt[k], mj[k], rtol=1e-6)
            trace.append(ttr.steady_march)
    if case == "shrink":
        target = int(np.ceil((180 + ttr._steady_margin()) / 64) * 64)
        assert trace[:8] == [0] * 8 and trace[8] == target
        assert 2 * target in trace          # the repair after the shrink
    elif case == "double":
        assert trace[-1] == 256 and 64 in trace and 128 in trace
    else:
        assert set(trace) == {256}


class _no_warning:
    def __enter__(self):
        import warnings
        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("error")

    def __exit__(self, *a):
        return self._cm.__exit__(*a)


# ---- the JAX package's scanned-path tests, on the port's CPU Trainer ----

# a smaller budget where a test checks control flow, not training
FAST = dict(target_sample_batch_size=1024)


def test_run_chunk_trains():
    tr_ = _trainer(_tiny())
    first = tr_.run_chunk()
    assert tr_.step == 8
    for _ in range(7):
        last = tr_.run_chunk()
    assert tr_.step == 64
    assert np.isfinite(last["loss"])
    assert last["mse"] < 0.7 * first["mse"], (first["mse"], last["mse"])
    # the occupancy grid was updated inside the chunks
    assert bool(tr_.state.occ.binaries.any())


def test_run_dispatches_to_run_chunk():
    tr_ = _trainer(_tiny(**FAST), seed=1)
    calls, logs = [], []
    chunk = tr_.run_chunk

    def counted():
        calls.append(tr_.step)
        return chunk()

    tr_.run_chunk = counted
    tr_.run_step = lambda: pytest.fail("run took run_step")
    tr_.run(16, log_every=8, log_fn=logs.append)
    assert calls == [0, 8, 16] and tr_.step == 24   # while step <= 16
    assert len(logs) == 3 and "step=24" in logs[-1]


def test_run_hooks_fire_once_at_step():
    tr_ = _trainer(_tiny(**FAST))
    fired = []
    tr_.run(24, log_every=0,
            hooks=[(16, lambda: fired.append(tr_.step)),
                   (0, lambda: fired.append(-tr_.step or -1))])
    assert fired == [-1, 16]


def test_stacked_host_path_trains_and_slices():
    """stacked_host: K host batches per chunk in one upload, the next
    chunk's assembled after the dispatch; step i of the chunk trains on
    row i."""
    scene = BallScene(wh=32)
    tr_ = _trainer(_tiny(**FAST), scene=scene, steps_per_call=4,
                   stacked_host=True)
    assert tr_._stacked and tr_.device_sampler[0] is None
    seen = []
    one = tr_._loop_fn(tr_.bucket)
    sample_fn = tr_.device_sampler[1]

    def spy(data, gen, n, i):
        seen.append((i, data["origins"][i].clone()))
        return sample_fn(data, gen, n, i)

    tr_.device_sampler = (None, spy)
    tr_._loop_fns.clear()
    m1 = tr_.run_chunk()
    prefetched = tr_._prefetched
    assert prefetched is not None and prefetched[0] == tr_.bucket
    m2 = tr_.run_chunk()
    assert tr_.step == 8
    assert np.isfinite(m1["loss"]) and np.isfinite(m2["loss"])
    assert [i for i, _ in seen] == [0, 1, 2, 3] * 2
    # the second chunk ran on the prefetched rows, step i on row i
    for i, o in seen[4:]:
        assert torch.equal(o, prefetched[1]["origins"][i])
    assert not torch.equal(seen[4][1], seen[5][1])
    del one


def test_steady_march_shrink_from_full():
    """Shrink-from-full: the Trainer starts on the full lattice and, once
    complete_frac holds after the warmup, shrinks it to the measured span
    plus the probe's margin; every chunk after the shrink stays complete."""
    cfg = _tiny(max_march_steps=512)
    assert cfg.steady_march_steps == 0 and cfg.steady_march_auto
    tr_ = _trainer(cfg)
    assert tr_.steady_march == 0
    trace = []
    for _ in range(12):
        m = tr_.run_chunk()
        trace.append((tr_.steady_march, m["complete_frac"]))
    lattices = [s for s, _ in trace]
    assert 0 < lattices[-1] < cfg.max_march_steps, trace
    shrunk = lattices.index(lattices[-1])
    assert min(cf for _, cf in trace[shrunk + 1:]) > 0.99, trace


def test_steady_march_explicit_pins_auto_off():
    cfg = _tiny(steady_march_steps=256, **FAST)
    tr_ = _trainer(cfg, steps_per_call=4)
    for _ in range(10):
        tr_.run_chunk()
    assert tr_.steady_march == 256


def test_steady_march_auto_repair_doubles():
    """A steady lattice shorter than the occupied span masks rays for
    good: after 3 incomplete chunks it doubles, up to max_march_steps
    (32 -> 64 -> 128 -> 256 here; the final chunks' completeness is held in
    test_steady_march_shrink_from_full)."""
    cfg = _tiny(steady_march_steps=32, occ_warmup_steps=8, **FAST)
    tr_ = _trainer(cfg, steps_per_call=4)
    seen = []
    with pytest.warns(UserWarning, match="complete_frac"):
        for _ in range(11):
            tr_.run_chunk()
            seen.append(tr_.steady_march)
    assert seen[-1] == 256 and {64, 128} <= set(seen), seen


def test_resume_bit_exact(tmp_path):
    """Kill-and-resume equals the uninterrupted run: state, generator and
    bucket round-trip through the rolling checkpoint."""
    cfg = _tiny(**FAST)
    ckpt = str(tmp_path / "ckpt")
    a = _trainer(cfg, seed=3)
    a.run(24, log_every=0, checkpoint_dir=ckpt, checkpoint_every=16)
    assert a.step == 32 and os.path.exists(os.path.join(ckpt, "state.pt"))

    b = _trainer(cfg, seed=999)                   # the seed is overwritten
    assert b.resume(ckpt) == 32
    assert (b.bucket, b.steady_march) == (a.bucket, a.steady_march)
    b.run(40, log_every=0)

    c = _trainer(cfg, seed=3)
    c.run(40, log_every=0)
    assert b.step == c.step == 48
    pb, pc = _params(b), _params(c)
    for k in pb:
        assert torch.equal(pb[k], pc[k]), k
    for f in ("occs", "binaries"):
        assert torch.equal(getattr(b.state.occ, f), getattr(c.state.occ, f))
    assert torch.equal(b.generator.get_state(), c.generator.get_state())
    assert b.state.scheduler.last_epoch == c.state.scheduler.last_epoch == 48


def test_checkpoint_shape_mismatch_clear_error(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _trainer(_tiny(**FAST)).save(ckpt)
    other = _trainer(_tiny(hash_n_levels=2, **FAST))
    with pytest.raises(ValueError, match="shapes differ") as err:
        other.resume(ckpt)
    assert "hash_encoder" in str(err.value)


def test_hash4d_chunk_runs():
    tr_ = _trainer(_tiny(**FAST), flags=ModelFlags(grid_type="hash4d"),
                   steps_per_call=4)
    m = tr_.run_chunk()
    assert tr_.step == 4 and np.isfinite(m["loss"]), m


def test_device_sampler_on_another_device_raises():
    scene = BallScene(wh=8)
    data, fn = scene.device_sampler(device="cpu")
    with pytest.raises(ValueError, match="Trainer's device"):
        _trainer(_tiny(**FAST), scene=scene,
                 device_sampler=({**data, "K": data["K"].to("meta")}, fn))

