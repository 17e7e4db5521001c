"""The port's 4D keyframe encoder and its table-gradient scatter (K3)
against the JAX package's.

  * K3's plain version (`scatter_add_rows_plain`) against the JAX Pallas
    kernel `scatter_add_rows` run in interpret mode: f32 accumulation,
    collision-heavy rows, unaligned table sizes, bf16 accumulation, and a
    ragged M with rows past the table against `.at[].add`;
  * the time geometry and the keyframe view of the tables against the
    jitted JAX code;
  * 4D `brick_encode` (levels dense and hashed, K = 4) and its gradients
    (every table, x, t) against jax.grad of the JAX `brick_encode` with
    `scatter_impl="pallas"` (a wrapper shows the JAX side reached K3) and
    through XLA autodiff.

Tolerances. K3 in f32: atol 1e-5 (summation order). A bf16 accumulator:
JAX rounds after every add, the port sums in f32 and rounds the finished
sum once (it then equals the f32 sum rounded, bit for bit); the two differ
by at most one bf16 rounding (2^-9 relative) per add, so an entry of c adds
is held to (c + 1) * 2^-9 * sum(|upd|) over its adds. With f32 compute on
both sides the encoder is the same function up to f32 summation order:
rtol 1e-5 with atol 1e-5 of each array's largest entry. In bf16, JAX rounds
the lerp, the lane weights and their products to bf16 and the port keeps
them in f32 (both gather bf16 values and round t_frac to bf16 in the lerp),
so each result is held to 2^-6 of its largest entry, as the 3D encoder
(tests/test_torch_encode_backward.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.ops import brick_grid as jbg
from cednerf_tpu.ops import pallas_scatter as jps
from cednerf_torch.ops import brick_grid as tbg
from cednerf_torch.ops import scatter_kernels as sk

SPEC_KW = dict(n_levels=4, n_features=4, base_res=16, max_res=128,
               log2_hashmap_size=14, max_table_rows=512, time_keyframes=4)
BF16_FRAC = 2.0 ** -6


def _k3_case(seed, n, w, n_rows):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, n).astype(np.int32)
    upd = rng.normal(size=(n, w)).astype(np.float32)
    return rows, upd


def _plain(rows, upd, n_rows):
    return sk.scatter_add_rows(torch.from_numpy(rows), torch.from_numpy(upd),
                               n_rows).numpy()


def test_k3_plain_matches_jax_kernel_f32():
    rows, upd = _k3_case(0, 8192, 256, 512)
    upd[:, 32:] = 0.0                        # zero lanes, as the 4D rows
    want = jps.scatter_add_rows(jnp.asarray(rows), jnp.asarray(upd),
                                n_rows=512, tile=1024, interpret=True)
    got = _plain(rows, upd, 512)
    assert got.dtype == np.float32 and got.shape == (512, 256)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_k3_plain_collision_heavy():
    """Long runs of one row: 64 adds per address, every lane."""
    n, w, n_rows = 4096, 128, 64
    rows = ((np.arange(n) // 64) % n_rows).astype(np.int32)
    upd = np.random.default_rng(1).normal(size=(n, w)).astype(np.float32)
    want = jps.scatter_add_rows(jnp.asarray(rows), jnp.asarray(upd),
                                n_rows=n_rows, tile=512, interpret=True)
    np.testing.assert_allclose(_plain(rows, upd, n_rows), np.asarray(want),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_rows", [339, 4913])
def test_k3_plain_unaligned_table(n_rows):
    """Dense-level sizes that are no multiple of the TPU's 8-row window
    (4913 = 17^3), the last row hit."""
    rows, upd = _k3_case(2, 2048, 64, n_rows)
    rows[-4:] = n_rows - 1
    want = jps.scatter_add_rows(jnp.asarray(rows), jnp.asarray(upd),
                                n_rows=n_rows, tile=512, interpret=True)
    got = _plain(rows, upd, n_rows)
    assert got.shape == (n_rows, 64)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_k3_bf16_accumulator_rounds_once():
    rows, upd = _k3_case(3, 8192, 256, 512)
    want = np.asarray(jps.scatter_add_rows(
        jnp.asarray(rows), jnp.asarray(upd), n_rows=512,
        accum_dtype=jnp.bfloat16, tile=1024, interpret=True), np.float32)
    f32 = sk.scatter_add_rows(torch.from_numpy(rows), torch.from_numpy(upd),
                              512)
    got = f32.to(torch.bfloat16).float().numpy()
    counts = np.bincount(rows, minlength=512)[:, None]
    abs_sum = np.zeros((512, 256), np.float64)
    np.add.at(abs_sum, rows, np.abs(upd))
    assert np.all(np.abs(got - want) <= (counts + 1) * 2.0 ** -9 * abs_sum)
    # and the port's rounding is exactly one, of the f32 sum
    np.testing.assert_array_equal(
        got, jnp.asarray(f32.numpy()).astype(jnp.bfloat16).astype(
            jnp.float32))


def test_k3_plain_ragged_m_drops_rows_past_the_table():
    rows, upd = _k3_case(4, 1003, 96, 200)
    rows[::50] = 200 + np.arange(len(rows[::50])) % 7
    want = jnp.zeros((200, 96), jnp.float32).at[jnp.asarray(rows)].add(
        jnp.asarray(upd))
    np.testing.assert_allclose(_plain(rows, upd, 200), np.asarray(want),
                               rtol=0, atol=1e-5)


def test_k3_plain_takes_bf16_rows():
    rows, upd = _k3_case(5, 777, 256, 864)
    u16 = torch.from_numpy(upd).to(torch.bfloat16)
    got = sk.scatter_add_rows(torch.from_numpy(rows), u16, 864)
    want = jnp.zeros((864, 256), jnp.float32).at[jnp.asarray(rows)].add(
        jnp.asarray(u16.float().numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_k3_plain_adds_into_out():
    """Given `out` (the 4D cell levels' resident buffer), the plain K3 adds
    into it and returns it: out + the rows' sums, rows past the table
    dropped; an out of another shape raises."""
    rows, upd = _k3_case(6, 1003, 32, 200)
    rows[::50] = 200 + np.arange(len(rows[::50])) % 7
    rows[1::50] = -1
    base = np.random.default_rng(7).normal(size=(200, 32)).astype(np.float32)
    out = torch.from_numpy(base.copy())
    got = sk.scatter_add_rows(torch.from_numpy(rows), torch.from_numpy(upd),
                              200, out=out)
    assert got is out
    keep = (rows >= 0) & (rows < 200)
    want = base.astype(np.float64)
    np.add.at(want, rows[keep], upd[keep])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        sk.scatter_add_rows(torch.from_numpy(rows), torch.from_numpy(upd),
                            200, out=torch.zeros((199, 32)))


# --------------------------------------------------------------------- #
# The 4D keyframe encoder


def _times(seed, n):
    """Uniform times with the keyframe boundaries {0, 1/3, 2/3, 1} and
    the f32 neighbours of the inner ones mixed in (not those of 0: XLA's
    CPU flushes subnormal products to zero, PyTorch keeps them)."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 1, n).astype(np.float32)
    inner = np.float32([1 / 3, 2 / 3])
    special = np.concatenate([np.float32([0.0, 1.0]), inner,
                              np.nextafter(inner, np.float32(2)),
                              np.nextafter(inner, np.float32(-2)),
                              np.nextafter(np.float32([1.0]), np.float32(0))])
    t[:n // 4] = np.resize(special, n // 4)
    rng.shuffle(t)
    return t[:, None]


def _positions(seed, scales, n, inside=False):
    """n points: a quarter on cell boundaries of every level (and their f32
    neighbours), the rest uniform in [-0.05, 1.05]^3 (inside=True: all in
    [0, 1]^3, where no level clamps a cell)."""
    rng = np.random.default_rng(seed)
    pts = []
    per = n // (4 * len(scales) * 3)
    for s in scales:
        s32 = np.float32(s)
        k = rng.integers(-1, int(s) + 2, (per, 3)).astype(np.float32)
        xb = ((k - np.float32(0.5)) / s32).astype(np.float32)
        pts += [xb, np.nextafter(xb, np.float32(2)),
                np.nextafter(xb, np.float32(-2))]
    pts = np.concatenate(pts)
    lo, hi = (0.0, 1.0) if inside else (-0.05, 1.05)
    if inside:
        pts = np.clip(pts, 0.0, 1.0)
    rest = rng.uniform(lo, hi, (n - len(pts), 3)).astype(np.float32)
    return np.concatenate([pts, rest]).astype(np.float32)


def test_spec_mixes_dense_and_hashed_levels():
    lay = tbg.BrickGridSpec(**SPEC_KW).level_layout()
    assert [l["hashed"] for l in lay] == [False, True, True, True]
    assert lay == jbg.BrickGridSpec(**SPEC_KW).level_layout()


def test_time_geom_matches_jitted_jax():
    t = _times(0, 4096)

    def jgeom(t):
        ts = t.reshape(-1) * 3
        lo = jnp.clip(jnp.floor(ts), 0, 2).astype(jnp.int32)
        return lo, (ts - lo.astype(ts.dtype)).astype(jnp.float32)

    want = [np.asarray(a) for a in jax.jit(jgeom)(jnp.asarray(t))]
    got = tbg._time_geom(torch.from_numpy(t), 4)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    at_one = t[:, 0] == 1.0
    assert at_one.any() and np.all(got[0].numpy()[at_one] == 2)
    assert np.all(got[1].numpy()[at_one] == 1.0)


def test_keyframe_tables_match_jax_layout():
    spec = tbg.BrickGridSpec(**SPEC_KW)
    k, f = spec.keyframes, spec.n_features
    rng = np.random.default_rng(6)
    params = {name: rng.normal(size=shape).astype(np.float32)
              for name, shape in spec.param_shapes()}
    got = tbg.keyframe_tables({n: torch.from_numpy(v)
                               for n, v in params.items()}, spec)
    for lvl, lay in enumerate(spec.level_layout()):
        if lay["hashed"]:
            want = params[f"bricks_{lvl}"]
        else:     # brick_grid.py's 4D dense-level layout, as JAX builds it
            want = np.asarray(jbg._materialize_dense_bricks(
                jnp.asarray(params[f"grid_{lvl}"]), lay["n_bricks_axis"]))
            nb3 = want.shape[0]
            want = want.reshape(nb3, 64, k, f).transpose(0, 2, 1, 3)
        np.testing.assert_array_equal(got[lvl].numpy(),
                                      want.reshape(-1, 64 * f))


def _case(seed, n, inside=False, **kw):
    spec_kw = {**SPEC_KW, **kw}
    rng = np.random.default_rng(seed)
    tspec = tbg.BrickGridSpec(**spec_kw)
    x = _positions(seed, tspec.level_scales(), n, inside)
    t = _times(seed, n)
    params = {name: rng.uniform(-1, 1, shape).astype(np.float32)
              for name, shape in tspec.param_shapes()}
    g = rng.normal(size=(n, tspec.output_dim)).astype(np.float32)
    return spec_kw, x, t, params, g


def _port(spec_kw, x, t, params, g, dtype):
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    pt = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    out = tbg.brick_encode(xt, pt, tbg.BrickGridSpec(**spec_kw), t=tt,
                           compute_dtype=dtype)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return (out.detach().float().numpy(), xt.grad.numpy(), tt.grad.numpy(),
            {k: v.grad.numpy() for k, v in pt.items()})


def _jax(spec_kw, x, t, params, g, dtype, **kw):
    jspec = jbg.BrickGridSpec(**spec_kw)

    def f(xx, tt, pp):
        out = jbg.brick_encode(xx, pp, jspec, t=tt, compute_dtype=dtype, **kw)
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(x), jnp.asarray(t),
            {k: jnp.asarray(v) for k, v in params.items()})
    gx, gt, gp = grads
    return (np.asarray(out, np.float32), np.asarray(gx), np.asarray(gt),
            {k: np.asarray(v) for k, v in gp.items()})


@pytest.fixture
def k3_calls(monkeypatch):
    """Counts the JAX side's calls of the Pallas K3 (at trace time)."""
    calls = []
    real = jps.scatter_add_rows

    def wrapper(rows, upd, **kw):
        calls.append((rows.shape, upd.shape, kw["n_rows"]))
        return real(rows, upd, **kw)

    monkeypatch.setattr(jps, "scatter_add_rows", wrapper)
    return calls


def _close(got, want, rtol, frac, name):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=frac * np.abs(want).max() + 1e-30,
                               err_msg=name)


@pytest.mark.parametrize("route", ["pallas", "autodiff"])
def test_keyframe_encode_matches_jax_f32(route, k3_calls):
    """Against the Pallas K3 route (points around the cube: the custom VJP
    gates d_x at the edge as the port does) and against XLA autodiff, which
    has no edge gate, on points inside the cube."""
    n = 1024                       # 2N % 2048 == 0: the JAX K3 takes it
    spec_kw, x, t, params, g = _case(1, n, inside=route == "autodiff",
                                     grad_accum_dtype="float32")
    if route == "pallas":
        want = _jax({**spec_kw, "scatter_impl": "pallas"}, x, t, params, g,
                    jnp.float32)
        lay = jbg.BrickGridSpec(**spec_kw).level_layout()
        assert sorted(c[2] for c in k3_calls) == sorted(
            l["rows"] * 4 for l in lay)
        assert all(c[1] == (2 * n, 256) for c in k3_calls)
    else:
        want = _jax(spec_kw, x, t, params, g, jnp.float32,
                    use_custom_vjp=False)
        assert not k3_calls
    got = _port(spec_kw, x, t, params, g, torch.float32)
    _close(got[0], want[0], 1e-5, 1e-5, "out")
    _close(got[1], want[1], 1e-5, 1e-5, "d_x")
    _close(got[2], want[2], 1e-5, 1e-5, "d_t")
    assert set(got[3]) == {"grid_0", "bricks_1", "bricks_2", "bricks_3"}
    for k in want[3]:
        _close(got[3][k], want[3][k], 1e-5, 1e-5, k)


def test_keyframe_encode_matches_jax_bf16(k3_calls):
    """The training dtype: bf16 compute on both sides."""
    spec_kw, x, t, params, g = _case(2, 1024, grad_accum_dtype="float32")
    want = _jax({**spec_kw, "scatter_impl": "pallas"}, x, t, params, g,
                jnp.bfloat16)
    assert len(k3_calls) == 4
    got = _port(spec_kw, x, t, params, g, torch.bfloat16)
    for name, a, b in (("out", got[0], want[0]), ("d_x", got[1], want[1]),
                       ("d_t", got[2], want[2])):
        _close(a, b, 0, BF16_FRAC, name)
    for k in want[3]:
        _close(got[3][k], want[3][k], 0, BF16_FRAC, k)


def test_keyframe_bf16_accumulator_rounds_the_finished_sum_once():
    spec_kw, x, t, params, g = _case(3, 512, grad_accum_dtype="float32")
    g32 = _port(spec_kw, x, t, params, g, torch.bfloat16)[3]
    g16 = _port({**spec_kw, "grad_accum_dtype": "bfloat16"}, x, t, params, g,
                torch.bfloat16)[3]
    for k in ("bricks_2", "bricks_3"):
        want = torch.from_numpy(g32[k]).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(g16[k], want, err_msg=k)


def test_every_scatter_impl_gives_the_same_gradients():
    spec_kw, x, t, params, g = _case(4, 256)
    base = _port(spec_kw, x, t, params, g, torch.bfloat16)
    for impl in ("pallas", "fused", "onehot", "auto"):
        got = _port({**spec_kw, "scatter_impl": impl}, x, t, params, g,
                    torch.bfloat16)
        for k in base[3]:
            np.testing.assert_array_equal(got[3][k], base[3][k])
        np.testing.assert_array_equal(got[1], base[1])


def test_no_grad_forward_matches_and_bad_specs_raise():
    spec_kw, x, t, params, g = _case(5, 300)
    spec = tbg.BrickGridSpec(**spec_kw)
    pt = {k: torch.from_numpy(v) for k, v in params.items()}
    with torch.no_grad():
        out = tbg.brick_encode(torch.from_numpy(x), pt, spec,
                               t=torch.from_numpy(t))
    assert out.dtype == torch.bfloat16 and out.grad_fn is None
    full = _port(spec_kw, x, t, params, g, torch.bfloat16)[0]
    np.testing.assert_array_equal(out.float().numpy(), full)
    with pytest.raises(ValueError, match="needs t"):
        tbg.brick_encode(torch.from_numpy(x), pt, spec)
    # the cell layout (which raised until it was ported) forwards the same
    with torch.no_grad():
        cell = tbg.brick_encode(torch.from_numpy(x), pt,
                                dataclasses.replace(spec, row_layout="cell"),
                                t=torch.from_numpy(t))
    np.testing.assert_array_equal(cell.float().numpy(), full)


def test_k3_reaches_the_4d_backward_once_per_level(monkeypatch):
    calls = []
    real = sk.scatter_add_rows

    def wrapper(rows, upd, n_rows):
        calls.append((tuple(rows.shape), tuple(upd.shape), upd.dtype, n_rows))
        return real(rows, upd, n_rows)

    monkeypatch.setattr(sk, "scatter_add_rows", wrapper)
    spec_kw, x, t, params, g = _case(6, 200)
    _port(spec_kw, x, t, params, g, torch.bfloat16)
    lay = tbg.BrickGridSpec(**spec_kw).level_layout()
    # autograd runs the levels' backwards last level first
    assert calls == [((400,), (400, 256), torch.float32, l["rows"] * 4)
                     for l in reversed(lay)]

