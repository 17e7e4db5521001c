"""The stable key-width sort in front of the ordered reduce, and the 4D
brick levels' corner entries that K3 now takes.

  * key_sort_plain (csrc/key_sort.cuh pass by pass: per-block digit
    counts, their digit-major scan, ranks within a block) gives
    torch.sort(stable=True)'s permutation and sorted keys bit for bit,
    with keys outside [0, n_keys) mapped to the drop value n_keys: M from
    0 to a few thousand (not a multiple of any block), 1-31 key bits,
    equal, sorted and reversed keys, negative keys, keys >= n_keys and
    INT_MAX; its plan (bits, passes, digit bits); the wrapper on CPU
    tensors is the plain version;
  * the 4D brick level's corner entries ([2N*8, F] at key keyframe row *
    64 + corner) sum to the same table gradient as the [2N, 64F] update
    rows they replace, through K3's plain version, bit for bit (adding
    the rows' zero lanes never changes an f32 sum); with many samples in
    one brick, whose corners' runs cross tiles of NARROW_TILE sorted
    entries, the kernel's two-level order (tiles in sorted order, the
    crossing runs' partials added in tile order by carry_plain) stays
    within 1e-6 of the strict order's largest entry;
  * the 4D encoder on samples that all lie in one level-0 brick against
    the JAX package (f32, the Pallas K3 route in interpret mode), at the
    tolerances of tests/test_torch_keyframe_encoder.py (rtol 1e-5 and 1e-5
    of each array's largest entry).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from cednerf_tpu.ops import brick_grid as jbg
from cednerf_torch.ops import brick_grid as tbg
from cednerf_torch.ops import scatter_kernels as sk

INT_MAX = 2 ** 31 - 1
INT_MIN = -2 ** 31


def _reference(keys, n_keys):
    k = keys.long()
    k = torch.where((k >= 0) & (k < n_keys), k, n_keys)
    s, p = torch.sort(k, stable=True)
    return s.to(torch.int32), p.to(torch.int32)


def _check(keys, n_keys):
    keys = torch.from_numpy(np.array(keys, np.int64)).to(torch.int32)
    got = sk.key_sort_plain(keys, n_keys)
    want = _reference(keys, n_keys)
    assert got[0].dtype == got[1].dtype == torch.int32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n_keys,plan", [
    (1, (1, 1, 1)), (2, (2, 1, 2)), (255, (8, 1, 8)), (256, (9, 2, 5)),
    (82_976, (17, 3, 6)), (3_145_728, (22, 3, 8)), (4_194_304, (23, 3, 8)),
    (2 ** 24, (25, 4, 7)), (INT_MAX, (31, 4, 8))])
def test_sort_plan(n_keys, plan):
    """bits = bit_length(n_keys) (the drop value n_keys included), 8-bit
    passes at most, the digit split evenly over them."""
    assert sk.sort_plan(n_keys) == plan


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(m=st.integers(0, 3000), bits=st.integers(1, 31),
       seed=st.integers(0, 2 ** 32 - 1), out_frac=st.floats(0.0, 0.3))
def test_key_sort_plain_matches_torch_sort(m, bits, seed, out_frac):
    """Random keys of `bits` bits (n_keys from 2^(bits-1) to 2^bits - 1),
    a share of them outside [0, n_keys): negative, >= n_keys, INT_MIN and
    INT_MAX; few distinct keys where n_keys is small."""
    rng = np.random.default_rng(seed)
    n_keys = int(rng.integers(2 ** (bits - 1), 2 ** bits))
    keys = rng.integers(0, n_keys, m)
    out = rng.random(m) < out_frac
    keys[out] = rng.choice([-1, -7, n_keys, n_keys + 5, INT_MAX, INT_MIN],
                           int(out.sum()))
    _check(keys, n_keys)


@pytest.mark.parametrize("case", ["all equal", "sorted", "reversed",
                                  "all dropped", "three blocks",
                                  "one key", "block edge"])
def test_key_sort_plain_special_keys(case):
    """All-equal keys (one run through every block), already sorted and
    reversed keys, every key dropped, M over several sort blocks and not a
    multiple of one, n_keys = 1, and M one past a block."""
    rng = np.random.default_rng(5)
    n_keys, m = 1000, 2 * sk.SORT_BLOCK_KEYS + 77
    keys = {
        "all equal": np.full(m, 17),
        "sorted": np.sort(rng.integers(0, n_keys, m)),
        "reversed": np.sort(rng.integers(0, n_keys, m))[::-1],
        "all dropped": rng.choice([-3, n_keys, INT_MAX], m),
        "three blocks": rng.integers(-2, n_keys + 2, m),
        "one key": rng.integers(-1, 2, m),
        "block edge": rng.integers(0, 3, sk.SORT_BLOCK_KEYS + 1),
    }[case]
    _check(keys, 1 if case == "one key" else n_keys)


def test_key_sort_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(2)
    keys = torch.from_numpy(rng.integers(-5, 300, 5000).astype(np.int32))
    sk.reset_counts()
    got = sk.key_sort(keys, 256)
    want = sk.key_sort_plain(keys, 256)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert sk.launches["key_sort"] == 0
    assert sk.plain_cuda_calls["key_sort"] == 0


def _level_terms(seed, n, n_keyrows, f, one_brick):
    """A 4D brick level's backward inputs as _KeyframeLevelEncode forms
    them: lo_row [N] (brick row * K + keyframe lo), the cell's 8 corners
    [N, 8], the terms w * g [N, 8, F] and t_frac [N]. one_brick: 90% of
    the samples in brick row 0's keyframe 1."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, n_keyrows - 1, n)
    if one_brick:
        lo[rng.random(n) < 0.9] = 1
    intra = rng.integers(0, 3, (n, 3))
    b = np.array([[j >> 2, (j >> 1) & 1, j & 1] for j in range(8)])
    corner = ((intra[:, None, :] + b) * [16, 4, 1]).sum(-1)
    upd = rng.normal(size=(n, 8, f)).astype(np.float32)
    tf = rng.random(n).astype(np.float32)
    return (torch.from_numpy(lo), torch.from_numpy(corner),
            torch.from_numpy(upd), torch.from_numpy(tf)[:, None, None])


def _rows_form(lo, corner, upd, tf, n_keyrows):
    """The [2N, 64F] update rows that the 4D brick levels handed K3 before
    (a zero fill and a scatter_ of the 8 live corners)."""
    n, _, f = upd.shape
    buf = torch.zeros((2, n, 64, f))
    at = corner[:, :, None].expand(n, 8, f)
    buf[0].scatter_(1, at, upd * (1.0 - tf))
    buf[1].scatter_(1, at, upd * tf)
    rows = torch.cat([lo, lo + 1]).to(torch.int32)
    return sk.scatter_add_rows_plain(rows, buf.view(2 * n, 64 * f),
                                     n_keyrows)


def _corner_form(lo, corner, upd, tf):
    """The corner entries as ops/brick_grid.py forms them: (keys [2N*8]
    int32, terms [2N*8, F])."""
    n, _, f = upd.shape
    key = lo[:, None] * 64 + corner
    keys = torch.cat([key, key + 64]).reshape(-1).to(torch.int32)
    return keys, torch.cat([upd * (1.0 - tf), upd * tf]).view(2 * n * 8, f)


@pytest.mark.parametrize("one_brick", [False, True])
@pytest.mark.parametrize("f", [4, 2])
def test_corner_entries_equal_the_rows_form(one_brick, f):
    n, n_keyrows = 3001, 40 * 4
    lo, corner, upd, tf = _level_terms(3, n, n_keyrows, f, one_brick)
    want = _rows_form(lo, corner, upd, tf, n_keyrows)
    keys, terms = _corner_form(lo, corner, upd, tf)
    got = sk.scatter_add_rows(keys, terms, n_keyrows * 64).view(
        n_keyrows, 64 * f)
    assert torch.equal(got, want)


def _two_level(keys, terms, n_keys, tile):
    """K3's reduce and carry, emulated on the plain pieces: the entries in
    key_sort_plain's order, cut into tiles of `tile`; a run inside a tile
    summed in sorted order into its row; a run that crosses a tile edge
    leaves its tiles' partials (the first tile's tail, the later tiles'
    heads), which carry_plain adds in tile order. Returns (the sums, the
    keys whose runs cross)."""
    sk_keys, perm = sk.key_sort_plain(keys, n_keys)
    k, t = sk_keys.long(), terms[perm.long()]
    e, w = k.numel(), terms.shape[1]
    tiles = -(-e // tile)
    out = torch.zeros((n_keys, w))
    part = torch.zeros((2, tiles, w))
    for ti in range(tiles):
        s, end = ti * tile, min(ti * tile + tile, e)
        seg = k[s:end]
        first = torch.ones_like(seg, dtype=torch.bool)
        first[1:] = seg[1:] != seg[:-1]
        starts = torch.nonzero(first)[:, 0].tolist() + [end - s]
        for a, b in zip(starts[:-1], starts[1:]):
            key = int(seg[a])
            if key >= n_keys:
                continue
            acc = torch.zeros(w)
            for i in range(s + a, s + b):
                acc = acc + t[i]
            head = a == 0 and s > 0 and int(k[s - 1]) == key
            tail = b == end - s and end < e and int(k[end]) == key
            if head:
                part[0, ti] = acc
            elif tail:
                part[1, ti] = acc
            else:
                out[key] = acc
    chained, sums = sk.carry_plain(sk_keys, part, tile, n_keys)
    out[chained] = sums
    return out, chained


def test_corner_runs_cross_tiles_in_two_levels():
    """Many samples in one brick: corner runs of hundreds of entries cross
    the tiles of NARROW_TILE sorted entries that K3 cuts narrow rows into;
    the two-level sum stays within 1e-6 of the strict order's largest
    entry and equals it exactly on every key whose run lies in one tile."""
    n, n_keyrows, f = 2000, 12, 4
    lo, corner, upd, tf = _level_terms(4, n, n_keyrows, f, True)
    keys, terms = _corner_form(lo, corner, upd, tf)
    n_keys = n_keyrows * 64
    strict = sk.scatter_add_rows(keys, terms, n_keys)
    got, chained = _two_level(keys, terms, n_keys, sk.NARROW_TILE)
    assert chained.numel() > 0
    scale = strict.abs().max()
    assert (got - strict).abs().max() <= 1e-6 * scale
    single = torch.ones(n_keys, dtype=torch.bool)
    single[chained] = False
    assert torch.equal(got[single], strict[single])


def test_keyframe_encode_one_brick_matches_jax():
    """The 4D encoder (f32) with every sample in one level-0 brick: long
    runs on every corner of level 0, against jax.grad of the JAX encoder
    on its Pallas K3 route."""
    from test_torch_keyframe_encoder import SPEC_KW, _close, _jax, _port

    n = 1024                       # 2N % 2048 == 0: the JAX K3 takes it
    spec_kw = dict(SPEC_KW, grad_accum_dtype="float32")
    rng = np.random.default_rng(11)
    scale0 = float(tbg.BrickGridSpec(**spec_kw).level_scales()[0])
    # pos = x * scale + 0.5 in [3.01, 5.99): brick 1 of level 0, each axis
    x = ((3.01 + rng.random((n, 3)) * 2.98 - 0.5) / scale0).astype(
        np.float32)
    t = rng.uniform(0.05, 0.95, (n, 1)).astype(np.float32)
    params = {name: rng.uniform(-1, 1, shape).astype(np.float32)
              for name, shape in tbg.BrickGridSpec(**spec_kw).param_shapes()}
    g = rng.normal(size=(n, tbg.BrickGridSpec(**spec_kw).output_dim)).astype(
        np.float32)
    rows0 = tbg._level_geom(torch.from_numpy(x), scale0, jbg.BrickGridSpec(
        **spec_kw).level_layout()[0]["n_bricks_axis"], False, 1 << 30)[0]
    assert rows0.unique().numel() == 1
    want = _jax({**spec_kw, "scatter_impl": "pallas"}, x, t, params, g,
                jnp.float32)
    got = _port(spec_kw, x, t, params, g, torch.float32)
    for name, a, b in (("out", got[0], want[0]), ("d_x", got[1], want[1]),
                       ("d_t", got[2], want[2])):
        _close(a, b, 1e-5, 1e-5, name)
    for k in want[3]:
        _close(got[3][k], want[3][k], 1e-5, 1e-5, k)
