"""K8 (`row_gather`) of the port against the JAX package's row gather, and
the gather probe tool on the CPU.

  * the plain version bit for bit against the Pallas `_gather_kernel` of
    cednerf_tpu/ops/pallas_gather.py, run through the same pl.pallas_call
    as `dma_gather` (which has no interpret switch) with interpret=True,
    and against jnp.take: bf16 and f32 tables, W 128 and 256 and widths
    whose rows are not a multiple of 16 bytes, a ragged N (the JAX side's
    index is padded to its tile and its output cut back);
  * an index outside [0, R) gives a row of zeros (the port's definition;
    the TPU kernel leaves it undefined), on the port side only;
  * cednerf_torch.tools.profile_row_gather.run on the CPU.

A gather moves bytes and computes nothing, so every comparison is exact,
on the bits (a NaN would not compare equal as a value).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cednerf_tpu.ops.pallas_gather import _gather_kernel
from cednerf_torch.ops import gather_kernels as gk
from cednerf_torch.tools import profile_row_gather as prg

R, N, TILE, DEPTH = 1000, 1000, 256, 4


def _jax_gather(table, idx):
    """dma_gather's pallas_call (pallas_gather.py:65-76) in interpret mode;
    idx padded with row 0 to a multiple of TILE."""
    n, w = idx.shape[0], table.shape[1]
    pad = -n % TILE
    idx = jnp.concatenate([idx, jnp.zeros((pad,), jnp.int32)])
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=((n + pad) // TILE,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((TILE, w), lambda i, idx_ref: (i, 0)),
        scratch_shapes=[pltpu.SemaphoreType.DMA((DEPTH,))])
    out = pl.pallas_call(
        functools.partial(_gather_kernel, tile=TILE, depth=DEPTH),
        out_shape=jax.ShapeDtypeStruct((n + pad, w), table.dtype),
        grid_spec=spec, interpret=True)(idx, table)
    return out[:n]


def _bits(a):
    """numpy bits of a JAX or torch array of 2- or 4-byte floats."""
    if isinstance(a, torch.Tensor):
        return a.view({2: torch.int16, 4: torch.int32}[a.element_size()]
                      ).numpy()
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


@pytest.mark.parametrize("dtype,w", [
    ("bfloat16", 128), ("bfloat16", 256), ("bfloat16", 100),
    ("float32", 128), ("float32", 37)])
def test_k8_plain_matches_jax_gather_bit_for_bit(dtype, w):
    rng = np.random.default_rng(w)
    vals = rng.normal(size=(R, w)).astype(np.float32)
    idx = rng.integers(0, R, N).astype(np.int32)
    table_j = jnp.asarray(vals).astype(jnp.dtype(dtype))
    table_t = torch.from_numpy(vals).to(getattr(torch, dtype))
    np.testing.assert_array_equal(_bits(table_t), _bits(table_j))
    got = gk.row_gather(table_t, torch.from_numpy(idx))
    assert got.dtype == table_t.dtype and got.shape == (N, w)
    want_k = _jax_gather(table_j, jnp.asarray(idx))
    want_t = jnp.take(table_j, jnp.asarray(idx), axis=0)
    np.testing.assert_array_equal(_bits(got), _bits(want_k))
    np.testing.assert_array_equal(_bits(got), _bits(want_t))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k8_out_of_range_rows_are_zero(dtype):
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.normal(size=(R, 136)).astype(
        np.float32)).to(getattr(torch, dtype))
    idx = torch.from_numpy(rng.integers(0, R, 777).astype(np.int32))
    bad = torch.tensor([-1, -5, R, R + 7, 2 ** 31 - 1, -2 ** 31],
                       dtype=torch.int32)
    idx[::100] = bad.repeat(2)[:idx[::100].shape[0]]
    out = gk.row_gather(table, idx, rows_in_flight=8)
    ok = (idx >= 0) & (idx < R)
    assert (~ok).sum() == 8
    assert (_bits(out[~ok]) == 0).all()
    np.testing.assert_array_equal(_bits(out[ok]),
                                  _bits(table[idx[ok].long()]))
    empty = gk.row_gather(table[:0], idx)
    assert empty.shape == (777, 136) and (_bits(empty) == 0).all()


def test_profile_row_gather_runs_on_cpu():
    res = prg.run(rows=R, n=517, widths=(128, 100), iters=0, device="cpu",
                  seed=2)
    assert res["all_match"] and res["device"] == "cpu"
    assert [r["w"] for r in res["widths"]] == [128, 100]
    for rec in res["widths"]:
        assert rec["index_select_ms"] is None
        assert [s["rows_in_flight"] for s in rec["settings"]] == list(
            gk.ROWS_IN_FLIGHT)
        assert all(s["match"] and s["ms"] is None for s in rec["settings"])
