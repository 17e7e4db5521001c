"""Measurement helpers of the port that need no card.

  * bench.calls_seen counts the device records (kernels, copies, memsets)
    among profiler key_averages() rows: a window of reps calls that kept
    every record reads reps, one where the profiler dropped records reads
    less; operator rows (CPU), annotations ("#" in the name) and rows
    without device time do not count. The rows here are fabricated, as
    key_averages() gives them.
  * chip_smoke._sort_bytes, the traffic of csrc/key_sort.cuh that phase
    8b's and the ordered reduces' design bounds rest on: 16 B a key a pass
    and the status words of each tile's digits.
  * chip_smoke._fresh_process_phase leaves no work directory behind (its
    inputs file holds the saved keys), also when the child fails, as it
    does here without a card.
"""

import tempfile
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from cednerf_torch.ops import scatter_kernels as sk
from cednerf_torch.utils import bench

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _row(key, count, device_us, device_type=CUDA):
    return SimpleNamespace(key=key, count=count, device_type=device_type,
                           self_device_time_total=device_us)


def _sort_rows(calls):
    """One key_sort call's records times `calls`, with the rows around them
    that are not device records."""
    return [_row("void keysort::pass_kernel<true, false>(...)", 2 * calls,
                 40.0 * calls),
            _row("keysort::histogram_kernel(...)", calls, 9.0 * calls),
            _row("Memset (Device)", calls, 1.5 * calls),
            _row("aten::empty", 3 * calls, 0.0, CPU),
            _row("aten::sort", calls, 50.0 * calls, CPU),
            _row("Optimizer.step#Adam.step", 1, 70.0),
            _row("void idle_kernel()", calls, 0.0)]


@pytest.mark.parametrize("kept,reps", [(5, 5), (3, 5), (0, 5), (20, 20),
                                       (19, 20)])
def test_calls_seen_counts_the_device_records(kept, reps):
    """A full window (kept == reps) reads reps; a window that lost calls'
    records reads the calls it kept."""
    assert bench.calls_seen(_sort_rows(kept), _sort_rows(1)) == kept


def test_calls_seen_of_a_partial_call():
    """Records dropped inside a call: the share of one call's records."""
    window = _sort_rows(5)
    window[0].count -= 1              # one pass kernel of 20 records lost
    assert bench.calls_seen(window, _sort_rows(1)) == pytest.approx(4.75)


def test_calls_seen_without_device_records():
    assert bench.calls_seen(_sort_rows(5), [_row("aten::sort", 1, 0.0,
                                                 CPU)]) == 0.0


@pytest.mark.parametrize("m,n_keys,want", [
    # K6's keys of a train step: 17 bits, 2 passes of 9, 128 tiles
    (2_097_152, 82_976, 16 * 2_097_152 * 2 + 16 * 2 * 128 * 512),
    # the tri-plane's texels: 22 bits, 3 passes of 8, 1,536 tiles
    (25_165_824, 3_145_728, 16 * 25_165_824 * 3 + 16 * 3 * 1536 * 256),
    # one pass: the keys read twice, keys and perm written; one tile
    (1000, 300, 16 * 1000 + 16 * 1 * 512),
    (16_385, 2 ** 31 - 1, 16 * 16_385 * 4 + 16 * 4 * 2 * 256)])
def test_sort_bytes(m, n_keys, want):
    assert chip_smoke._sort_bytes(m, n_keys) == want
    assert chip_smoke._ordered_bytes(m, n_keys) == want + 12 * m
    assert chip_smoke._ordered_bytes(m, n_keys, False) == want + 8 * m
    assert sk.SORT_TILE_KEYS == 16_384


def test_fresh_process_phase_removes_its_work_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    keys = {"k": (torch.arange(8, dtype=torch.int32), 8)}
    with pytest.raises(AssertionError, match="--sort_phase exited"):
        chip_smoke._fresh_process_phase("--sort_phase", 0, keys)
    assert list(tmp_path.iterdir()) == []
