"""What decides `correct`, on the CPU at a tiny size: the program's outputs
agree with the plain reference within the cell's limits; the control (the
reference on float8 MLPs in the program's place) and each fault that a cell
can have, planted under a run of the driver, make `correct` false.

Faults: a served frame left as it was (the last one sent again), which
stands for a state left unchanged; half of a frame left out; a frame
altered where it is produced. One card has no exchange between cards to
leave out.

The control at a cell's own size runs on the card (marked gpu)."""

import numpy as np
import pytest
import torch

from nerfbench import run as harness
from nerfbench.core import card, spec
from nerfbench.tests.tiny import VIEW, tiny_cell

SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def no_card(monkeypatch):
    """The harness's look for a card and its device line, skipped."""
    monkeypatch.setattr(card, "device", lambda count, peak, **kw: {
        "platform": "cpu", "kind": "cpu", "count": count,
        "memory_peak_bytes": peak, **kw})


def _result(name, seconds=0.01):
    cell = tiny_cell(name)
    out = spec.driver(cell).run(cell, SEED, seconds, False, 0.0,
                                device="cpu")
    return harness.result_line(cell, out, False, {})


@pytest.mark.parametrize("name", VIEW)
def test_sound_run_is_correct(name):
    res = _result(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("name", VIEW)
def test_control_fails(name):
    cell = tiny_cell(name)
    r = spec.driver(cell).readings(cell, SEED, device="cpu")
    limits = cell.workload["limits"]
    assert any(r["control"][k] > v for k, v in limits.items()), r
    assert all(r["program"][k] <= v for k, v in limits.items()), r


@pytest.mark.parametrize("name", VIEW)
def test_stale_frame_fails(name, monkeypatch):
    from cednerf_torch.viewer import server

    render = server.ViewerServer.render_frame
    kept = {}

    def stale(self, *args, **kwargs):
        img = render(self, *args, **kwargs)
        return kept.setdefault("frame", img)

    monkeypatch.setattr(server.ViewerServer, "render_frame", stale)
    assert not _result(name)["correct"]


@pytest.mark.parametrize("name", VIEW)
def test_half_frame_fails(name, monkeypatch):
    from cednerf_torch.viewer import server

    render = server.render_image

    def half(field, occ, fn, origins, viewdirs, *args, **kwargs):
        rgb, opac, depth = render(field, occ, fn, origins, viewdirs, *args,
                                  **kwargs)
        rgb[rgb.shape[0] // 2:] = 0.0
        return rgb, opac, depth

    monkeypatch.setattr(server, "render_image", half)
    assert not _result(name)["correct"]


@pytest.mark.parametrize("name", VIEW)
def test_altered_frame_fails(name, monkeypatch):
    from cednerf_torch.viewer import server

    render = server.ViewerServer.render_frame

    def altered(self, *args, **kwargs):
        img = render(self, *args, **kwargs).copy()
        img[..., 0] = np.minimum(img[..., 0].astype(np.int16) + 16,
                                 255).astype(np.uint8)
        return img

    monkeypatch.setattr(server.ViewerServer, "render_frame", altered)
    assert not _result(name)["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", VIEW)
def test_control_fails_at_full_size(name):
    """The control on the card at the cell's own size, three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load_cell(name)
    limits = cell.workload["limits"]
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        r = spec.driver(cell).readings(cell, seed)
        assert any(r["control"][k] > v for k, v in limits.items()), r
        assert all(r["program"][k] <= v for k, v in limits.items()), r
