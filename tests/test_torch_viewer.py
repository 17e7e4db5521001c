"""The port's ViewerServer on the CPU: page, /snap, and /render replying with
a PNG written by the standard library (as tests/test_viewer.py does for the
JAX server's JPEG)."""

import dataclasses
import http.client
import json

import numpy as np
import torch

from cednerf_torch.engine.config import dnerf_config, hypernerf_config
from cednerf_torch.engine.renderer import LatticeEvalRenderer
from cednerf_torch.models.field import DNGPRadianceField
from cednerf_torch.ops.occupancy import create_occ_grid
from cednerf_torch.utils.image import PNG_SIGNATURE, decode_png, encode_png
from cednerf_torch.viewer import ViewerServer


def test_png_round_trip():
    img = np.random.default_rng(0).integers(0, 256, (7, 5, 3), np.uint8)
    data = encode_png(img)
    assert data[:8] == PNG_SIGNATURE
    np.testing.assert_array_equal(decode_png(data), img)


def test_viewer_render_roundtrip():
    cfg = dataclasses.replace(dnerf_config(max_steps=10), grid_resolution=16,
                              render_step_size=5e-2, max_march_steps=32)
    field = DNGPRadianceField(aabb=cfg.aabb, n_levels=2, dst_resolution=32,
                              base_resolution=8, log2_hashmap_size=10)
    field.reset_parameters(torch.Generator().manual_seed(0))
    occ = create_occ_grid(cfg.aabb, cfg.grid_resolution, cfg.grid_nlvl,
                          device="cpu")
    occ = occ._replace(binaries=torch.ones_like(occ.binaries))

    server = ViewerServer(field, occ, cfg, wh=(32, 32))
    httpd = server.start(port=0, host="127.0.0.1")
    port = httpd.server_address[1]
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("GET", "/")
        assert b"cednerf_torch viewer" in conn.getresponse().read()

        c2w = np.zeros((3, 4), np.float32)
        c2w[:, :3] = np.eye(3)
        c2w[2, 3] = 4.0
        for depth in (False, True):
            body = json.dumps({
                "c2w": c2w.reshape(-1).tolist(), "time": 0.5, "width": 24,
                "max_samples": 32, "depth": depth})
            conn.request("POST", "/render", body=body)
            resp = conn.getresponse()
            data = resp.read()
            assert resp.status == 200
            assert resp.getheader("Content-Type") == "image/png"
            assert decode_png(data).shape == (24, 24, 3)
            assert server.last_frame["finite"]
            assert server.last_frame["passes_per_chunk"]

        conn.request("GET", "/snap")
        assert "radius" in json.loads(conn.getresponse().read())
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_viewer_cone_angle_roundtrip():
    """A cone-angle config (the HyperNeRF preset, 2 grid levels, shrunken)
    is served through the lattice marcher, on the server's default black
    background (the JAX ViewerServer's, for every family)."""
    cfg = dataclasses.replace(hypernerf_config("vrig_broom", max_steps=10),
                              grid_resolution=8, render_step_size=1e-2,
                              max_march_steps=128)
    field = DNGPRadianceField(aabb=(-2, -2, -2, 2, 2, 2), n_levels=2,
                              dst_resolution=32, base_resolution=8,
                              log2_hashmap_size=10)
    field.reset_parameters(torch.Generator().manual_seed(0))
    occ = create_occ_grid(cfg.aabb, cfg.grid_resolution, cfg.grid_nlvl,
                          device="cpu")
    occ = occ._replace(binaries=torch.ones_like(occ.binaries))
    server = ViewerServer(field, occ, cfg, wh=(16, 16))
    np.testing.assert_array_equal(server.render_bkgd, np.zeros(3))
    httpd = server.start(port=0, host="127.0.0.1")
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1],
                                          timeout=120)
        c2w = np.zeros((3, 4), np.float32)
        c2w[:, :3] = np.eye(3)
        c2w[2, 3] = 3.0
        conn.request("POST", "/render", body=json.dumps({
            "c2w": c2w.reshape(-1).tolist(), "time": 0.5, "width": 16,
            "max_samples": 32, "depth": False}))
        resp = conn.getresponse()
        data = resp.read()
        assert resp.status == 200
        assert decode_png(data).shape == (16, 16, 3)
        assert server.last_frame["finite"]
        assert server.last_frame["passes_per_chunk"] == [[1]]
        assert isinstance(server._render_fns[32], LatticeEvalRenderer)
    finally:
        httpd.shutdown()
        httpd.server_close()
