"""nerfvis scene export of the port — its copy of the JAX package's vis.py
(the reference's vis.py dev tool) plus `make_eval_fn`, the eval_fn adapter
from the port's field.

Wraps nerfvis.Scene when the package is available: volume preview of the
radiance field at a fixed time, camera frusta, and AABB wireframes
(reference vis.py:13-127). nerfvis is optional and not installed with the
port; NerfvisCallback raises a clear ImportError without it, and
make_eval_fn needs only torch:

    from cednerf_torch.vis import NerfvisCallback, make_eval_fn
    NerfvisCallback("scene").render_nerf(cfg.aabb,
                                         make_eval_fn(field, 0.5, "cuda"))
"""

from typing import Sequence

import numpy as np
import torch


def make_eval_fn(field, timestamp: float, device="cuda", chunk: int = 1 << 18):
    """eval_fn(points [N, 3], dirs [N, 3]) -> (sigma [N, 1], rgb [N, 3]),
    numpy in and out, of `field` (a DNGPRadianceField of the port, on
    `device`) at scene time `timestamp`: the field's forward (rgb, and the
    density of its sigma results) in chunks of `chunk` points, without
    gradients."""
    dev = torch.device(device)

    @torch.inference_mode()
    def eval_fn(points, dirs):
        x = torch.as_tensor(np.asarray(points, np.float32), device=dev)
        d = torch.as_tensor(np.asarray(dirs, np.float32), device=dev)
        sig, rgb = [], []
        for i in range(0, x.shape[0], chunk):
            xc = x[i:i + chunk]
            t = torch.full((xc.shape[0], 1), float(timestamp), device=dev)
            c, res = field(xc, t, d[i:i + chunk])
            sig.append(res["density"].float().reshape(-1, 1))
            rgb.append(c.float())
        return (torch.cat(sig).cpu().numpy(), torch.cat(rgb).cpu().numpy())

    return eval_fn


def _require_nerfvis():
    try:
        import nerfvis  # type: ignore

        return nerfvis
    except ImportError as e:
        raise ImportError(
            "nerfvis is not installed in this environment; "
            "`pip install nerfvis` to use the scene exporter."
        ) from e


class NerfvisCallback:
    """Volume + camera + box visualization served over HTTP (vis.py:5-127)."""

    def __init__(self, title: str = "cednerf_torch"):
        nerfvis = _require_nerfvis()
        self.scene = nerfvis.Scene(title)

    def render_nerf(self, aabb, eval_fn, reso: int = 128, port: int = 8889):
        """eval_fn(points [N,3], dirs [N,3]) -> (sigma [N,1], rgb [N,3])."""
        aabb = np.asarray(aabb, np.float32)
        center = (aabb[:3] + aabb[3:]) / 2
        radius = float((aabb[3:] - aabb[:3]).max() / 2)
        self.scene.set_nerf(eval_fn, center=center.tolist(), radius=radius,
                            use_dirs=True, reso=reso)
        self.scene.display(port=port)

    def add_camera_frustum(self, name: str, focal: float, image_width: int,
                           image_height: int, z: float, c2w: np.ndarray,
                           color: Sequence[float] = (0.0, 0.0, 1.0)):
        self.scene.add_camera_frustum(
            name, focal_length=focal, image_width=image_width,
            image_height=image_height, z=z, r=c2w[:, :3, :3], t=c2w[:, :3, 3],
            color=list(color),
        )

    def add_boxes(self, aabbs: np.ndarray, name: str = "aabb"):
        """Wireframe boxes for occupancy-grid levels (vis.py:66-127)."""
        for i, aabb in enumerate(np.asarray(aabbs).reshape(-1, 6)):
            mn, mx = aabb[:3], aabb[3:]
            corners = np.array([
                [mn[0], mn[1], mn[2]], [mx[0], mn[1], mn[2]],
                [mx[0], mx[1], mn[2]], [mn[0], mx[1], mn[2]],
                [mn[0], mn[1], mx[2]], [mx[0], mn[1], mx[2]],
                [mx[0], mx[1], mx[2]], [mn[0], mx[1], mx[2]],
            ])
            segs = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
                    (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
            lines = np.stack([np.stack([corners[a], corners[b]]) for a, b in segs])
            self.scene.add_lines(f"{name}_{i}", lines.reshape(-1, 3),
                                 segs=np.arange(len(segs) * 2).reshape(-1, 2))

    def display(self, port: int = 8889):
        self.scene.display(port=port)
