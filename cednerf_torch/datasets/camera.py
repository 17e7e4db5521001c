"""General camera model with radial/tangential distortion (HyperNeRF-style).

The port's copy of cednerf_tpu/datasets/camera.py (host-side numpy,
unchanged), held against the original by tests/test_torch_datasets.py.

Fresh numpy implementation of the camera semantics the reference vendors from
google/hypernerf (reference: datasets/hyper_cam.py:92-403): orientation is the
world-to-camera rotation, rays are y-down/z-forward in local coordinates, and
pixel -> ray undistortion solves the forward distortion model with Newton
iterations.
"""

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np


def _distort(x, y, k1, k2, k3, p1, p2):
    """Forward distortion model: ideal (x, y) -> distorted (xd, yd)."""
    r2 = x * x + y * y
    d = 1.0 + r2 * (k1 + r2 * (k2 + k3 * r2))
    xd = d * x + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = d * y + 2 * p2 * x * y + p1 * (r2 + 2 * y * y)
    return xd, yd


def radial_and_tangential_undistort(xd, yd, k1=0.0, k2=0.0, k3=0.0, p1=0.0, p2=0.0,
                                    eps: float = 1e-9, max_iterations: int = 10):
    """Invert the distortion model with Newton's method (hyper_cam.py:22-89).

    Unlike the reference (which indents the update outside the loop and so
    effectively performs a single Newton step — hyper_cam.py / the torch copy
    at hypernerf.py:66-82 share the bug upstream fixed), we update inside the
    loop for full convergence.
    """
    x = np.array(xd, np.float64)
    y = np.array(yd, np.float64)
    for _ in range(max_iterations):
        fxd, fyd = _distort(x, y, k1, k2, k3, p1, p2)
        fx = fxd - xd
        fy = fyd - yd
        r2 = x * x + y * y
        d = 1.0 + r2 * (k1 + r2 * (k2 + k3 * r2))
        d_r = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)
        d_x = 2.0 * x * d_r
        d_y = 2.0 * y * d_r
        fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
        fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
        fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
        fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
        # Newton update: [x, y] -= J^-1 [fx, fy]; written with the
        # negated-determinant denominator (so the steps are *added*)
        denom = fy_x * fx_y - fx_x * fy_y
        safe = np.abs(denom) > eps
        x = x + np.where(safe, (fx * fy_y - fy * fx_y) / np.where(safe, denom, 1.0), 0.0)
        y = y + np.where(safe, (fy * fx_x - fx * fy_x) / np.where(safe, denom, 1.0), 0.0)
    return x.astype(np.float32), y.astype(np.float32)


@dataclasses.dataclass
class Camera:
    """HyperNeRF camera: orientation (world->cam), position, intrinsics,
    distortion. image_size is (width, height)."""

    orientation: np.ndarray
    position: np.ndarray
    focal_length: float
    principal_point: np.ndarray
    image_size: np.ndarray
    skew: float = 0.0
    pixel_aspect_ratio: float = 1.0
    radial_distortion: Optional[np.ndarray] = None
    tangential_distortion: Optional[np.ndarray] = None

    def __post_init__(self):
        self.orientation = np.asarray(self.orientation, np.float32)
        self.position = np.asarray(self.position, np.float32)
        self.principal_point = np.asarray(self.principal_point, np.float32)
        self.image_size = np.asarray(self.image_size, np.int64)
        if self.radial_distortion is None:
            self.radial_distortion = np.zeros(3, np.float32)
        if self.tangential_distortion is None:
            self.tangential_distortion = np.zeros(2, np.float32)
        self.radial_distortion = np.asarray(self.radial_distortion, np.float32)
        self.tangential_distortion = np.asarray(self.tangential_distortion, np.float32)

    # -------------------------------------------------------------- #

    @classmethod
    def from_json(cls, path: str) -> "Camera":
        with open(path) as fp:
            cj = json.load(fp)
        if "tangential" in cj:
            cj["tangential_distortion"] = cj["tangential"]
        return cls(
            orientation=np.asarray(cj["orientation"]),
            position=np.asarray(cj["position"]),
            focal_length=float(cj["focal_length"]),
            principal_point=np.asarray(cj["principal_point"]),
            skew=float(cj["skew"]),
            pixel_aspect_ratio=float(cj["pixel_aspect_ratio"]),
            radial_distortion=np.asarray(cj["radial_distortion"]),
            tangential_distortion=np.asarray(cj["tangential_distortion"]),
            image_size=np.asarray(cj["image_size"]),
        )

    def to_json(self) -> dict:
        return {
            "orientation": self.orientation.tolist(),
            "position": self.position.tolist(),
            "focal_length": float(self.focal_length),
            "principal_point": self.principal_point.tolist(),
            "skew": float(self.skew),
            "pixel_aspect_ratio": float(self.pixel_aspect_ratio),
            "radial_distortion": self.radial_distortion.tolist(),
            "tangential_distortion": self.tangential_distortion.tolist(),
            "image_size": self.image_size.tolist(),
        }

    @property
    def scale_factor_x(self) -> float:
        return float(self.focal_length)

    @property
    def scale_factor_y(self) -> float:
        return float(self.focal_length) * float(self.pixel_aspect_ratio)

    @property
    def image_shape(self) -> Tuple[int, int]:
        """(height, width)."""
        return int(self.image_size[1]), int(self.image_size[0])

    @property
    def has_distortion(self) -> bool:
        return bool(np.any(self.radial_distortion != 0.0)
                    or np.any(self.tangential_distortion != 0.0))

    # -------------------------------------------------------------- #

    def pixel_to_local_rays(self, pixels: np.ndarray) -> np.ndarray:
        """Pixels [..., 2] -> unit local ray dirs [..., 3] (y-down, z-fwd)."""
        y = (pixels[..., 1] - self.principal_point[1]) / self.scale_factor_y
        x = (pixels[..., 0] - self.principal_point[0] - y * self.skew) / self.scale_factor_x
        if self.has_distortion:
            k1, k2, k3 = self.radial_distortion[:3]
            p1, p2 = self.tangential_distortion[:2]
            x, y = radial_and_tangential_undistort(x, y, k1, k2, k3, p1, p2)
        dirs = np.stack([x, y, np.ones_like(x)], axis=-1)
        return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

    def pixels_to_rays(self, pixels: np.ndarray) -> np.ndarray:
        """Pixels [..., 2] -> unit world ray dirs [..., 3]."""
        local = self.pixel_to_local_rays(np.asarray(pixels, np.float32))
        world = local @ self.orientation  # == orientation.T @ local per ray
        return (world / np.linalg.norm(world, axis=-1, keepdims=True)).astype(np.float32)

    def project(self, points: np.ndarray) -> np.ndarray:
        """World points [..., 3] -> pixel positions [..., 2]."""
        local = (points - self.position) @ self.orientation.T
        x = local[..., 0] / local[..., 2]
        y = local[..., 1] / local[..., 2]
        k1, k2, k3 = self.radial_distortion[:3]
        p1, p2 = self.tangential_distortion[:2]
        xd, yd = _distort(x, y, k1, k2, k3, p1, p2)
        px = self.focal_length * xd + self.skew * yd + self.principal_point[0]
        py = self.focal_length * self.pixel_aspect_ratio * yd + self.principal_point[1]
        return np.stack([px, py], axis=-1)

    def get_pixel_centers(self) -> np.ndarray:
        xx, yy = np.meshgrid(
            np.arange(self.image_size[0], dtype=np.float32),
            np.arange(self.image_size[1], dtype=np.float32),
        )
        return np.stack([xx, yy], axis=-1) + 0.5

    @property
    def optical_axis(self) -> np.ndarray:
        """World-space forward axis: the camera-frame z row of the
        world->cam rotation (hyper_cam.py optical_axis property)."""
        return self.orientation[2, :]

    def pixels_to_points(self, pixels: np.ndarray,
                         depth: np.ndarray) -> np.ndarray:
        """Back-project pixels at z-depths to world points
        (hyper_cam.py:254-260). `depth` is distance along the optical axis
        (the renderer's depth channel), so each unit ray is stretched by
        depth / cos(angle to the axis)."""
        rays = self.pixels_to_rays(np.asarray(pixels, np.float32))
        along_axis = rays @ self.optical_axis
        return (rays * (np.asarray(depth, np.float32)
                        / along_axis)[..., None] + self.position)

    def look_at(self, position: np.ndarray, look_at: np.ndarray,
                up: np.ndarray, eps: float = 1e-6) -> "Camera":
        """Copy of this camera placed at `position`, looking at `look_at`,
        with `up`'s projection parallel to the image y-axis
        (hyper_cam.py:327-370). Intrinsics are preserved."""
        position = np.asarray(position, np.float64)
        fwd = np.asarray(look_at, np.float64) - position
        n = np.linalg.norm(fwd)
        if n < eps:
            raise ValueError(
                "camera position and look-at point are too close")
        fwd = fwd / n
        right = np.cross(fwd, np.asarray(up, np.float64))
        n = np.linalg.norm(right)
        if n < eps:
            raise ValueError("up-vector is parallel to the optical axis")
        right = right / n
        # rows of the world->cam rotation: right (image +x), down-ish
        # (image +y = fwd x right), forward — a right-handed frame
        orientation = np.stack([right, np.cross(fwd, right), fwd])
        out = dataclasses.replace(self)
        out.position = position.astype(np.float32)
        out.orientation = orientation.astype(np.float32)
        return out

    def crop_image_domain(self, left: int = 0, right: int = 0, top: int = 0,
                          bottom: int = 0) -> "Camera":
        """Copy with the image domain shrunk (or, negative, grown) at each
        boundary; the principal point shifts so the principal axis is
        preserved and the focal length is unchanged (hyper_cam.py:372-400).
        """
        lt = np.array([left, top])
        rb = np.array([right, bottom])
        new_size = self.image_size - lt - rb
        if np.any(new_size <= 0):
            raise ValueError(
                "crop would make the image domain non-positive: "
                f"{new_size.tolist()}")
        out = dataclasses.replace(self)
        out.image_size = new_size.astype(np.int64)
        out.principal_point = (self.principal_point - lt).astype(np.float32)
        return out

    def scale(self, factor: float) -> "Camera":
        """Rescaled camera (intrinsics + image size) (hyper_cam.py:306-324)."""
        assert factor > 0
        return Camera(
            orientation=self.orientation.copy(),
            position=self.position.copy(),
            focal_length=self.focal_length * factor,
            principal_point=self.principal_point * factor,
            skew=self.skew,
            pixel_aspect_ratio=self.pixel_aspect_ratio,
            radial_distortion=self.radial_distortion.copy(),
            tangential_distortion=self.tangential_distortion.copy(),
            image_size=np.array(
                [int(round(self.image_size[0] * factor)),
                 int(round(self.image_size[1] * factor))]
            ),
        )
