"""ctypes bindings for the host C++ ray sampler and weight maps, the port's
copy of cednerf_tpu/datasets/native.py over its own copies of the sources
(csrc/host/raysampler.cpp, csrc/host/weights.cpp).

g++ builds both into cednerf_torch/_build/ on first use
(utils/host_build.py). Where the JAX package drops silently to numpy when
the build fails, here every native entry point raises; the caller decides
with `available(required)` whether it may take the numpy versions instead:
a loader on the CPU may (the JAX package's behaviour), a CUDA run may not.
The numpy versions stay as the plain versions the tests hold the C++
against: `NativeRaySampler.sample_numpy` and dynerf.py's `isg_weights` /
`ist_weights`.
"""

import ctypes

import numpy as np

from ..utils.host_build import HostLibrary
from .rays import pinhole_rays


def _bind_sampler(lib):
    lib.cednerf_build_cdf.restype = ctypes.c_double
    lib.cednerf_build_cdf.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.cednerf_sample_rays.restype = None
    lib.cednerf_sample_rays.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64,  # images, n, h, w, c
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # c2w, K, t
        ctypes.c_void_p, ctypes.c_int64,  # cdf, subsample
        ctypes.c_void_p, ctypes.c_int,  # bkgd, opengl
        ctypes.c_int64, ctypes.c_uint64, ctypes.c_int,  # n_rays, seed, threads
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]


def _bind_weights(lib):
    i64, f32, i32 = ctypes.c_int64, ctypes.c_float, ctypes.c_int
    vp = ctypes.c_void_p
    lib.cednerf_median_images.restype = None
    lib.cednerf_median_images.argtypes = [vp, i64, i64, i64, i32, vp]
    lib.cednerf_isg_weights.restype = None
    lib.cednerf_isg_weights.argtypes = [vp, vp, i64, i64, i64, f32, i32, vp]
    lib.cednerf_ist_weights.restype = None
    lib.cednerf_ist_weights.argtypes = [vp, i64, i64, i64, f32, i64, i32, vp]


SAMPLER = HostLibrary("raysampler", _bind_sampler)
WEIGHTS = HostLibrary("weights", _bind_weights)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def available(required: bool = False) -> bool:
    """Whether both libraries build and load. required=True (a run on the
    card) raises the build's error instead of returning False."""
    try:
        SAMPLER.get()
        WEIGHTS.get()
    except (RuntimeError, OSError):
        if required:
            raise
        return False
    return True


def native_median_images(imgs, n_cams: int, n_threads: int = 8):
    """[n_cams*n_frames, h, w, 3] uint8 -> [n_cams, h, w, 3] uint8 temporal
    medians (numpy median, then .astype(uint8)). At most 4096 frames a
    camera (the C++ sorts on the stack)."""
    n, h, w, _ = imgs.shape
    n_frames = n // n_cams
    if n_frames > 4096:
        raise ValueError(f"native_median_images: {n_frames} frames a "
                         "camera, at most 4096")
    imgs = np.ascontiguousarray(imgs, np.uint8)
    out = np.empty((n_cams, h, w, 3), np.uint8)
    WEIGHTS.get().cednerf_median_images(_ptr(imgs), n_cams, n_frames, h * w,
                                        n_threads, _ptr(out))
    return out


def native_isg_weights(imgs, median_imgs, gamma: float, n_threads: int = 8):
    """ISG weights [n_cams, n_frames, h, w] f32 (dynerf.isg_weights)."""
    n, h, w, _ = imgs.shape
    n_cams = median_imgs.shape[0]
    imgs = np.ascontiguousarray(imgs, np.uint8)
    median_imgs = np.ascontiguousarray(median_imgs, np.uint8)
    out = np.empty((n_cams, n // n_cams, h, w), np.float32)
    WEIGHTS.get().cednerf_isg_weights(_ptr(imgs), _ptr(median_imgs), n_cams,
                                      n // n_cams, h * w, gamma, n_threads,
                                      _ptr(out))
    return out


def native_ist_weights(imgs, n_cams: int, alpha: float, frame_shift: int,
                       n_threads: int = 8):
    """IST weights [n_cams, n_frames, h, w] f32 (dynerf.ist_weights)."""
    n, h, w, _ = imgs.shape
    imgs = np.ascontiguousarray(imgs, np.uint8)
    out = np.empty((n_cams, n // n_cams, h, w), np.float32)
    WEIGHTS.get().cednerf_ist_weights(_ptr(imgs), n_cams, n // n_cams, h * w,
                                      alpha, frame_shift, n_threads,
                                      _ptr(out))
    return out


def build_cdf(weights: np.ndarray) -> np.ndarray:
    """Inclusive prefix-sum CDF of a weight map, normalized (f64)."""
    weights = np.ascontiguousarray(weights.reshape(-1), np.float32)
    cdf = np.empty(weights.shape[0], np.float64)
    SAMPLER.get().cednerf_build_cdf(_ptr(weights), weights.shape[0],
                                    _ptr(cdf))
    return cdf


class NativeRaySampler:
    """Multithreaded pinhole ray-batch sampler over a host image stack.

    images: [N, H, W, 3|4] uint8; c2w: [N, 3, 4]; K: [3, 3];
    timestamps: [N]. Optional `weights` (possibly `subsample`x coarser than
    the images) switch from uniform pixel draws to inverse-CDF importance
    sampling with block expansion (the ISG/IST scheme). `sample` runs the
    C++; `sample_numpy` is its numpy version (the JAX package's fallback)."""

    def __init__(self, images, c2w, K, timestamps, opengl_camera: bool,
                 weights=None, subsample: int = 1, n_threads: int = 8,
                 seed: int = 0):
        self.images = np.ascontiguousarray(images, np.uint8)
        self.c2w = np.ascontiguousarray(
            np.asarray(c2w, np.float32).reshape(len(images), 12))
        self.K = np.ascontiguousarray(np.asarray(K, np.float32).reshape(9))
        self.timestamps = np.ascontiguousarray(
            np.asarray(timestamps, np.float32).reshape(-1))
        self.opengl = opengl_camera
        self.subsample = subsample if weights is not None else 1
        self.cdf = build_cdf(weights) if weights is not None else None
        self.n_threads = n_threads
        self._seed = seed
        self._lib = SAMPLER.get()

    def sample(self, n_rays: int, bkgd=None):
        """Returns (origins, viewdirs, pixels, timestamps) numpy arrays."""
        self._seed += 1
        n, h, w, c = self.images.shape
        origins = np.empty((n_rays, 3), np.float32)
        viewdirs = np.empty((n_rays, 3), np.float32)
        pixels = np.empty((n_rays, 3), np.float32)
        ts = np.empty((n_rays,), np.float32)
        bkgd_arr = (np.ascontiguousarray(bkgd, np.float32)
                    if bkgd is not None else None)
        self._lib.cednerf_sample_rays(
            _ptr(self.images), n, h, w, c, _ptr(self.c2w), _ptr(self.K),
            _ptr(self.timestamps),
            _ptr(self.cdf) if self.cdf is not None else None, self.subsample,
            _ptr(bkgd_arr) if bkgd_arr is not None else None,
            int(self.opengl), n_rays, self._seed, self.n_threads,
            _ptr(origins), _ptr(viewdirs), _ptr(pixels), _ptr(ts))
        return origins, viewdirs, pixels, ts

    def sample_numpy(self, n_rays: int, bkgd=None):
        """The numpy version of `sample` (its own draws: numpy's generator
        seeded as `sample` seeds the C++ one)."""
        self._seed += 1
        rng = np.random.default_rng(self._seed)
        n, h, w, c = self.images.shape
        if self.cdf is not None:
            sub = self.subsample
            draws = n_rays // (sub * sub)
            u = rng.random(draws)
            idx = np.searchsorted(self.cdf, u, side="right")
            idx = np.minimum(idx, len(self.cdf) - 1)
            hsub, wsub = h // sub, w // sub
            im = idx // (hsub * wsub)
            ys = (idx % (hsub * wsub)) // wsub
            xs = (idx % (hsub * wsub)) % wsub
            img_id = np.tile(im, sub * sub)
            x = np.concatenate([xs * sub + aw for ah in range(sub)
                                for aw in range(sub)])
            y = np.concatenate([ys * sub + ah for ah in range(sub)
                                for aw in range(sub)])
        else:
            img_id = rng.integers(0, n, n_rays)
            x = rng.integers(0, w, n_rays)
            y = rng.integers(0, h, n_rays)
        rgba = self.images[img_id, y, x].astype(np.float32) / 255.0
        c2w = self.c2w.reshape(-1, 3, 4)[img_id]
        origins, viewdirs, _ = pinhole_rays(
            x.astype(np.float32), y.astype(np.float32), self.K.reshape(3, 3),
            c2w, self.opengl)
        if c == 4 and bkgd is not None:
            pixels = (rgba[:, :3] * rgba[:, 3:]
                      + np.asarray(bkgd) * (1 - rgba[:, 3:]))
        else:
            pixels = rgba[:, :3]
        return (origins, viewdirs, pixels.astype(np.float32),
                self.timestamps[img_id])
