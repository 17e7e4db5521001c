"""The real-data loaders of the port against the JAX package's, on the same
on-disk fixtures (tests/test_datasets.py's writers): PNG IO, the pose and
camera copies, the D-NeRF / HyperNeRF / DyNeRF loaders, the native C++
sampler and weight maps, the device samplers' assembly on JAX's own draws,
and mark_invisible_cells.

Tolerances: integer and uint8 arrays, timestamps, poses and the native
C++ outputs exactly (the same arithmetic, or the same C++ source built
with the same flags); rays within 1e-6 absolute (unit directions; the
device samplers' [N, 3] x [3, 3] products sum in another order than
XLA's); the numpy weight maps within 1e-6 (float32 means over channels).
The device samplers' pixels equal the JAX sampler's run op by op exactly;
under jit XLA turns the division by 255 into a product with its
reciprocal and fuses the alpha composite, which moves a pixel by up to 2
ulps (2.4e-7 at 1.0), the limit against the jitted sampler.
"""

import json
import os
import struct
import time
import zlib

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.datasets import camera as j_camera
from cednerf_tpu.datasets import dynerf as j_dynerf
from cednerf_tpu.datasets import llff as j_llff
from cednerf_tpu.datasets import native as j_native
from cednerf_tpu.datasets import rays as j_rays
from cednerf_tpu.datasets.dnerf_synthetic import (
    DNeRFSyntheticDataset as JDNeRF)
from cednerf_tpu.datasets.dynerf import DyNeRFDataset as JDyNeRF
from cednerf_tpu.datasets.hypernerf import HyperNeRFDataset as JHyper
from cednerf_tpu.engine import sampling as j_sampling
from cednerf_tpu.ops import occupancy as j_occ
from cednerf_torch.datasets import camera, dynerf, llff, native, rays
from cednerf_torch.datasets.dnerf_synthetic import DNeRFSyntheticDataset
from cednerf_torch.datasets.dynerf import DyNeRFDataset
from cednerf_torch.datasets.hypernerf import HyperNeRFDataset
from cednerf_torch.ops import occupancy
from cednerf_torch.utils.image import (decode_png, encode_png, read_png,
                                       write_png, write_video)
from test_datasets import (make_dnerf_fixture, make_dynerf_fixture,
                           make_hypernerf_fixture)

RAY_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Hundreds of small CPU ops: with torch's default of one thread per
    core in each of the suite's worker processes the threads oversubscribe
    the cores (as in tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_libraries():
    """The JAX package's two native libraries (libweights.so,
    libraysampler.so), loaded before any test here compares against them.
    That package builds each in place with g++, straight to the final
    path, and caches a failed load as False for the rest of the process:
    a load that meets another worker's build of the same file (the
    suite's native tests) would leave its native calls on numpy. So a
    failed load is cleared and tried again, once a second, up to 60 times
    (a build takes seconds); a library that never loads fails the tests
    here."""
    for name, load, cache in (
            ("libweights.so", j_native._load_weights_library, "_WLIB"),
            ("libraysampler.so", j_native._load_library, "_LIB")):
        for _ in range(60):
            if load():
                break
            setattr(j_native, cache, None)
            time.sleep(1.0)
        else:
            pytest.fail(f"the JAX package's {name} did not load in 60 "
                        "tries")


# ---------------------------------------------------------------- PNG

_SHAPES = {"grey": (13, 21), "grey_alpha": (13, 21, 2), "rgb": (13, 21, 3),
           "rgba": (13, 21, 4)}


@pytest.mark.parametrize("kind", list(_SHAPES))
def test_decode_png_matches_imageio(tmp_path, kind):
    """Files written by imageio (Pillow's adaptive filters) decode byte for
    byte as imageio reads them, dtype and shape included."""
    rng = np.random.default_rng(0)
    h, w = _SHAPES[kind][:2]
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (xx * 7 + yy * 5) % 256
    img = (rng.integers(0, 256, _SHAPES[kind]) // 4
           + (smooth if len(_SHAPES[kind]) == 2 else smooth[..., None])
           ).astype(np.uint8)
    path = tmp_path / f"{kind}.png"
    imageio.imwrite(path, img)
    want = imageio.imread(path)
    got = read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", list(_SHAPES))
def test_png_filters_0_to_4_match_imageio(tmp_path, kind):
    """Rows cycling through filter types 0-4 (encode_png): imageio reads the
    encoder's file as the image, and the decoder reads it as imageio."""
    img = np.random.default_rng(1).integers(0, 256, _SHAPES[kind],
                                            dtype=np.uint8)
    data = encode_png(img, filters=(0, 1, 2, 3, 4))
    raw = zlib.decompress(data[data.index(b"IDAT") + 4:])
    rowbytes = int(np.prod(_SHAPES[kind][1:]))
    ftypes = np.frombuffer(raw, np.uint8)[::rowbytes + 1]
    np.testing.assert_array_equal(ftypes, np.arange(len(ftypes)) % 5)
    path = tmp_path / f"{kind}.png"
    path.write_bytes(data)
    want = imageio.imread(path)
    np.testing.assert_array_equal(want, img)
    np.testing.assert_array_equal(decode_png(data), want)


def _with_ihdr(data: bytes, **fields) -> bytes:
    """`data` with IHDR fields replaced (depth, ctype, interlace), CRC
    recomputed."""
    i = data.index(b"IHDR")
    w, h, depth, ctype, comp, filt, inter = struct.unpack(
        ">IIBBBBB", data[i + 4:i + 17])
    depth = fields.get("depth", depth)
    ctype = fields.get("ctype", ctype)
    inter = fields.get("interlace", inter)
    body = struct.pack(">IIBBBBB", w, h, depth, ctype, comp, filt, inter)
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF)
    return data[:i + 4] + body + crc + data[i + 21:]


def test_decode_png_rejects_interlaced_and_16_bit(tmp_path):
    img = np.zeros((4, 5, 3), np.uint8)
    inter = tmp_path / "interlaced.png"
    inter.write_bytes(_with_ihdr(encode_png(img), interlace=1))
    with pytest.raises(ValueError, match="interlaced.png.*interlaced"):
        read_png(inter)
    deep = tmp_path / "deep.png"
    imageio.imwrite(deep, np.arange(20, dtype=np.uint16).reshape(4, 5) * 999)
    with pytest.raises(ValueError, match="deep.png has 16-bit"):
        read_png(deep)
    pal = tmp_path / "palette.png"
    pal.write_bytes(_with_ihdr(encode_png(img[..., 0]), ctype=3))
    with pytest.raises(ValueError, match="palette.png has colour type 3"):
        read_png(pal)


def test_write_png_round_trip(tmp_path):
    rng = np.random.default_rng(2)
    f = rng.uniform(-0.2, 1.2, (9, 11, 3)).astype(np.float32)
    write_png(tmp_path / "f.png", f)
    want = (np.clip(f, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(read_png(tmp_path / "f.png"), want)
    np.testing.assert_array_equal(imageio.imread(tmp_path / "f.png"), want)
    for shape in ((9, 11), (9, 11, 4)):
        u = rng.integers(0, 256, shape, dtype=np.uint8)
        write_png(tmp_path / "u.png", u)
        np.testing.assert_array_equal(read_png(tmp_path / "u.png"), u)


def test_write_video_writes_frames(tmp_path):
    frames = [np.full((6, 8, 3), 40 * i, np.uint8) for i in range(3)]
    path = str(tmp_path / "v.mp4")
    if write_video(path, frames, fps=20):
        assert os.path.getsize(path) > 0
    else:
        for i, f in enumerate(frames):
            np.testing.assert_array_equal(
                read_png(tmp_path / f"v_{i:04d}.png"), f)


# ---------------------------------------------------------- pose copies

def _ring_poses(n=5, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        th = 2 * np.pi * i / n + rng.uniform(0, 0.2)
        pos = np.array([3 * np.cos(th), 3 * np.sin(th), 1 + rng.uniform()])
        out.append(rays.viewmatrix(pos, np.array([0.0, 0, 1]), pos))
    return np.stack(out)


def test_pose_helpers_match_jax():
    poses = _ring_poses()
    for fn in ("average_poses", "generate_hemispherical_orbit"):
        np.testing.assert_array_equal(getattr(rays, fn)(poses),
                                      getattr(j_rays, fn)(poses))
    near_fars = np.array([[0.5, 6.0], [0.7, 5.0]])
    np.testing.assert_array_equal(
        rays.generate_spiral_path(poses, near_fars, n_frames=30),
        j_rays.generate_spiral_path(poses, near_fars, n_frames=30))
    bounds = np.array([[0.8, 7.0]] * len(poses))
    for a, b in zip(llff.correct_poses_bounds(poses, bounds),
                    j_llff.correct_poses_bounds(poses, bounds)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(llff.interpolate_poses(poses, 3),
                                  j_llff.interpolate_poses(poses, 3))


def test_camera_rays_match_jax():
    kw = dict(orientation=np.eye(3)[[1, 0, 2]] * [[1], [-1], [1]],
              position=[0.1, -0.2, 3.0], focal_length=40.0,
              principal_point=[15.5, 12.0], image_size=[32, 24],
              skew=0.1, pixel_aspect_ratio=1.05,
              radial_distortion=[0.05, -0.01, 0.002],
              tangential_distortion=[0.001, -0.002])
    cam, jcam = camera.Camera(**kw), j_camera.Camera(**kw)
    px = cam.get_pixel_centers()
    np.testing.assert_allclose(cam.pixel_to_local_rays(px),
                               jcam.pixel_to_local_rays(px), atol=RAY_ATOL)
    np.testing.assert_allclose(cam.pixels_to_rays(px), jcam.pixels_to_rays(px),
                               atol=RAY_ATOL)
    s, js = cam.scale(0.5), jcam.scale(0.5)
    assert s.to_json() == js.to_json()


# ---------------------------------------------------------- loaders

def _same_arrays(a, b, names):
    for n in names:
        x, y = getattr(a, n), getattr(b, n)
        assert np.asarray(x).dtype == np.asarray(y).dtype, n
        np.testing.assert_array_equal(x, y, err_msg=n)


def _same_rays(got: dict, want: dict):
    for k, v in want.items():
        if k in ("origins", "viewdirs"):
            np.testing.assert_allclose(got[k], v, atol=RAY_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.fixture(scope="module")
def dnerf_root(tmp_path_factory):
    return make_dnerf_fixture(str(tmp_path_factory.mktemp("dnerf")),
                              scene="lego", n_frames=4, wh=16, ring=True)


def test_dnerf_loader_matches_jax(dnerf_root):
    for split in ("train", "test"):
        got = DNeRFSyntheticDataset("lego", dnerf_root, split, num_rays=64)
        want = JDNeRF("lego", dnerf_root, split, num_rays=64)
        _same_arrays(got, want, ("images", "camtoworlds", "K", "timestamps",
                                 "focal", "width", "height"))
        assert len(got) == len(want) == 4
        for i in (0, 3):
            _same_rays(got.image_rays(i), want.image_rays(i))
        poses = got.render_poses()
        np.testing.assert_array_equal(poses["c2w"],
                                      want.render_poses()["c2w"])
        for i in (0, 77):
            _same_rays(got.pose_rays(poses, i), want.pose_rays(poses, i))


def _two_group_hyper_fixture(root):
    """make_hypernerf_fixture with the intrinsics of images 2, 3, 6 and 7
    changed: two intrinsics groups (a two-camera rig) in each split (train
    takes the even images, test the odd ones)."""
    make_hypernerf_fixture(root, scene="vrig_test", n_imgs=8, wh=16,
                           ring=True)
    cam_dir = os.path.join(root, "vrig_test", "test", "camera")
    for k in (2, 3, 6, 7):
        path = os.path.join(cam_dir, f"{k:06d}.json")
        with open(path) as f:
            cam = json.load(f)
        cam["focal_length"] *= 1.25
        cam["radial_distortion"] = [-0.02, 0.003, 0.0]
        with open(path, "w") as f:
            json.dump(cam, f)
    return root


@pytest.fixture(scope="module")
def hyper_root(tmp_path_factory):
    return _two_group_hyper_fixture(str(tmp_path_factory.mktemp("hyper")))


def test_hypernerf_loader_matches_jax(hyper_root):
    for split in ("train", "test"):
        kw = dict(num_rays=32 if split == "train" else None, factor=2,
                  add_cam=True)
        got = HyperNeRFDataset("vrig_test", hyper_root, split, **kw)
        want = JHyper("vrig_test", hyper_root, split, **kw)
        _same_arrays(got, want, ("images", "timestamps", "width", "height",
                                 "near", "far"))
        assert len(got) == len(want) == 4
        for c, jc in zip(got.cameras, want.cameras):
            assert c.to_json() == jc.to_json()
        for i in range(len(got)):
            _same_rays(got.image_rays(i), want.image_rays(i))


@pytest.fixture(scope="module")
def dynerf_root(tmp_path_factory):
    return make_dynerf_fixture(str(tmp_path_factory.mktemp("dynerf")),
                               scene="cook_spinach", n_cams=4, n_frames=4,
                               wh=16, ring=True)


def test_dynerf_loader_matches_jax(dynerf_root):
    for split in ("train", "test"):
        kw = dict(num_rays=64 if split == "train" else None, factor=4,
                  sampling="uniform")
        got = DyNeRFDataset("cook_spinach", dynerf_root, split, device="cpu",
                            **kw)
        want = JDyNeRF("cook_spinach", dynerf_root, split, **kw)
        _same_arrays(got, want, ("images", "poses", "K", "timestamps",
                                 "width", "height", "images_per_video",
                                 "num_cameras"))
        assert len(got) == len(want)
        for i in (0, len(got) - 1):
            _same_rays(got.image_rays(i), want.image_rays(i))
        poses = got.render_poses()
        np.testing.assert_array_equal(poses["c2w"],
                                      want.render_poses()["c2w"])
        for i in (0, 151):
            _same_rays(got.pose_rays(poses, i), want.pose_rays(poses, i))


def test_dynerf_weights_match_jax(dynerf_root):
    """ISG and IST weight maps: the native C++ exactly against the JAX
    package's native build, the numpy versions within 1e-6 of JAX's numpy;
    the loaders' self-bootstrapped ISG maps and, after switch_to_ist, their
    IST maps are the same distribution."""
    imgs = np.random.default_rng(3).integers(0, 256, (3 * 5, 12, 17, 3),
                                             dtype=np.uint8)
    med = native.native_median_images(imgs, 3)
    np.testing.assert_array_equal(med, j_native.native_median_images(imgs, 3))
    np.testing.assert_array_equal(
        native.native_isg_weights(imgs, med, gamma=2e-2),
        j_native.native_isg_weights(imgs, med, gamma=2e-2))
    np.testing.assert_allclose(dynerf.isg_weights(imgs, med),
                               j_dynerf.isg_weights(imgs, med), atol=1e-6)
    for shift in (2, 25):
        np.testing.assert_array_equal(
            native.native_ist_weights(imgs, 3, alpha=0.1, frame_shift=shift),
            j_native.native_ist_weights(imgs, 3, alpha=0.1,
                                        frame_shift=shift))
        np.testing.assert_allclose(
            dynerf.ist_weights(imgs, 3, frame_shift=shift),
            j_dynerf.ist_weights(imgs, 3, frame_shift=shift), atol=1e-6)

    def fresh():
        d = os.path.join(dynerf_root, "cook_spinach")
        for f in os.listdir(d):
            if f.endswith(".npy") and "weights" in f:
                os.remove(os.path.join(d, f))

    fresh()
    got = DyNeRFDataset("cook_spinach", dynerf_root, "train", num_rays=64,
                        sampling="isg", device="cpu")
    fresh()
    want = JDyNeRF("cook_spinach", dynerf_root, "train", num_rays=64,
                   sampling="isg")
    assert got.sampling == want.sampling == "isg"
    np.testing.assert_array_equal(got.sampling_weights,
                                  want.sampling_weights)
    fresh()
    got.switch_to_ist()
    fresh()
    want.switch_to_ist()
    assert got.sampling == want.sampling == "ist"
    assert got.weights_subsampled == want.weights_subsampled == 1
    np.testing.assert_array_equal(got.sampling_weights,
                                  want.sampling_weights)
    fresh()


# ---------------------------------------------------------- native sampler

def _stack(n=4, wh=24, channels=4, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, wh, wh, channels), dtype=np.uint8)
    c2w = _ring_poses(n, seed).astype(np.float32)
    K = np.array([[wh * 1.2, 0, wh / 2], [0, wh * 1.2, wh / 2], [0, 0, 1]],
                 np.float32)
    return images, c2w, K, np.linspace(0, 1, n).astype(np.float32)


@pytest.mark.parametrize("weighted,sub", [(False, 1), (True, 1), (True, 2)])
def test_native_sampler_matches_jax(weighted, sub):
    """Same seed and weights: the port's C++ sampler equals the JAX
    package's bit for bit (the same source, built with the same flags), and
    so do the two numpy versions."""
    images, c2w, K, t = _stack()
    w = None
    if weighted:
        w = np.random.default_rng(4).uniform(
            0, 1, (4, 24 // sub, 24 // sub)).astype(np.float32)
        w[1] *= 20.0
        np.testing.assert_array_equal(native.build_cdf(w),
                                      j_native.build_cdf(w))
    for opengl in (True, False):
        mk = dict(opengl_camera=opengl, weights=w, subsample=sub, seed=7)
        s = native.NativeRaySampler(images, c2w, K, t, **mk)
        js = j_native.NativeRaySampler(images, c2w, K, t, **mk)
        bkgd = np.array([0.2, 0.5, 0.9], np.float32)
        for _ in range(2):
            for a, b in zip(s.sample(256, bkgd), js.sample(256, bkgd)):
                np.testing.assert_array_equal(a, b)
        # JAX's fallback: sample() advances the seed, then _sample_numpy
        js._seed += 1
        for a, b in zip(s.sample_numpy(256, bkgd),
                        js._sample_numpy(256, bkgd)):
            np.testing.assert_array_equal(a, b)


def test_native_build_failure_raises(monkeypatch):
    """Without g++ a build raises; a loader on the CPU may take numpy."""
    from cednerf_torch.utils.host_build import HostLibrary

    lib = HostLibrary("raysampler", lambda lib: None)
    monkeypatch.setattr(HostLibrary, "_target",
                        lambda self: "/nonexistent/never.so")
    monkeypatch.setattr("shutil.which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        lib.get()
    monkeypatch.setattr(native, "SAMPLER", lib)
    assert not native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.available(required=True)


# ---------------------------------------------------------- device samplers

def _image_stack_draws(key, n, h, w, n_rays):
    """JAX's make_image_stack_sampler draws (engine/sampling.py:56-59,
    _bkgd_device's uniform)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return (np.asarray(jax.random.randint(k1, (n_rays,), 0, n)),
            np.asarray(jax.random.randint(k2, (n_rays,), 0, w)),
            np.asarray(jax.random.randint(k3, (n_rays,), 0, h)),
            np.asarray(jax.random.uniform(k4, (3,))))


def _same_batch(got: dict, want: dict, jitted: dict):
    for k in ("pixels", "timestamps", "color_bkgd"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["pixels"].numpy(),
                               np.asarray(jitted["pixels"]), rtol=0,
                               atol=2.4e-7)
    for k in ("origins", "viewdirs"):
        for ref in (want, jitted):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       atol=RAY_ATOL, err_msg=k)


def _t(a):
    return torch.from_numpy(np.array(a)).long()


def test_image_stack_sampler_matches_jax(dnerf_root):
    """The D-NeRF device sampler (RGBA, random background) on JAX's draws."""
    got_ds = DNeRFSyntheticDataset("lego", dnerf_root, "train", num_rays=64,
                                   color_bkgd_aug="random")
    want_ds = JDNeRF("lego", dnerf_root, "train", num_rays=64,
                     color_bkgd_aug="random")
    data, sample = got_ds.device_sampler("cpu")
    jdata, jsample = j_sampling.dnerf_device_data(want_ds)
    n, h, w = got_ds.images.shape[:3]
    for seed in (0, 1):
        key = jax.random.PRNGKey(seed)
        want = jsample(jdata, key, 512)
        jitted = jax.jit(jsample, static_argnums=2)(jdata, key, 512)
        img_id, x, y, bkgd = _image_stack_draws(key, n, h, w, 512)
        got = sample._assemble(data, _t(img_id), _t(x), _t(y),
                               torch.from_numpy(np.array(bkgd)))
        _same_batch(got, want, jitted)
    gen = torch.Generator().manual_seed(0)
    batch = sample(data, gen, 64)
    assert batch["pixels"].shape == (64, 3)
    assert batch["color_bkgd"].shape == (3,)
    assert batch["timestamps"].shape == (64, 1)


def test_hyper_sampler_matches_jax(hyper_root):
    """The HyperNeRF device sampler (two intrinsics groups) on JAX's
    draws."""
    kw = dict(num_rays=32, factor=2, add_cam=True)
    got_ds = HyperNeRFDataset("vrig_test", hyper_root, "train", **kw)
    want_ds = JHyper("vrig_test", hyper_root, "train", **kw)
    data, sample = got_ds.device_sampler("cpu")
    jdata, jsample = j_sampling.hypernerf_device_data(want_ds)
    assert int(data["cam_group"].max()) == 1          # two groups
    np.testing.assert_array_equal(data["cam_group"].numpy(),
                                  np.asarray(jdata["cam_group"]))
    np.testing.assert_allclose(data["local_dirs"].numpy(),
                               np.asarray(jdata["local_dirs"]), atol=RAY_ATOL)
    n, h, w = got_ds.images.shape[:3]
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = jsample(jdata, key, 256)
        jitted = jax.jit(jsample, static_argnums=2)(jdata, key, 256)
        k1, k2, k3, _ = jax.random.split(key, 4)
        img = np.asarray(jax.random.randint(k1, (), 0, n))
        x = np.asarray(jax.random.randint(k2, (256,), 0, w))
        y = np.asarray(jax.random.randint(k3, (256,), 0, h))
        got = sample._assemble(data, _t(img), _t(x), _t(y), torch.zeros(3))
        _same_batch(got, want, jitted)
    batch = sample(data, torch.Generator().manual_seed(0), 64)
    assert batch["origins"].shape == (64, 3)
    assert torch.all(batch["timestamps"] == batch["timestamps"][0])


def test_hyper_sampler_falls_back_past_16_groups(hyper_root):
    """More than 16 intrinsics groups: no device sampler (the stacked host
    path), as in JAX."""
    ds = HyperNeRFDataset("vrig_test", hyper_root, "train", num_rays=32,
                          factor=2, add_cam=True)
    cams = ds.cameras
    ds.cameras = [camera.Camera(**{**c.__dict__, "focal_length":
                                   c.focal_length + i})
                  for i, c in enumerate(cams * 5)]
    assert len(ds.cameras) == 20
    assert ds.device_sampler("cpu") is None


# ---------------------------------------------------------- occupancy

def test_mark_invisible_cells_matches_jax(dynerf_root):
    """A 3-camera ring (the DyNeRF fixture's train cameras), a 2-level 16^3
    grid: the cells marked invisible (occ -1) exactly as in JAX."""
    ds = DyNeRFDataset("cook_spinach", dynerf_root, "train", num_rays=64,
                       sampling="uniform", device="cpu")
    cams = ds.poses[::ds.images_per_video]
    assert len(cams) == 3
    aabb = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
    jstate = j_occ.create_occ_grid(aabb, 16, 2)
    occs = np.random.default_rng(5).uniform(0, 0.1, jstate.occs.shape)
    jstate = jstate._replace(occs=jnp.asarray(occs, jnp.float32))
    state = occupancy.create_occ_grid(aabb, 16, 2, device="cpu")
    state = state._replace(occs=torch.tensor(occs, dtype=torch.float32))
    for near in (0.0, 0.2):
        want = j_occ.mark_invisible_cells(jstate, ds.K, cams, ds.width,
                                          ds.height, near_plane=near)
        got = occupancy.mark_invisible_cells(state, ds.K, cams, ds.width,
                                             ds.height, near_plane=near)
        np.testing.assert_array_equal(got.occs.numpy(), np.asarray(want.occs))
        np.testing.assert_array_equal(got.binaries.numpy(),
                                      np.asarray(want.binaries))
        culled = (got.occs < 0).float().mean().item()
        assert 0.05 < culled < 0.95, culled
