"""Host-side image and video IO: PNG with the standard library's zlib and
the port's own C++ unfilter, so that neither serving nor the dataset
loaders need an image package (the machines with the card have none).

`encode_png` writes 8-bit grey, grey+alpha, RGB or RGBA, its rows filtered
by the given PNG filter types in turn (0, none, unless asked). The viewer's
/render replies in it. `decode_png` reads what ordinary encoders write:
8-bit grey, grey+alpha, RGB and RGBA, every filter type, non-interlaced;
the filters are undone in host C++ (csrc/host/png_unfilter.cpp), since
filters 1, 3 and 4 run byte after byte along a row. Interlaced, 16-bit,
sub-byte and palette images raise ValueError naming the file.
`write_png` / `write_video` keep the JAX package's contract
(cednerf_tpu/utils/image.py): floats are clipped to [0, 1] and scaled to
uint8, and a video without an mp4 writer falls back to per-frame PNGs.
"""

import ctypes
import struct
import zlib

import numpy as np

from .host_build import HostLibrary

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for the 8-bit types this module reads
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _bind(lib):
    lib.cednerf_png_unfilter.restype = ctypes.c_int64
    lib.cednerf_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_void_p]


UNFILTER = HostLibrary("png_unfilter", _bind)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(x, prior, bpp: int, ftype: int):
    """One row's filtered bytes (int16 inputs, the spec's predictors on the
    unfiltered bytes) as uint8."""
    a = np.concatenate([np.zeros(bpp, np.int16), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int16), prior[:-bpp]])
    pred = {0: 0, 1: a, 2: prior, 3: (a + prior) >> 1,
            4: _paeth(a, prior, c)}[ftype]
    return ((x - pred) % 256).astype(np.uint8)


def encode_png(img: np.ndarray, level: int = 1, filters=(0,)) -> bytes:
    """uint8 [H, W] or [H, W, C] (C = 1 grey, 2 grey+alpha, 3 RGB, 4 RGBA)
    -> PNG bytes; row r is filtered with filters[r % len(filters)]."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"encode_png: expected [H, W] or [H, W, 1-4], got "
                         f"{img.shape}")
    if any(f not in range(5) for f in filters):
        raise ValueError(f"encode_png: filter types are 0-4, got {filters}")
    h, w, ch = img.shape
    rows = img.reshape(h, w * ch)
    raw = np.empty((h, 1 + w * ch), np.uint8)
    if tuple(filters) == (0,):
        raw[:, 0] = 0
        raw[:, 1:] = rows
    else:
        prior = np.zeros(w * ch, np.int16)
        for r in range(h):
            x = rows[r].astype(np.int16)
            raw[r, 0] = filters[r % len(filters)]
            raw[r, 1:] = _filter_row(x, prior, ch, int(raw[r, 0]))
            prior = x
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[ch], 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> uint8 [H, W] (grey) or [H, W, C] (C = 2, 3, 4), as
    imageio.imread returns them. `name` labels errors."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"decode_png: {name} is not a PNG")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError(f"decode_png: {name} has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace:
        raise ValueError(f"decode_png: {name} is interlaced (Adam7); only "
                         "non-interlaced PNGs are read")
    if depth != 8:
        raise ValueError(f"decode_png: {name} has {depth}-bit samples; only "
                         "8-bit PNGs are read")
    if ctype not in _CHANNELS:
        raise ValueError(f"decode_png: {name} has colour type {ctype}; only "
                         "grey, grey+alpha, RGB and RGBA are read")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * ch):
        raise ValueError(f"decode_png: {name} inflates to {raw.size} bytes, "
                         f"expected {h * (1 + w * ch)}")
    out = np.empty((h, w, ch), np.uint8)
    rc = UNFILTER.get().cednerf_png_unfilter(
        raw.ctypes.data_as(ctypes.c_void_p), h, w * ch, ch,
        out.ctypes.data_as(ctypes.c_void_p))
    if rc:
        raise ValueError(f"decode_png: {name} row {-rc - 1} has a filter "
                         "type outside 0-4")
    return out[..., 0] if ch == 1 else out


def read_png(path) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode_png(fh.read(), name=str(path))


def write_png(path, img) -> None:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(encode_png(img))


def write_video(path: str, frames, fps: int = 20) -> bool:
    """Write an mp4 through imageio when it and an ffmpeg backend can be
    found; otherwise per-frame PNGs {stem}_{i:04d}.png. Returns True if the
    video file was written."""
    frames = list(frames)
    try:
        import imageio.v2 as imageio
        imageio.mimwrite(path, frames, fps=fps)
        return True
    except (ImportError, ValueError, RuntimeError):
        # no imageio, or no backend that writes mp4
        base = path.rsplit(".", 1)[0]
        for i, f in enumerate(frames):
            write_png(f"{base}_{i:04d}.png", f)
        return False
