"""PNG encode/decode with the standard library only (zlib + struct).

The viewer's /render replies in PNG written here, so serving needs no image
package. `decode_png` reads back what `encode_png` writes (8-bit RGB,
filter type 0), for tests and smoke checks."""

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """uint8 [H, W, 3] -> PNG bytes (8-bit RGB, no filtering)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png: expected [H, W, 3], got {img.shape}")
    h, w, _ = img.shape
    raw = np.empty((h, 1 + 3 * w), np.uint8)
    raw[:, 0] = 0                                   # filter type: none
    raw[:, 1:] = img.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes written by encode_png -> uint8 [H, W, 3]."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("decode_png: not a PNG")
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise ValueError("decode_png: only 8-bit RGB is read")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if np.any(raw[:, 0] != 0):
        raise ValueError("decode_png: only filter type 0 is read")
    return raw[:, 1:].reshape(h, w, 3).copy()
