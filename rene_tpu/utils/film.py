"""Film: accumulation layout, tone encoding, PNG/AOV output.

Matches the reference's film pipeline (rene/src/main.rs:1404-1810): a 3-layer
float32 accumulation (color / normal AOV / albedo AOV), averaged by the
sample count, color gamma-encoded with pbrt's 2.2 curve, AOVs encoded as
`256*clamp(v, 0, .999)` (normals remapped by 0.5x+0.5). The raygen writes to
row `H-1-y` (lib.rs:166); here that is a single flip at layout time.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from ..scene.assets.images import gamma_correct


def rays_to_image(per_ray: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H*W, C) ray-order buffer -> (H, W, C) image with the reference's
    vertical flip (add_image writes at launch_size.y - 1 - y)."""
    img = np.asarray(per_ray).reshape(height, width, -1)
    return img[::-1]


def to_rgb8(linear: np.ndarray) -> np.ndarray:
    v = gamma_correct(np.asarray(linear, np.float32))
    return np.clip(np.round(255.0 * v), 0.0, 255.0).astype(np.uint8)


def to_aov8(linear: np.ndarray) -> np.ndarray:
    return (256.0 * np.clip(linear, 0.0, 0.999)).astype(np.uint8)


def to_aov_normal8(linear: np.ndarray) -> np.ndarray:
    return (256.0 * np.clip(linear * 0.5 + 0.5, 0.0, 0.999)).astype(np.uint8)


def encode_png(rgb8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 image -> PNG bytes (8-bit RGB, no interlace, one
    zlib stream with filter type 0 on every row)."""
    rgb8 = np.ascontiguousarray(rgb8, np.uint8)
    if rgb8.ndim != 3 or rgb8.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {rgb8.shape}")
    h, w, _ = rgb8.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb8.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_png(path: str, rgb8: np.ndarray) -> str:
    """Save an (H, W, 3) uint8 image; `.exr` filenames fall back to `.png`
    like the reference (main.rs:1651-1656)."""
    path = str(path)
    if path.endswith(".exr"):
        path = path + ".png"
    with open(path, "wb") as f:
        f.write(encode_png(rgb8))
    return path
