"""Image grids as PNG files: the per-epoch recon grids (originals and
reconstructions interleaved by row) and the sample grids (4 x 8).

The port's copy of ``spiking_diffusion_tpu/utils/grids.py`` with the same
pixels. The PNG is written here with ``zlib`` and ``struct`` (signature,
IHDR, one IDAT, IEND), since the card's machine has no PIL: 8-bit
greyscale for one channel, 8-bit RGB for three.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
PNG_COLOR_TYPES = {2: 0, 3: 2}  # array ndim -> greyscale 0, RGB 2


def _to_uint8(images: np.ndarray) -> np.ndarray:
    """(N, H, W, C) in [-0.5, 0.5] -> (N, H, W[, 3]) uint8.

    Single-channel images drop the channel axis (greyscale PNG); RGB
    images keep it.
    """
    x = np.asarray(images)
    if x.ndim == 4 and x.shape[-1] == 1:
        x = x[..., 0]
    return (np.clip(x + 0.5, 0.0, 1.0) * 255).astype(np.uint8)


def _tile(images: np.ndarray, rows: int, cols: int, pad: int = 2) -> np.ndarray:
    n, h, w = images.shape[:3]
    extra = images.shape[3:]  # () greyscale or (3,) RGB
    grid = np.full(
        (rows * (h + pad) - pad, cols * (w + pad) - pad) + extra, 255, np.uint8
    )
    for i in range(min(n, rows * cols)):
        r, c = divmod(i, cols)
        grid[r * (h + pad): r * (h + pad) + h,
             c * (w + pad): c * (w + pad) + w] = images[i]
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_png(path: str, pixels: np.ndarray) -> str:
    """Write a uint8 (H, W) greyscale or (H, W, 3) RGB array as a PNG:
    every row with filter byte 0, the rows in one zlib stream."""
    arr = np.ascontiguousarray(pixels, np.uint8)
    if arr.ndim not in PNG_COLOR_TYPES or (arr.ndim == 3 and arr.shape[2] != 3):
        raise ValueError(f"a PNG holds (H, W) or (H, W, 3) pixels, not {arr.shape}")
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, PNG_COLOR_TYPES[arr.ndim], 0, 0, 0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))
    return path


def save_image_grid(
    images: np.ndarray,
    path: str,
    rows: int = 4,
    cols: int = 8,
    already_uint8: bool = False,
) -> str:
    """Save (N, H, W, C) images (normalised to [-0.5, 0.5]) as a grid PNG."""
    arr = np.asarray(images) if already_uint8 else _to_uint8(images)
    if arr.ndim == 4 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    return write_png(path, _tile(arr, rows, cols))


def save_recon_grid(
    originals: np.ndarray, recons: np.ndarray, path: str, cols: int = 8
) -> str:
    """Interleave rows of originals and reconstructions, both normalised
    images in [-0.5, 0.5]."""
    ori = _to_uint8(originals)
    rec = _to_uint8(recons)
    n = min(len(ori), len(rec))
    rows = []
    for start in range(0, n, cols):
        rows.append(_tile(ori[start: start + cols], 1, cols))
        rows.append(_tile(rec[start: start + cols], 1, cols))
    pad = 2
    h = sum(r.shape[0] for r in rows) + pad * (len(rows) - 1)
    w = max(r.shape[1] for r in rows)
    canvas = np.full((h, w) + rows[0].shape[2:], 255, np.uint8)
    y = 0
    for r in rows:
        canvas[y: y + r.shape[0], : r.shape[1]] = r
        y += r.shape[0] + pad
    return write_png(path, canvas)
