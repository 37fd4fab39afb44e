"""Small host-side image utilities (numpy), and a PNG writer on the
standard library's ``zlib`` (the card's machine has no imageio)."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def bilinear_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize (align_corners=False), matching the reference's
    F.interpolate calls (run_nerf.py:111-113, evaluation_helpers.py:310)."""
    H, W = img.shape[:2]
    ys = (np.arange(h) + 0.5) * H / h - 0.5
    xs = (np.arange(w) + 0.5) * W / w - 0.5
    y0 = np.clip(np.floor(ys), 0, H - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, W - 1).astype(np.int64)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = np.clip(ys - y0, 0., 1.)[:, None, None]
    wx = np.clip(xs - x0, 0., 1.)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image as an 8-bit PNG: one IDAT
    chunk of unfiltered rows (filter byte 0), zlib level 6."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'write_png takes (H, W, 3) uint8, got '
                         f'{img.shape} {img.dtype}')
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], 1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack('>I', len(data)) + tag + data
                + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff))

    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n'
                + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
                + chunk(b'IDAT', zlib.compress(rows.tobytes(), 6))
                + chunk(b'IEND', b''))
