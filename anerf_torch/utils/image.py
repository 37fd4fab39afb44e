"""Small host-side image utilities (numpy)."""
from __future__ import annotations

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
