"""Bounding-cylinder utilities (host-side numpy).

Matches reference core/utils/skeleton_utils.py:542-694: a vertical
cylinder around the keypoints bounds the subject; its cap circles project
to a tight 2D box used to restrict rendering/eval to valid rays.
These run on host during data prep / render setup, so they stay numpy
(copy of ``anerf_tpu/ops/cylinder.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..skeleton import Skeleton, get_skeleton_type


def get_kp_bounding_cylinder(kp: np.ndarray,
                             skel: Optional[Skeleton] = None,
                             ext_scale: float = 0.00035,
                             extend_mm: float = 250,
                             top_expand_ratio: float = 1.,
                             bot_expand_ratio: float = 0.25,
                             head: str = None) -> np.ndarray:
    """Cylinder (cx, cz, radius, top, bot) around keypoints.

    Matches reference ``get_kp_bounding_cylinder``
    (skeleton_utils.py:542-592).  ``head`` is '-y' for SPIN-estimated
    data, 'z' for SURREAL.
    """
    assert head is not None, 'need the up-axis direction (e.g. "-y" or "z")'
    if head.endswith('z'):
        g_axes, h_axis = [0, 1], 2
    elif head.endswith('y'):
        g_axes, h_axis = [0, 2], 1
    else:
        raise NotImplementedError(f'Head orientation {head} not implemented')
    flip = -1 if head.startswith('-') else 1

    if skel is None:
        skel = get_skeleton_type(kp.shape[-2])

    root_loc = kp[..., skel.root_id, :]
    if kp.ndim == 2:
        dist = np.linalg.norm(kp[:, g_axes] - root_loc[g_axes], axis=-1)
    else:
        dist = np.linalg.norm(kp[..., g_axes] - root_loc[:, None][..., g_axes],
                              axis=-1)
    max_dist = dist.max(-1)
    max_height = (flip * kp[..., h_axis]).max(-1)
    min_height = (flip * kp[..., h_axis]).min(-1)

    extension = extend_mm * ext_scale
    radius = max_dist + extension
    top = flip * (max_height + extension * top_expand_ratio)
    bot = flip * (min_height - extension * bot_expand_ratio)
    return np.stack([root_loc[..., g_axes[0]], root_loc[..., g_axes[1]],
                     radius, top, bot], axis=-1)


def focal_to_intrinsic_np(focal) -> np.ndarray:
    """3x4 intrinsic with the reference's -focal convention."""
    if isinstance(focal, (int, float)) or np.asarray(focal).size < 2:
        fx = fy = float(np.asarray(focal).reshape(-1)[0])
    else:
        fx, fy = np.asarray(focal).reshape(-1)[:2]
    return np.array([[fx, 0, 0, 0],
                     [0, fy, 0, 0],
                     [0, 0, 1, 0]], dtype=np.float32)


def swap_mat(mat: np.ndarray) -> np.ndarray:
    """Swap from NeRF camera convention to extrinsic convention:
    [right, up, back] -> [right, down, forward] (axis flips on y/z)."""
    return np.concatenate([mat[..., 0:1], -mat[..., 1:2], -mat[..., 2:3],
                           mat[..., 3:]], axis=-1)


def nerf_c2w_to_extrinsic(c2w: np.ndarray) -> np.ndarray:
    return np.linalg.inv(swap_mat(c2w))


def cylinder_to_box_2d(cylinder_params: np.ndarray, hwf,
                       w2c: Optional[np.ndarray] = None,
                       scale: float = 1.0, center=None,
                       make_int: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Project cylinder cap circles to a 2D image-space box.

    Matches reference ``cylinder_to_box_2d`` (skeleton_utils.py:607-694):
    sample 50 angles on both cap circles, transform by w2c + intrinsics,
    box the projected points, offset to the principal point, clip.
    Returns (tl, br, pts_2d).
    """
    H, W, focal = hwf
    root_loc, radius = cylinder_params[..., :2], cylinder_params[..., 2:3]
    top, bot = cylinder_params[..., 3:4], cylinder_params[..., 4:5]

    rads = np.linspace(0., 2 * np.pi, 50)
    squeeze = root_loc.ndim == 1
    if squeeze:
        root_loc, radius = root_loc[None], radius[None]
        top, bot = top[None], bot[None]
    N = root_loc.shape[0]

    x = root_loc[..., 0:1] + np.cos(rads)[None] * radius
    z = root_loc[..., 1:2] + np.sin(rads)[None] * radius
    y_top = top * np.ones_like(x)
    y_bot = bot * np.ones_like(x)
    w = np.ones_like(x)

    cap_pts = np.concatenate([np.stack([x, y_top, z, w], axis=-1),
                              np.stack([x, y_bot, z, w], axis=-1)], axis=-2)
    cap_pts = cap_pts.reshape(-1, 4)

    intrinsic = focal_to_intrinsic_np(focal)
    if w2c is not None:
        cap_pts = cap_pts @ w2c.T
    cap_pts = (cap_pts @ intrinsic.T).reshape(N, -1, 3)
    pts_2d = cap_pts[..., :2] / cap_pts[..., 2:3]

    max_xy = pts_2d.max(-2)
    min_xy = pts_2d.min(-2)
    if make_int:
        max_xy = np.ceil(max_xy).astype(np.int32)
        min_xy = np.floor(min_xy).astype(np.int32)

    tl = min_xy.copy()
    br = max_xy.copy()
    if center is None:
        ox, oy = int(W * .5), int(H * .5)
    else:
        ox, oy = int(center[0]), int(center[1])
    tl[:, 0] += ox
    tl[:, 1] += oy
    br[:, 0] += ox
    br[:, 1] += oy

    if scale != 1.0:
        bw = (max_xy[:, 0] - min_xy[:, 0]) * 0.5 * scale
        bh = (max_xy[:, 1] - min_xy[:, 1]) * 0.5 * scale
        cx = (br[:, 0] + tl[:, 0]) * 0.5
        cy = (br[:, 1] + tl[:, 1]) * 0.5
        tl[:, 0], br[:, 0] = cx - bw, cx + bw
        tl[:, 1], br[:, 1] = cy - bh, cy + bh

    tl[:, 0] = np.clip(tl[:, 0], 0, W - 1)
    br[:, 0] = np.clip(br[:, 0], 0, W - 1)
    tl[:, 1] = np.clip(tl[:, 1], 0, H - 1)
    br[:, 1] = np.clip(br[:, 1], 0, H - 1)

    if squeeze:
        tl, br, pts_2d = tl[0], br[0], pts_2d[0]
    return tl, br, pts_2d


def world_to_cam_np(pts: np.ndarray, extrinsic: np.ndarray, H: int, W: int,
                    focal, center=None) -> np.ndarray:
    """Project world points to pixels (for skeleton overlays / eval)."""
    if center is None:
        ox, oy = W * 0.5, H * 0.5
    else:
        ox, oy = center
    pts_h = np.concatenate([pts, np.ones_like(pts[..., :1])], axis=-1)
    cam = pts_h @ extrinsic.T
    intr = focal_to_intrinsic_np(focal)
    proj = cam @ intr.T
    pix = proj[..., :2] / proj[..., 2:3]
    pix[..., 0] += ox
    pix[..., 1] += oy
    return pix
