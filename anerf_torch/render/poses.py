"""Render-time pose/camera generators (host-side numpy).

Copy of the bullet-time part of ``anerf_tpu/render/poses.py`` (reference
run_render.py:721-771, core/load_data.py:45-60).  The other render
types (retarget, interpolate, animate, bubble, pose-rotate, correction,
selected) are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

from ..ops.fk import get_smpl_l2ws_np
from ..skeleton import rotate_x, rotate_y, rotate_z


def generate_bullet_time(c2w: np.ndarray, n_views: int = 20,
                         axis: str = 'y') -> np.ndarray:
    """Orbit cameras by rotating a base c2w about a world axis
    (reference load_data.py:45-60)."""
    rotate_fn = {'x': rotate_x, 'y': rotate_y, 'z': rotate_z}[axis]
    angles = np.linspace(0, math.radians(360), n_views + 1)[:-1]
    return np.array([rotate_fn(a) @ c2w for a in angles])


def _fk_many(bones: np.ndarray, rest_pose: np.ndarray) -> np.ndarray:
    return np.array([get_smpl_l2ws_np(b, rest_pose, 1.0) for b in bones])


def _finish(l2ws: np.ndarray, root_shift: np.ndarray):
    l2ws = l2ws.copy()
    l2ws[..., :3, -1] += root_shift
    kps = l2ws[..., :3, -1]
    skts = np.linalg.inv(l2ws)
    return kps.astype(np.float32), skts.astype(np.float32)


def _focals_at(focals, idxs):
    if np.isscalar(focals):
        return np.array([focals] * len(idxs), np.float32)
    return np.asarray(focals)[idxs]


def load_bullettime(kps, bones, c2ws, focals, rest_pose, selected_idxs,
                    n_bullet: int = 30, undo_rot: bool = False,
                    center_cam: bool = True, center_kps: bool = True
                    ) -> Dict[str, np.ndarray]:
    """Camera orbit around a centered subject
    (reference run_render.py:721-771)."""
    selected_idxs = np.asarray(selected_idxs)
    c2ws = np.asarray(c2ws)[selected_idxs].copy()
    kps = np.asarray(kps)[selected_idxs].copy()
    bones = np.asarray(bones)[selected_idxs].copy()
    if center_cam:
        shift_x = c2ws[..., 0, -1].copy()
        shift_y = c2ws[..., 1, -1].copy()
        c2ws[..., :2, -1] = 0.
    orbit = generate_bullet_time(c2ws, n_bullet)  # (n_bullet, N, 4, 4)
    c2ws = orbit.transpose(1, 0, 2, 3).reshape(-1, 4, 4)
    focals = _focals_at(focals, selected_idxs)[:, None].repeat(
        n_bullet, 1).reshape(-1)
    cam_idxs = selected_idxs[:, None].repeat(n_bullet, 1).reshape(-1)

    if center_kps:
        kps -= kps[..., :1, :].copy()
    elif center_cam:
        kps[..., :, 0] -= shift_x[:, None]
        kps[..., :, 1] -= shift_y[:, None]
    if undo_rot:
        bones[..., 0, :] = np.array([1.5708, 0., 0.], np.float32)

    kp_out, skts = _finish(_fk_many(bones, rest_pose), kps[..., :1, :])
    n = len(selected_idxs)
    kp_out = kp_out[:, None].repeat(n_bullet, 1).reshape(n * n_bullet, -1, 3)
    skts = skts[:, None].repeat(n_bullet, 1).reshape(n * n_bullet, -1, 4, 4)
    bones_out = np.repeat(bones, n_bullet, 0)
    return {'kp3d': kp_out, 'skts': skts, 'bones': bones_out, 'c2ws': c2ws,
            'cam_idxs': cam_idxs, 'focals': focals}
