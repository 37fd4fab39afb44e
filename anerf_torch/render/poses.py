"""Render-time pose/camera generators: bullet-time, retarget,
interpolate, animate, bubble, pose-rotate, correction, selected.

Copy of ``anerf_tpu/render/poses.py`` (reference run_render.py:484-865,
core/load_data.py:45-60), host-side numpy: every generator takes
in-memory ``(kps, bones)`` arrays (the dataset's, or a refined pose
bank's) and returns a render_data dict for
``render.renderer.ImageRenderer.render_path``.  The pose-rotate orbit
converts rotations with the port's tensor functions on the CPU.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from ..ops.fk import get_smpl_l2ws_np
from ..ops.rotations import axisang_to_rot, rot_to_axisang
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


def load_retarget(kps, bones, c2ws, focals, rest_pose, selected_idxs,
                  length: int = 1, skip: int = 1,
                  center_kps: bool = False, undo_rot: bool = False
                  ) -> Dict[str, np.ndarray]:
    """Drive the character with another sequence's poses
    (reference run_render.py:516-563)."""
    selected_idxs = np.asarray(selected_idxs)
    if skip > 1 and length > 1:
        selected_idxs = np.concatenate(
            [np.arange(s, min(s + length, len(c2ws)))[::skip]
             for s in selected_idxs])
    c2ws_out = np.asarray(c2ws)[selected_idxs]
    focals_out = _focals_at(focals, selected_idxs)
    kps = np.asarray(kps)[selected_idxs].copy()
    bones = np.asarray(bones)[selected_idxs].copy()
    if center_kps:
        kps -= kps[..., :1, :].copy()
    if undo_rot:
        bones[..., 0, :] = np.array([1.5708, 0., 0.], np.float32)
    kp_out, skts = _finish(_fk_many(bones, rest_pose), kps[..., :1, :])
    return {'kp3d': kp_out, 'skts': skts, 'bones': bones, 'c2ws': c2ws_out,
            'cam_idxs': selected_idxs, 'focals': focals_out}


def load_interpolate(kps, bones, c2ws, focals, rest_pose, selected_idxs,
                     n_step: int = 10, undo_rot: bool = False,
                     center_cam: bool = False, center_kps: bool = False,
                     mix_framecodes: bool = False
                     ) -> Dict[str, np.ndarray]:
    """Linear interpolation between consecutive selected poses
    (reference run_render.py:664-719).

    ``mix_framecodes=True`` emits ``cam_idxs`` as (n, 3) float rows
    ``[idx_a, idx_b, w]`` so the per-frame appearance code is blended
    with the same weight as the pose — the reference Optcodes' 2-idx
    lerp path (embedding.py:24-28), which its own render catalog never
    exercises (it repeats the first frame's code, run_render.py:718)."""
    selected_idxs = np.asarray(selected_idxs)
    c2ws = np.asarray(c2ws)[selected_idxs].copy()
    if center_cam:
        shift_x = c2ws[..., 0, -1].copy()
        shift_y = c2ws[..., 1, -1].copy()
        c2ws[..., :2, -1] = 0.
    focals = _focals_at(focals, selected_idxs)
    kps = np.asarray(kps)[selected_idxs].copy()
    bones = np.asarray(bones)[selected_idxs].copy()
    if center_kps:
        kps -= kps[..., :1, :].copy()
    elif center_cam:
        kps[..., :, 0] -= shift_x[:, None]
        kps[..., :, 1] -= shift_y[:, None]
    if undo_rot:
        bones[..., 0, :] = np.array([1.5708, 0., 0.], np.float32)

    w = np.linspace(0, 1.0, n_step, endpoint=False).reshape(-1, 1, 1)
    interp = [bones[i:i + 1] * (1 - w) + bones[i + 1:i + 2] * w
              for i in range(len(bones) - 1)]
    interp.append(bones[-1:])
    interp = np.concatenate(interp, axis=0)
    kp_out, skts = _finish(_fk_many(interp, rest_pose), kps[:1, :1, :])
    n = len(kp_out)
    if mix_framecodes:
        # one (idx_a, idx_b, w) row per frame, matching the bone lerp
        w1 = np.linspace(0, 1.0, n_step, endpoint=False)
        rows = [np.stack([np.full(n_step, selected_idxs[i], np.float32),
                          np.full(n_step, selected_idxs[i + 1], np.float32),
                          w1.astype(np.float32)], -1)
                for i in range(len(selected_idxs) - 1)]
        rows.append(np.array([[selected_idxs[-1], selected_idxs[-1], 0.]],
                             np.float32))
        cam_idxs = np.concatenate(rows, 0)
    else:
        cam_idxs = selected_idxs[:1].repeat(n, 0)
    return {'kp3d': kp_out, 'skts': skts, 'bones': interp,
            'c2ws': c2ws[:1].repeat(n, 0),
            'cam_idxs': cam_idxs,
            'focals': focals[:1].repeat(n, 0)}


def load_animate(kps, bones, c2ws, focals, rest_pose, selected_idxs,
                 joints: Sequence[int], n_step: int = 10,
                 undo_rot: bool = False, center_cam: bool = False,
                 center_kps: bool = False) -> Dict[str, np.ndarray]:
    """Interpolate only a subset of joints, keeping the rest at the first
    pose (reference run_render.py:565-623)."""
    selected_idxs = np.asarray(selected_idxs)
    joints = np.asarray(joints)
    c2ws = np.asarray(c2ws)[selected_idxs].copy()
    if center_cam:
        shift_x = c2ws[..., 0, -1].copy()
        shift_y = c2ws[..., 1, -1].copy()
        c2ws[..., :2, -1] = 0.
    focals = _focals_at(focals, selected_idxs)
    kps = np.asarray(kps)[selected_idxs].copy()
    bones = np.asarray(bones)[selected_idxs].copy()
    if center_kps:
        kps -= kps[..., :1, :].copy()
    elif center_cam:
        kps[..., :, 0] -= shift_x[:, None]
        kps[..., :, 1] -= shift_y[:, None]
    if undo_rot:
        bones[..., 0, :] = np.array([1.5708, 0., 0.], np.float32)

    w = np.linspace(0, 1.0, n_step, endpoint=False).reshape(-1, 1, 1)
    interp = [bones[i:i + 1, joints] * (1 - w) + bones[i + 1:i + 2, joints] * w
              for i in range(len(bones) - 1)]
    interp.append(bones[-1:, joints])
    interp = np.concatenate(interp, axis=0)
    base = bones[:1].repeat(len(interp), 0).copy()
    base[:, joints] = interp
    kp_out, skts = _finish(_fk_many(base, rest_pose), kps[:1, :1, :])
    n = len(kp_out)
    return {'kp3d': kp_out, 'skts': skts, 'bones': base,
            'c2ws': c2ws[:1].repeat(n, 0),
            'cam_idxs': selected_idxs[:1].repeat(n, 0),
            'focals': focals[:1].repeat(n, 0)}


def load_pose_rotate(kps, bones, c2ws, focals, rest_pose, selected_idxs,
                     n_bullet: int = 30) -> Dict[str, np.ndarray]:
    """Spin the root joint about y/x/z (reference run_render.py:626-662)."""
    selected_idxs = np.asarray(selected_idxs)
    kps = np.asarray(kps)[selected_idxs].copy()
    bones = np.asarray(bones)[selected_idxs].copy()
    rots = np.zeros((len(bones), 4, 4), np.float32)
    rots[..., :3, :3] = axisang_to_rot(
        torch.as_tensor(bones[..., 0, :], dtype=torch.float32)).numpy()
    rots[..., 3, 3] = 1.
    per_axis = max(n_bullet // 3, 1)
    seq = np.concatenate([generate_bullet_time(rots[0], per_axis, ax)
                          for ax in ('y', 'x', 'z')], 0)
    root_rot = rot_to_axisang(
        torch.as_tensor(seq[:, :3, :3], dtype=torch.float32)).numpy()
    bones = bones.repeat(len(root_rot), 0)
    bones[..., 0, :] = root_rot
    kp_out, skts = _finish(_fk_many(bones, rest_pose),
                           kps[..., :1, :].repeat(len(root_rot), 0))
    c2ws_out = np.asarray(c2ws)[selected_idxs].repeat(len(root_rot), 0)
    focals_out = _focals_at(focals, selected_idxs).repeat(len(root_rot), 0)
    cam_idxs = selected_idxs.repeat(len(root_rot), 0)
    return {'kp3d': kp_out, 'skts': skts, 'bones': bones, 'c2ws': c2ws_out,
            'cam_idxs': cam_idxs, 'focals': focals_out}


def load_correction(init_kps, init_bones, refined_kps, refined_bones,
                    c2ws, focals, rest_pose, selected_idxs,
                    n_step: int = 8) -> Dict[str, np.ndarray]:
    """Morph from the initial (SPIN) pose to the refined pose
    (reference run_render.py:484-514)."""
    selected_idxs = np.asarray(selected_idxs)
    c2ws = np.asarray(c2ws)[selected_idxs]
    focals = _focals_at(focals, selected_idxs)
    ib = np.asarray(init_bones)[selected_idxs]
    rb = np.asarray(refined_bones)[selected_idxs]
    rk = np.asarray(refined_kps)[selected_idxs]

    w = np.linspace(0, 1.0, n_step, endpoint=False).reshape(-1, 1, 1)
    interp = np.concatenate(
        [ib[i][None] * (1 - w) + rb[i][None] * w for i in range(len(ib))], 0)
    l2ws = _fk_many(interp, rest_pose).reshape(
        len(selected_idxs), n_step, 24, 4, 4)
    l2ws[..., :3, -1] += rk[:, None, :1, :]
    l2ws = l2ws.reshape(-1, 24, 4, 4)
    kp_out = l2ws[..., :3, -1].astype(np.float32)
    skts = np.linalg.inv(l2ws).astype(np.float32)
    return {'kp3d': kp_out, 'skts': skts, 'bones': interp,
            'c2ws': c2ws[:, None].repeat(n_step, 1).reshape(-1, 4, 4),
            'cam_idxs': selected_idxs[:, None].repeat(n_step, 1).reshape(-1),
            'focals': focals[:, None].repeat(n_step, 1).reshape(-1)}


def load_selected(kps, bones, c2ws, focals, rest_pose, selected_idxs
                  ) -> Dict[str, np.ndarray]:
    """Re-render selected frames as-is (reference run_render.py:773-798)."""
    selected_idxs = np.asarray(selected_idxs)
    c2ws_out = np.asarray(c2ws)[selected_idxs]
    focals_out = _focals_at(focals, selected_idxs)
    kps = np.asarray(kps)[selected_idxs]
    bones = np.asarray(bones)[selected_idxs]
    kp_out, skts = _finish(_fk_many(bones, rest_pose), kps[..., :1, :])
    return {'kp3d': kp_out, 'skts': skts, 'bones': bones, 'c2ws': c2ws_out,
            'cam_idxs': selected_idxs, 'focals': focals_out}


def load_bubble(kps, bones, c2ws, focals, rest_pose, selected_idxs,
                x_deg: float = 15., y_deg: float = 25., z_t: float = 0.1,
                n_step: int = 5) -> Dict[str, np.ndarray]:
    """Wobbling camera around each selected frame
    (reference run_render.py:800-865)."""
    selected_idxs = np.asarray(selected_idxs)
    x_rad = x_deg * np.pi / 180.
    y_rad = y_deg * np.pi / 180.
    c2ws = np.asarray(c2ws)[selected_idxs].copy()
    c2ws[..., :2, -1] = 0.
    z_t = z_t * c2ws[0, 2, -1]
    focals = _focals_at(focals, selected_idxs)[:, None].repeat(
        n_step, 1).reshape(-1)

    motions = np.linspace(0., 2 * np.pi, n_step, endpoint=True)
    x_motions = (np.cos(motions) - 1.) * x_rad
    y_motions = np.sin(motions) * y_rad
    z_trans = (np.sin(motions) + 1.) * z_t
    cam_motions = [rotate_x(xm) @ rotate_y(ym)
                   for xm, ym in zip(x_motions, y_motions)]
    bubble = []
    for c2w in c2ws:
        for cm, zt in zip(cam_motions, z_trans):
            c = c2w.copy()
            c[2, -1] += zt
            bubble.append(cm @ c)
    c2ws_out = np.array(bubble).reshape(-1, 4, 4)

    kps = np.asarray(kps)[selected_idxs].copy()
    bones = np.asarray(bones)[selected_idxs].copy()
    kps -= kps[..., :1, :].copy()
    kp_out, skts = _finish(_fk_many(bones, rest_pose), kps[..., :1, :])
    n = len(selected_idxs)
    kp_out = kp_out[:, None].repeat(n_step, 1).reshape(n * n_step, -1, 3)
    skts = skts[:, None].repeat(n_step, 1).reshape(n * n_step, -1, 4, 4)
    cam_idxs = selected_idxs[:, None].repeat(n_step, 1).reshape(-1)
    return {'kp3d': kp_out, 'skts': skts,
            'bones': np.repeat(bones, n_step, 0), 'c2ws': c2ws_out,
            'cam_idxs': cam_idxs, 'focals': focals}
