"""A procedural articulated scene in the data store's schema.

Port of ``anerf_tpu/data/h5_writer.py``'s ``make_synthetic_h5``: for the
same arguments it writes the same arrays, from the same
``RandomState(seed)`` draws in the same order, into a store
(``data/store.py``) instead of an HDF5 file, so the whole train and
render path runs with no real dataset.
"""
from __future__ import annotations

import numpy as np

from ..ops.cylinder import get_kp_bounding_cylinder
from ..ops.fk import get_smpl_l2ws_np
from ..skeleton import SMPL_REST_POSE
from .store import write_store


def make_synthetic_store(store_dir: str, n_frames: int = 6, n_cams: int = 1,
                         H: int = 32, W: int = 32, ext_scale: float = 0.001,
                         seed: int = 0, layout: str = 'frames',
                         body_scale: float = 2.2,
                         blob_radius: int = 1) -> str:
    """A tiny procedural dataset in the reference schema.

    ``layout='surreal'`` arranges images as (N_cams, N_kps) like
    SURREAL; ``'frames'`` is one camera per frame.  ``body_scale``
    multiplies the rest pose (x ext_scale): the default keeps the tiny
    body of the smoke tests; ~450 gives a realistic body (~1.7 units
    tall at the z=2.7 camera) whose joints project ~70 px apart.
    ``blob_radius``: half-size of each joint's colored square.
    """
    rng = np.random.RandomState(seed)
    rest_pose = (SMPL_REST_POSE * ext_scale * body_scale).astype(np.float32)

    bones = rng.normal(scale=0.12, size=(n_frames, 24, 3)).astype(np.float32)
    pelvis = rng.normal(scale=0.03, size=(n_frames, 3)).astype(np.float32)
    l2ws = np.stack([get_smpl_l2ws_np(b, rest_pose) for b in bones])
    l2ws[..., :3, 3] += pelvis[:, None]
    kp3d = l2ws[..., :3, 3].astype(np.float32)
    skts = np.linalg.inv(l2ws).astype(np.float32)
    cyls = get_kp_bounding_cylinder(kp3d, ext_scale=ext_scale,
                                    head='-y').astype(np.float32)

    # one fixed camera looking down -z from z=2.7 (plus orbit cams)
    c2ws = []
    for c in range(n_cams):
        ang = 2 * np.pi * c / max(n_cams, 1) * 0.25
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.array([[np.cos(ang), 0, np.sin(ang)],
                                [0, 1, 0],
                                [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        c2w[:3, 3] = c2w[:3, :3] @ np.array([0., 0., 2.7], np.float32)
        c2ws.append(c2w)
    c2ws = np.array(c2ws)

    if layout == 'surreal':
        n_imgs = n_cams * n_frames
        img_c2ws = np.repeat(c2ws, n_frames, axis=0)
        img_kp = np.tile(np.arange(n_frames), n_cams)
    else:
        n_imgs = n_frames
        img_c2ws = np.broadcast_to(c2ws[0], (n_frames, 4, 4)).copy()
        img_kp = np.arange(n_frames)

    focal = 0.8 * W
    imgs = np.zeros((n_imgs, H, W, 3), np.uint8)
    masks = np.zeros((n_imgs, H, W, 1), np.uint8)
    for i in range(n_imgs):
        kp = kp3d[img_kp[i]]
        w2c = np.linalg.inv(img_c2ws[i])
        cam = (np.concatenate([kp, np.ones_like(kp[:, :1])], -1)
               @ w2c.T)[:, :3]
        # NeRF convention: looking down -z
        px = (cam[:, 0] / -cam[:, 2]) * focal + W * 0.5
        py = (-cam[:, 1] / -cam[:, 2]) * focal + H * 0.5
        r = blob_radius
        for j, (x, y) in enumerate(zip(px, py)):
            xi, yi = int(round(x)), int(round(y))
            y0, y1 = max(yi - r, 0), min(yi + r + 1, H)
            x0, x1 = max(xi - r, 0), min(xi + r + 1, W)
            if y0 < y1 and x0 < x1:
                imgs[i, y0:y1, x0:x1] = (40 + 8 * j, 200 - 6 * j, 120)
                masks[i, y0:y1, x0:x1] = 1

    sampling_masks = np.ones_like(masks)
    bkgds = np.full((1, H, W, 3), 16, np.uint8)
    bkgd_idxs = np.zeros(n_imgs, np.int64)
    img_paths = np.array(
        [f'seq/a/{i:05d}.png'.encode() for i in range(n_imgs)])

    data = {
        'imgs': imgs, 'masks': masks, 'sampling_masks': sampling_masks,
        'bkgds': bkgds, 'bkgd_idxs': bkgd_idxs,
        'kp3d': kp3d, 'gt_kp3d': kp3d, 'bones': bones, 'skts': skts,
        'cyls': cyls, 'rest_pose': rest_pose,
        'betas': np.zeros((1, 10), np.float32),
        'c2ws': img_c2ws.astype(np.float32),
        'focals': np.full(n_imgs, focal, np.float32),
        'img_paths': img_paths,
        'ext_scale': np.float32(ext_scale),
    }
    return write_store(store_dir, data)
