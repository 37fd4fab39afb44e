"""Synthetic SURREAL-recipe scenes for the tests and ``chip_smoke.py``.

Numpy copies of ``anerf_tpu/testing_utils.py`` (surreal_config,
synthetic_pose, synthetic_batch): the SURREAL recipe (reference
configs/surreal/surreal.txt: 8x256 MLP, 64+16 samples, cutoff PE with
multires 7/4, framecodes) on synthetic poses and rays, so runs need no
dataset.  Arrays come back as numpy; ``to_device`` moves a batch.
``build_flagship`` assembles the whole training setup on them, with one
subject or several (``ConcatH5Dataset``'s layout: a rest pose per
subject, each frame's subject in ``rest_pose_idxs``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .ops.cylinder import get_kp_bounding_cylinder
from .ops.fk import get_smpl_l2ws_np
from .skeleton import SMPL_REST_POSE
from .utils.config import Config


def surreal_config(**overrides) -> Config:
    base = dict(
        dataset_type=('surreal',), subject=('female',),
        use_background=True, fg_ratio=1.0, ext_scale=0.001,
        bone_type='reldir', kp_dist_type='reldist', view_type='relray',
        use_cutoff=True, cutoff_viewdir=True, cutoff_inputs=True,
        use_viewdirs=True, image_batching=True, N_sample_images=128,
        netwidth=256, multires=7, multires_views=4,
        N_rand=2048, N_samples=64, N_importance=16,
        n_iters=150000, lrate_decay=500, raw_noise_std=1.0,
        opt_framecode=True,
    )
    base.update(overrides)
    return Config(**base)


# rest-pose scales of the synthetic subjects: SMPL's rest pose x 2.2
# (the single subject), then a smaller second one
REST_SCALES = (2.2, 2.0)


def subject_of_frame(n_frames: int, n_subjects: int) -> np.ndarray:
    """Each frame's subject: the frames split in order into
    ``n_subjects`` runs of (nearly) equal length."""
    return (np.arange(n_frames) * n_subjects // n_frames).astype(np.int32)


def synthetic_pose(n_frames: int = 9, seed: int = 0,
                   ext_scale: float = 0.001, n_subjects: int = 1):
    """(rest, bones, pelvis, kps, skts, cyls) for ``n_frames`` random
    SMPL poses drawn from ``seed``.  With ``n_subjects > 1`` rest is
    (n_subjects, J, 3), one per ``REST_SCALES`` entry, and each frame's
    FK takes its subject's rest pose (``subject_of_frame``)."""
    rng = np.random.RandomState(seed)
    rests = np.stack([SMPL_REST_POSE * ext_scale * s
                      for s in REST_SCALES[:n_subjects]]).astype(np.float32)
    subj = subject_of_frame(n_frames, n_subjects)
    bones = rng.normal(scale=0.15, size=(n_frames, 24, 3)).astype(np.float32)
    pelvis = rng.normal(scale=0.05, size=(n_frames, 3)).astype(np.float32)
    l2ws = np.stack([get_smpl_l2ws_np(b, rests[i])
                     for b, i in zip(bones, subj)])
    l2ws[..., :3, 3] += pelvis[:, None]
    kps = l2ws[..., :3, 3].astype(np.float32)
    skts = np.linalg.inv(l2ws).astype(np.float32)
    cyls = get_kp_bounding_cylinder(kps, ext_scale=ext_scale,
                                    head='-y').astype(np.float32)
    rest = rests[0] if n_subjects == 1 else rests
    return rest, bones, pelvis, kps, skts, cyls


def synthetic_batch(n_rays: int, n_frames: int, kps, skts, bones, cyls,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """Rays from (0, 0, 2.7) looking down -z, each on a random frame."""
    rng = np.random.RandomState(seed)
    kp_idx = rng.randint(0, n_frames, size=(n_rays,))
    th = rng.uniform(-0.15, 0.15, size=(n_rays, 2)).astype(np.float32)
    rays_d = np.stack([th[:, 0], th[:, 1], -np.ones(n_rays, np.float32)], -1)
    return {
        'rays_o': np.tile([[0., 0., 2.7]], (n_rays, 1)).astype(np.float32),
        'rays_d': rays_d,
        'target_s': rng.uniform(0, 1, (n_rays, 3)).astype(np.float32),
        'fgs': np.ones((n_rays, 1), np.float32),
        'bgs': np.full((n_rays, 3), 0.5, np.float32),
        'cyls': cyls[kp_idx],
        'kp_idx': kp_idx.astype(np.int32),
        'cam_idxs': kp_idx.astype(np.int32),
        'temp_val': np.ones((n_rays,), np.float32),
        'kps': kps[kp_idx],
        'skts': skts[kp_idx],
        'bones': bones[kp_idx],
    }


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                             torch.Tensor]:
    """Numpy batch -> tensors on ``device`` (integers as int64)."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        dt = torch.long if np.issubdtype(v.dtype, np.integer) \
            else torch.float32
        out[k] = torch.as_tensor(v, device=device).to(dt)
    return out


def build_flagship(n_rays: int = 2048, n_frames: int = 9,
                   n_subjects: int = 1, opt_pose: bool = True, device=None,
                   **cfg_overrides):
    """The SURREAL-recipe training setup on synthetic data, the
    counterpart of ``anerf_tpu.testing_utils.build_flagship``: pose
    refinement every 20 steps with kp loss 0.1 when ``opt_pose``.
    ``n_subjects > 1`` splits the frames between that many subjects of
    different rest poses (``synthetic_pose``); the model then has the
    subject channel, and the batch its ``subject_idxs``.
    ``device=None`` means the GPU and raises without one.  Returns
    (setup, state, batch, train_step); the parameters come from a CPU
    ``torch.Generator`` seeded with ``cfg.seed``."""
    from .models.factory import build_raycast_config
    from .skeleton import SMPLSkeleton
    from .training import pose_opt as P
    from .training.trainer import (TrainSetup, init_train_state,
                                   make_train_step)
    cfg = surreal_config(opt_pose=opt_pose, N_rand=n_rays,
                         opt_pose_step=20 if opt_pose else 1,
                         opt_pose_coef=0.1 if opt_pose else 0.0,
                         **cfg_overrides)
    rest, bones, pelvis, kps, skts, cyls = synthetic_pose(
        n_frames, ext_scale=cfg.ext_scale, n_subjects=n_subjects)
    rc = build_raycast_config(cfg, n_framecodes=n_frames,
                              n_subjects=n_subjects)
    subj = subject_of_frame(n_frames, n_subjects) if n_subjects > 1 else None
    setup = TrainSetup(cfg=cfg, rc=rc, skel=SMPLSkeleton, rest_pose=rest,
                       anchors=P.make_anchors(kps, bones),
                       rest_pose_idxs=subj, near=0.0, far=1.0, device=device)
    state = init_train_state(setup, torch.Generator().manual_seed(cfg.seed),
                             init_kp3d=kps, init_bones=bones)
    batch = synthetic_batch(n_rays, n_frames, kps, skts, bones, cyls)
    if subj is not None:
        batch['subject_idxs'] = subj[batch['kp_idx']]
    return setup, state, to_device(batch, setup.device), make_train_step(setup)
