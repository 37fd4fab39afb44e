"""Per-frame pose refinement: the learnable pose bank, its FK, its losses.

Port of ``anerf_tpu/training/pose_opt.py`` (reference core/pose_opt.py
PoseOptLayer :240-445, create_popt :14-83; the in-trainer pose losses,
core/trainer.py:382-441).  The bank is a plain dict {'pelvis': (N, 3),
'bones': (N, J, 3|6)} (plus 'root_bones' under a multiview ``kp_map``);
a batch gathers its rows per ray and FK runs differentiably in the step.

Not ported yet (ROADMAP.md A.5): ``kp_reg_loss_legacy`` and
``pose_params_to_pose_data``, which the FlipFlop scheduler and the
checkpoint export use.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.fk import fk
from ..ops.rotations import axisang_to_rot, rot_to_rot6d
from ..skeleton import Skeleton, SMPLSkeleton


def init_pose_params(kp3d: np.ndarray, bones: np.ndarray,
                     use_rot6d: bool = False,
                     kp_map: Optional[np.ndarray] = None,
                     kp_uidxs: Optional[np.ndarray] = None,
                     skel: Skeleton = SMPLSkeleton,
                     device='cpu') -> Dict[str, Any]:
    """The learnable pose bank from the initial estimates (reference
    ``PoseOptLayer.init_kp_params``, pose_opt.py:276-295)."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    pelvis = t(np.asarray(kp3d)[:, skel.root_id])
    bones = t(bones)
    if use_rot6d:
        bones = rot_to_rot6d(axisang_to_rot(bones))
    if kp_map is None:
        return {'pelvis': pelvis, 'bones': bones}
    root_id = skel.root_id
    return {'pelvis': pelvis,
            'root_bones': bones[:, root_id],
            'bones': bones[torch.as_tensor(np.asarray(kp_uidxs),
                                           device=device)][:, root_id + 1:]}


def gather_bones(pose_params: Dict[str, Any], idxs: torch.Tensor,
                 kp_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-frame full bone tensor (reference ``idx_to_params``,
    pose_opt.py:318-332)."""
    if kp_map is None:
        return pose_params['bones'][idxs]
    root = pose_params['root_bones'][idxs][:, None]
    shared = pose_params['bones'][kp_map[idxs]]
    return torch.cat([root, shared], 1)


def pose_fk(pose_params: Dict[str, Any], idxs: torch.Tensor,
            rest_pose: torch.Tensor, skel: Skeleton = SMPLSkeleton,
            kp_map: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, ...]:
    """Differentiable FK of the indexed frames (reference
    ``PoseOptLayer.calculate_kinematic``, pose_opt.py:372-445).
    Returns (kps, bones, skts, l2ws, rots), each leading dim len(idxs)."""
    pelvis = pose_params['pelvis'][idxs]
    bones = gather_bones(pose_params, idxs, kp_map)
    kps, skts, l2ws, rots = fk(bones, pelvis, rest_pose, skel)
    return kps, bones, skts, l2ws, rots


def make_anchors(kp3d: np.ndarray, bones: np.ndarray,
                 device='cpu') -> Dict[str, torch.Tensor]:
    """Regularization anchors = the initial pose estimates (reference
    create_popt, pose_opt.py:48-72)."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    bones = t(bones)
    return {'kps': t(kp3d), 'bones': bones, 'rots': axisang_to_rot(bones)}


def kp_reg_loss(bones: torch.Tensor, rots: torch.Tensor,
                anchors: Dict[str, torch.Tensor], kp_idx: torch.Tensor,
                tol: float, coef: float, use_rot6d: bool = False,
                per_ray: bool = False) -> torch.Tensor:
    """Tolerance-hinged bone deviation from the anchors, root excluded
    (reference ``Trainer._compute_kp_loss``, trainer.py:388-403):
    squared difference per channel, zero below ``tol``, summed over
    channels, meaned over (rays, joints), times ``coef``;
    ``per_ray`` keeps the (N_rays,) joint means."""
    if use_rot6d:
        reg_bones = rot_to_rot6d(anchors['rots'][kp_idx])
        pred = rot_to_rot6d(rots)
    else:
        reg_bones = anchors['bones'][kp_idx]
        pred = bones
    sq = ((reg_bones - pred) ** 2)[:, 1:]
    hinged = torch.where(sq > tol, sq - tol, torch.zeros_like(sq))
    if per_ray:
        return hinged.sum(-1).mean(-1) * coef
    return hinged.sum(-1).mean() * coef


def temporal_loss(bones: torch.Tensor, kps: torch.Tensor,
                  prev_bones: torch.Tensor, prev_kps: torch.Tensor,
                  next_bones: torch.Tensor, next_kps: torch.Tensor,
                  temp_valid: torch.Tensor, coef: float) -> torch.Tensor:
    """Second-difference smoothness of bones and joints (reference
    trainer.py:407-435); the caller detaches prev/next."""
    ang_vel = ((bones - prev_bones) - (next_bones - bones)) ** 2
    joint_vel = ((kps - prev_kps) - (next_kps - kps)) ** 2
    loss = (ang_vel.sum(-1) + joint_vel.sum(-1)) * temp_valid[..., None]
    return loss.mean() * coef


def mpjpc_stat(kps: torch.Tensor, anchors: Dict[str, torch.Tensor],
               kp_idx: torch.Tensor, ext_scale: float) -> torch.Tensor:
    """Mean per-joint position change from the anchors, in mm
    (reference trainer.py:437-441)."""
    d = torch.linalg.norm(anchors['kps'][kp_idx] - kps.detach(), dim=-1)
    return d.mean() / ext_scale
