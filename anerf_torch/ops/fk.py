"""Forward kinematics: the differentiable torch FK of the training path
and the host-side numpy FK of scene building.

Port of ``anerf_tpu/ops/fk.py`` (reference core/pose_opt.py:372-445
``calculate_kinematic``, :482-521 ``unrolled_kinematic_chain``;
skeleton_utils.py:334-376 ``get_smpl_l2ws``).  As in the JAX package,
the chain runs level by level (one batched product per level of
``Skeleton.kinematic_levels``) and ``skts`` use the closed-form rigid
inverse (R^T, -R^T t).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..skeleton import Skeleton, SMPLSkeleton, SMPL_REST_POSE
from .rotations import bones_to_rot


def mat_to_hom(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4)."""
    top = torch.cat([rot, trans[..., :, None]], -1)
    # filled on the device: a tensor built from a host list would be a
    # host-to-device copy, which waits for the stream to drain
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=rot.dtype,
                         device=rot.device)
    bottom[..., 3] = 1.
    return torch.cat([top, bottom], -2)


def rigid_inverse(mats: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of rigid (..., 4, 4) transforms."""
    rot_t = mats[..., :3, :3].transpose(-1, -2)
    new_t = -torch.einsum('...ij,...j->...i', rot_t, mats[..., :3, 3])
    return mat_to_hom(rot_t, new_t)


def fk_l2ws(rots: torch.Tensor, rest_pose: torch.Tensor,
            skel: Skeleton = SMPLSkeleton) -> torch.Tensor:
    """Local-to-world transforms (..., J, 4, 4) from per-joint rotations
    (..., J, 3, 3) and the rest pose (..., J, 3) (broadcastable); the
    root sits at ``rest_pose[root]`` (no pelvis shift).  Joints are
    picked by slicing, never by index tensors built on the host: on the
    GPU such a copy would wait for the stream to drain."""
    parent = [int(p) for p in skel.joint_trees]
    root = skel.root_id
    rest_pose = rest_pose.expand(rots.shape[:-2] + (3,))
    joint = lambda a, j: a[..., j, :]
    rel_trans = torch.stack(
        [joint(rest_pose, j) if j == root
         else joint(rest_pose, j) - joint(rest_pose, parent[j])
         for j in range(skel.n_joints)], -2)
    rel = mat_to_hom(rots, rel_trans)
    out = [None] * skel.n_joints
    out[root] = rel[..., root, :, :]
    for level in skel.kinematic_levels()[1:]:
        parents = torch.stack([out[parent[j]] for j in level], -3)
        child = parents @ torch.stack([rel[..., j, :, :] for j in level], -3)
        for i, j in enumerate(level):
            out[j] = child[..., i, :, :]
    return torch.stack(out, -3)


def fk(bones: torch.Tensor, pelvis: torch.Tensor, rest_pose: torch.Tensor,
       skel: Skeleton = SMPLSkeleton
       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable FK: bones (N, J, 3) axis-angle or (N, J, 6) rot6d,
    pelvis (N, 3), rest_pose (J, 3) or (N, J, 3) -> (kps, skts, l2ws,
    rots); the pelvis shift goes into the translation column only."""
    rots = bones_to_rot(bones)
    l2ws = fk_l2ws(rots, rest_pose, skel)
    zeros = lambda *s: torch.zeros(pelvis.shape[:-1] + s, dtype=l2ws.dtype,
                                   device=l2ws.device)
    shift = torch.cat([torch.cat([zeros(3, 3), pelvis[..., :, None]], -1),
                       zeros(1, 4)], -2)
    l2ws = l2ws + shift[..., None, :, :]
    skts = rigid_inverse(l2ws)
    kps = l2ws[..., :3, 3]
    return kps, skts, l2ws, rots


def get_smpl_l2ws_np(pose: np.ndarray, rest_pose: np.ndarray = None,
                     scale: float = 1.,
                     skel: Skeleton = SMPLSkeleton) -> np.ndarray:
    """Numpy FK used by offline data prep / pose generators.

    Matches reference ``get_smpl_l2ws`` (skeleton_utils.py:334-376):
    axis-angle pose (J, 3), scaled rest pose, no pelvis shift.
    """
    from scipy.spatial.transform import Rotation
    if rest_pose is None:
        rest_pose = SMPL_REST_POSE
    rest_kp = rest_pose * scale
    rots = Rotation.from_rotvec(pose.reshape(-1, 3)).as_matrix().astype(
        np.float32).reshape(-1, 3, 3)

    joint_trees = np.asarray(skel.joint_trees)
    l2ws = [None] * skel.n_joints

    def hom(rot, t):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rot
        m[:3, 3] = t
        return m

    root = skel.root_id
    l2ws[root] = hom(rots[root], rest_kp[root])
    for level in skel.kinematic_levels()[1:]:
        for j in level:
            p = joint_trees[j]
            l2ws[j] = l2ws[p] @ hom(rots[j], rest_kp[j] - rest_kp[p])
    return np.stack(l2ws, axis=0)


def get_rest_pose_from_l2ws_np(l2ws: np.ndarray,
                               skel: Skeleton = SMPLSkeleton) -> np.ndarray:
    """Recover rest pose from l2ws (reference skeleton_utils.py:378-395)."""
    joint_trees = np.asarray(skel.joint_trees)
    kp = l2ws[:, :3, -1]
    rest = [None] * skel.n_joints
    rest[skel.root_id] = kp[skel.root_id]
    for level in skel.kinematic_levels()[1:]:
        for j in level:
            p = joint_trees[j]
            rel = l2ws[p, :3, :3].T @ (kp[j] - kp[p])
            rest[j] = rest[p] + rel
    return np.stack(rest, axis=0)
