"""Skeleton-relative input encoders in PyTorch.

Port of ``anerf_tpu/ops/encoders.py`` (reference core/encoders.py):
keypoint encoders 'reldist' (joint distances), 'relpos' (joint offsets),
'cat' (the point and every keypoint) and 'querypts' (the point); view
encoders 'relray' (local ray directions), 'rayangle' (the angle between
local point and ray) and 'world' (local ray directions per sample);
bone encoders 'reldir' (local point directions), 'axisang' (the pose's
bone rotations per sample) and 'Nope'.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def transform_batch_pts(pts: torch.Tensor, skts: torch.Tensor
                        ) -> torch.Tensor:
    """World points -> per-joint local coordinates
    (reference encoders.py:8-23).

    pts: (N_rays, N_samples, 3); skts: (N_rays, J, 4, 4) or (1, J, 4, 4).
    Returns pts_t (N_rays, N_samples, J, 3).
    """
    rot = skts[..., :3, :3]
    trans = skts[..., :3, 3]
    return torch.einsum('rjab,rsb->rsja', rot, pts) + trans[:, None]


def cm_transform_rows(skts: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray world->local transforms as COMPONENT-major row matrices
    ``(rcat (R, 3J, 3), tcat (R, 3J))``: row c*J+j is component c of
    joint j, the fused kernels' channel order, so
    ``p_cm = pts @ rcat^T + tcat``.  The single source of that order."""
    R, J = skts.shape[0], skts.shape[1]
    rot = skts[..., :3, :3]
    rcat = rot.permute(0, 2, 1, 3).reshape(R, 3 * J, 3)
    tcat = skts[..., :3, 3].permute(0, 2, 1).reshape(R, 3 * J)
    return rcat, tcat


def transform_batch_pts_cm(pts: torch.Tensor, skts: torch.Tensor
                           ) -> torch.Tensor:
    """:func:`transform_batch_pts` emitted directly in the fused
    kernels' component-major channel order: (N_rays, N_samples, 3J),
    channel c*J+j = component c of joint j's local coordinates."""
    rcat, tcat = cm_transform_rows(skts)
    return torch.einsum('rsd,rkd->rsk', pts, rcat) + tcat[:, None]


def transform_batch_rays(rays_d: torch.Tensor, skts: torch.Tensor
                         ) -> torch.Tensor:
    """Ray directions -> per-joint local frame, rotation only
    (reference encoders.py:25-37).  rays_d (N_rays, 1, 3) ->
    (N_rays, 1, J, 3)."""
    rot = skts[..., :3, :3]
    return torch.einsum('rjab,rsb->rsja', rot, rays_d)


def rel_dist(pts, pts_t, kps):
    """Per-joint distance (N_rays, N_samples, J)
    (reference RelDistEncoder, encoders.py:101-122)."""
    if pts_t is not None:
        return torch.linalg.norm(pts_t, dim=-1)
    return torch.linalg.norm(pts[:, :, None] - kps[:, None], dim=-1)


def rel_pos(pts, pts_t, kps):
    """Per-joint offsets flattened joint-major: (N_rays, N_samples, J*3)
    (reference RelPosEncoder, encoders.py:124-142)."""
    if pts_t is not None:
        return pts_t.reshape(pts_t.shape[:-2] + (-1,))
    d = pts[:, :, None] - kps[:, None]
    return d.reshape(d.shape[:-2] + (-1,))


def kp_cat(pts, pts_t, kps):
    """The world point and every keypoint: (..., 3 + J*3)
    (reference KPCatEncoder, encoders.py:144-169)."""
    flat_kps = kps[:, None].expand(pts.shape[:2] + kps.shape[-2:])
    flat_kps = flat_kps.reshape(flat_kps.shape[:-2] + (-1,))
    return torch.cat([pts, flat_kps], -1)


def identity_pts(pts, pts_t, kps):
    """The raw query points (reference IdentityEncoder,
    encoders.py:57-68)."""
    return pts


def vec_norm(vecs, refs=None):
    """L2-normalize the last dim and flatten per-joint vectors
    (reference VecNormEncoder, encoders.py:172-193).  The sample axis of
    per-ray inputs stays a singleton; the caller broadcasts after the
    positional encoding.  ``refs`` is accepted for signature parity."""
    n = vecs / torch.linalg.norm(vecs, dim=-1, keepdim=True).clamp(min=1e-12)
    return n.reshape(n.shape[:2] + (-1,))


def ray_ang(rays_t, pts_t):
    """The angle between local point and local ray direction, minus
    pi/2: (N_rays, N_samples, J) (reference RayAngEncoder ->
    calculate_angle, encoders.py:195-212, skeleton_utils.py:594-605)."""
    dot = (pts_t * rays_t).sum(-1)
    na = torch.linalg.norm(pts_t, dim=-1)
    nb = torch.linalg.norm(rays_t, dim=-1)
    cos = torch.clamp(dot / (na * nb), -1. + 1e-6, 1. - 1e-6)
    return torch.arccos(cos) - 0.5 * np.pi


def identity_expand(x, refs):
    """A per-ray feature broadcast across the samples of ``refs``
    (reference IdentityExpandEncoder, encoders.py:71-79)."""
    flat = x.reshape(x.shape[0], 1, -1)
    return flat.expand(refs.shape[:2] + flat.shape[-1:])


def get_kp_input_fn(kp_dist_type: str, n_joints: int
                    ) -> Tuple[Callable, int, int]:
    """Returns (fn(pts, pts_t, kps), input_dims, cutoff_dims)."""
    if kp_dist_type == 'reldist':
        return rel_dist, n_joints, n_joints
    if kp_dist_type == 'relpos':
        return rel_pos, n_joints * 3, n_joints
    if kp_dist_type == 'cat':
        return kp_cat, n_joints * 3 + 3, n_joints
    if kp_dist_type == 'querypts':
        return identity_pts, 3, 3
    raise NotImplementedError(f'{kp_dist_type} is not implemented.')


def get_view_input_fn(view_type: str, n_joints: int) -> Tuple[Callable, int]:
    """Returns (fn(rays_t, pts_t), view_dims)."""
    if view_type == 'relray':
        return (lambda rays_t, pts_t: vec_norm(rays_t, refs=pts_t),
                n_joints * 3)
    if view_type == 'rayangle':
        return ray_ang, n_joints
    if view_type == 'world':
        return (lambda rays_t, pts_t: identity_expand(rays_t, pts_t),
                n_joints * 3)
    raise NotImplementedError(f'{view_type} is not implemented.')


def get_bone_input_fn(bone_type: str, n_joints: int) -> Tuple[Callable, int]:
    """Returns (fn(pts_t, bones), bone_dims)."""
    if bone_type == 'reldir':
        return (lambda pts_t, bones: vec_norm(pts_t)), n_joints * 3
    if bone_type == 'axisang':
        return ((lambda pts_t, bones: identity_expand(bones, pts_t)),
                n_joints * 3)
    if bone_type == 'Nope':
        return (lambda pts_t, bones: None), 0
    raise NotImplementedError(f'{bone_type} bone function is not implemented')
