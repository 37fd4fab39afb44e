"""Skeleton-relative input encoders in PyTorch.

Port of ``anerf_tpu/ops/encoders.py`` (reference core/encoders.py) for
the encoder types the flagship recipe uses: 'reldist' joint distances,
'reldir' bone directions and 'relray' view directions.  The other
encoder types are not ported yet (ROADMAP.md A.6).
"""
from __future__ import annotations

from typing import Callable, Tuple

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


def vec_norm(vecs, refs=None):
    """L2-normalize the last dim and flatten per-joint vectors
    (reference VecNormEncoder, encoders.py:172-193).  The sample axis of
    per-ray inputs stays a singleton; the caller broadcasts after the
    positional encoding.  ``refs`` is accepted for signature parity."""
    n = vecs / torch.linalg.norm(vecs, dim=-1, keepdim=True).clamp(min=1e-12)
    return n.reshape(n.shape[:2] + (-1,))


def get_kp_input_fn(kp_dist_type: str, n_joints: int
                    ) -> Tuple[Callable, int, int]:
    """Returns (fn(pts, pts_t, kps), input_dims, cutoff_dims)."""
    if kp_dist_type == 'reldist':
        return rel_dist, n_joints, n_joints
    raise NotImplementedError(
        f'kp_dist_type {kp_dist_type!r} is not ported yet (ROADMAP.md)')


def get_view_input_fn(view_type: str, n_joints: int) -> Tuple[Callable, int]:
    """Returns (fn(rays_t, pts_t), view_dims)."""
    if view_type == 'relray':
        return (lambda rays_t, pts_t: vec_norm(rays_t, refs=pts_t),
                n_joints * 3)
    raise NotImplementedError(
        f'view_type {view_type!r} is not ported yet (ROADMAP.md)')


def get_bone_input_fn(bone_type: str, n_joints: int) -> Tuple[Callable, int]:
    """Returns (fn(pts_t, bones), bone_dims)."""
    if bone_type == 'reldir':
        return (lambda pts_t, bones: vec_norm(pts_t)), n_joints * 3
    if bone_type == 'Nope':
        return (lambda pts_t, bones: None), 0
    raise NotImplementedError(
        f'bone_type {bone_type!r} is not ported yet (ROADMAP.md)')
