"""Rotation representations in PyTorch.

Port of ``anerf_tpu/ops/rotations.py`` (which replaces the reference's
pytorch3d calls, core/utils/skeleton_utils.py:397-436) for what the
training path needs: axis-angle and 6D rotations to matrices and back to
6D.  Every function takes arbitrary leading batch dimensions.
"""
from __future__ import annotations

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix, (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


def axisang_to_rot(axisang: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3).

    Rodrigues' formula with a Taylor series below theta^2 = 1e-8, so
    values and gradients stay finite at theta -> 0.  The series branch
    guards the other branch's inputs, or its unused gradient would be
    NaN where the series is selected (the where-NaN trap).
    """
    theta_sq = (axisang * axisang).sum(-1)
    small = theta_sq < 1e-8
    theta_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(theta_sq_safe)
    sin_over = torch.where(small, 1.0 - theta_sq / 6.0,
                           torch.sin(theta) / theta)
    cos_over = torch.where(small, 0.5 - theta_sq / 24.0,
                           (1.0 - torch.cos(theta)) / theta_sq_safe)
    k = skew(axisang)
    eye = torch.eye(3, dtype=axisang.dtype, device=axisang.device)
    return eye + sin_over[..., None, None] * k \
        + cos_over[..., None, None] * (k @ k)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation (..., 6) -> (..., 3, 3) by Gram-Schmidt (Zhou et al.,
    CVPR'19), in the reference's layout: the 6D vector is
    ``rot[..., :3, :2]`` flattened row-major (two column vectors
    interleaved)."""
    m = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = m[..., 0], m[..., 1]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp(min=1e-12)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp(min=1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], -1)


def rot_to_rot6d(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> 6D representation (..., 6)."""
    return rot[..., :3, :2].reshape(rot.shape[:-2] + (6,))


def bones_to_rot(bones: torch.Tensor) -> torch.Tensor:
    """Dispatch on the representation's width (reference
    skeleton_utils.py:397-403)."""
    if bones.shape[-1] == 3:
        return axisang_to_rot(bones)
    if bones.shape[-1] == 6:
        return rot6d_to_rotmat(bones)
    raise NotImplementedError(f'unknown bone rep dim {bones.shape[-1]}')
