"""Rotation representations in PyTorch.

Port of ``anerf_tpu/ops/rotations.py`` (which replaces the reference's
pytorch3d calls, core/utils/skeleton_utils.py:397-436) for what the
training and rendering paths need: axis-angle and 6D rotations to
matrices, and matrices back to 6D, quaternions and axis-angle.  Every
function takes arbitrary leading batch dimensions.
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


def rot_to_axisang(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), through the
    quaternion for stability (pytorch3d's ``matrix_to_axis_angle``,
    reference skeleton_utils.py:405-406).  At an angle of pi the axis's
    sign is arbitrary: both signs give the same rotation."""
    return quat_to_axisang(rot_to_quat(rot))


def rot_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (w, x, y, z) with
    w >= 0.  Of the four closed forms (each a multiple of the quaternion
    by 2 sqrt(1 + a diagonal term)) each element takes the one whose
    diagonal term is largest."""
    m = rot
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    trace = m00 + m11 + m22
    cases = torch.stack([
        torch.stack([1.0 + trace, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                     m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                     m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21,
                     1.0 - m00 - m11 + m22], -1),
    ], -2)                                              # (..., 4, 4)
    best = torch.stack([trace, m00, m11, m22], -1).argmax(-1)
    q = torch.take_along_dim(cases, best[..., None, None].expand(
        best.shape + (1, 4)), dim=-2)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_to_axisang(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) (..., 4) -> axis-angle (..., 3); a
    series for theta / sin(theta / 2) below |xyz| = 1e-6."""
    w = quat[..., 0].clamp(-1.0, 1.0)
    xyz = quat[..., 1:]
    norm = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    half = torch.atan2(norm[..., 0], w)[..., None]
    scale = torch.where(norm < 1e-6, 2.0 + (2.0 / 3.0) * half * half,
                        2.0 * half / norm.clamp(min=1e-12))
    return xyz * scale


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


def rot6d_to_axisang(x: torch.Tensor) -> torch.Tensor:
    """6D rotation (..., 6) -> axis-angle (..., 3)."""
    return rot_to_axisang(rot6d_to_rotmat(x))


def bones_to_rot(bones: torch.Tensor) -> torch.Tensor:
    """Dispatch on the representation's width (reference
    skeleton_utils.py:397-403)."""
    if bones.shape[-1] == 3:
        return axisang_to_rot(bones)
    if bones.shape[-1] == 6:
        return rot6d_to_rotmat(bones)
    raise NotImplementedError(f'unknown bone rep dim {bones.shape[-1]}')
