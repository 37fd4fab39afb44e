"""Per-frame pose refinement: the learnable pose bank, its FK, its losses.

Port of ``anerf_tpu/training/pose_opt.py`` (reference core/pose_opt.py
PoseOptLayer :240-445, create_popt :14-83; the in-trainer pose losses,
core/trainer.py:382-441).  The bank is a plain dict {'pelvis': (N, 3),
'bones': (N, J, 3|6)} (plus 'root_bones' under a multiview ``kp_map``);
a batch gathers its rows per ray and FK runs differentiably in the step.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.fk import fk
from ..ops.rotations import axisang_to_rot, rot6d_to_axisang, rot_to_rot6d
from ..skeleton import Skeleton, SMPLSkeleton


def init_pose_params(kp3d: np.ndarray, bones: np.ndarray,
                     use_rot6d: bool = False,
                     kp_map: Optional[np.ndarray] = None,
                     kp_uidxs: Optional[np.ndarray] = None,
                     skel: Skeleton = SMPLSkeleton,
                     device='cpu') -> Dict[str, Any]:
    """The learnable pose bank from the initial estimates (reference
    ``PoseOptLayer.init_kp_params``, pose_opt.py:276-295).  The bank owns
    its memory: it is updated in place, and must not write through to
    the caller's arrays or to anchors made from them."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
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
    create_popt, pose_opt.py:48-72), copies of the caller's arrays."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
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


def kp_reg_loss_legacy(preds: Dict[str, torch.Tensor],
                       regs: Dict[str, torch.Tensor],
                       opt_pose_type: str = 'B',
                       opt_pose_tol: float = 0.,
                       opt_pose_coef: float = 1.0,
                       use_rot6d: bool = False,
                       temp_coef: float = 0.,
                       use_temp_vel: bool = False,
                       ext_scale: float = 0.001,
                       gt_kps: Optional[torch.Tensor] = None,
                       root_id: int = 0) -> Dict[str, torch.Tensor]:
    """The reference's richer pose-regularization family
    (``get_kp_reg_loss``, pose_opt.py:124-201).  ``opt_pose_type``:

      * ``B…``: bone-space loss against the anchor bones (their rot6d
        when ``use_rot6d``), plus a pelvis-position term;
      * ``RD…``: rotation-matrix loss against the anchor rotations;
      * ``…L1`` anywhere: L1 instead of the squared error;
      * ``…E``: the coefficient not on the global sum: only the non-root
        bone terms are kept (no pelvis term).

    ``preds``/``regs`` need {'kps', 'bones', 'rots'}; ``regs`` may add
    {'temp_bones', 'temp_kps', 'temp_rots', 'temp_valid',
    'temp_valid_next'} (previous and next frames stacked on dim 0) for
    the temporal terms.  Returns {'kp_loss', 'temp_loss', 'mpjpc'} and,
    given ``gt_kps``, 'kp_gt_dist'.
    """
    kps, bones, rots = preds['kps'], preds['bones'], preds['rots']
    reg_kps, reg_bones, reg_rots = regs['kps'], regs['bones'], regs['rots']
    if 'L1' in opt_pose_type:
        loss_fn = lambda a, b: (a - b).abs()      # noqa: E731
    else:
        loss_fn = lambda a, b: (a - b) ** 2       # noqa: E731
    if use_rot6d:
        reg_bones = rot_to_rot6d(reg_rots)
    if opt_pose_type.startswith('RD'):
        # (N, J, 3, 3): hinged and summed over the last axis only, so the
        # row axis stays in the mean, as in the reference
        bone_loss = loss_fn(rots, reg_rots)
    elif opt_pose_type.startswith('B'):
        bone_loss = loss_fn(reg_bones, bones)
    else:
        raise NotImplementedError(
            f'opt_pose_type {opt_pose_type}: regularization target '
            'un-specified')
    pelv_loss = loss_fn(reg_kps[:, root_id], kps[:, root_id]).sum(-1)
    # hinge: 0 below tol, loss - tol above (pose_opt.py:156-160)
    mask = (bone_loss > opt_pose_tol).to(bone_loss.dtype)
    bone_loss = ((bone_loss - opt_pose_tol) * mask).sum(-1)
    if 'E' not in opt_pose_type:
        kp_loss = (bone_loss.mean() + pelv_loss.mean()) * opt_pose_coef
    else:
        kp_loss = bone_loss[:, root_id + 1:].mean() * opt_pose_coef

    temp_loss = torch.zeros((), dtype=kp_loss.dtype, device=kp_loss.device)
    if temp_coef > 0. and 'temp_bones' in regs:
        temp_valid = regs['temp_valid']
        temp_bones = (rot_to_rot6d(regs['temp_rots']) if use_rot6d
                      else regs['temp_bones'])
        prev_bones, next_bones = torch.chunk(temp_bones, 2, 0)
        prev_kps, next_kps = torch.chunk(regs['temp_kps'], 2, 0)
        if not use_temp_vel:
            t = loss_fn(prev_bones, bones).sum(-1)
            temp_loss = (t * temp_valid[..., None]).mean() * temp_coef
        else:
            valid = torch.div(temp_valid + regs['temp_valid_next'], 2,
                              rounding_mode='floor')
            ang_vel = ((bones - prev_bones) - (next_bones - bones)) ** 2
            joint_vel = ((kps - prev_kps) - (next_kps - kps)) ** 2
            t = ang_vel.sum(-1) + joint_vel.sum(-1)
            temp_loss = (t * valid[..., None]).mean() * temp_coef
        kp_loss = kp_loss + temp_loss
    # the whole difference detached (reference trainer.py:437-441)
    mpjpc = ((reg_kps - kps).detach() ** 2).sum(-1).sqrt().mean() / ext_scale
    out = {'kp_loss': kp_loss, 'temp_loss': temp_loss, 'mpjpc': mpjpc}
    if gt_kps is not None:
        out['kp_gt_dist'] = torch.linalg.norm(
            kps.detach() - gt_kps, dim=-1).mean() / ext_scale
    return out


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


def pose_params_to_pose_data(pose_params: Dict[str, Any],
                             rest_pose: np.ndarray,
                             ext_scale: float = 0.001,
                             skel: Skeleton = SMPLSkeleton,
                             kp_map: Optional[np.ndarray] = None,
                             ) -> Tuple[np.ndarray, ...]:
    """(kp3d, bones, skts, cyls, rest_pose, pelvis) numpy arrays of
    every frame of a refined pose bank (numpy arrays or tensors), for
    refined renders; rot6d bones come back as axis-angle (reference
    ``pose_ckpt_to_pose_data``, pose_opt.py:523-559).  FK runs on the
    CPU."""
    from ..ops.cylinder import get_kp_bounding_cylinder

    bank = {k: torch.as_tensor(np.asarray(
        v.detach().cpu() if torch.is_tensor(v) else v, np.float32))
        for k, v in pose_params.items()}
    idxs = torch.arange(bank['pelvis'].shape[0])
    kmap = None if kp_map is None else torch.as_tensor(np.asarray(kp_map))
    with torch.no_grad():
        kps, bones, skts, _, _ = pose_fk(
            bank, idxs, torch.as_tensor(np.asarray(rest_pose, np.float32)),
            skel, kmap)
        bones_aa = bones if bones.shape[-1] == 3 else rot6d_to_axisang(bones)
    kp3d = kps.numpy().astype(np.float32)
    cyls = get_kp_bounding_cylinder(kp3d, ext_scale=ext_scale, skel=skel,
                                    extend_mm=250, head='-y').astype(
        np.float32)
    return (kp3d, bones_aa.numpy().astype(np.float32),
            skts.numpy().astype(np.float32), cyls,
            np.asarray(rest_pose, np.float32),
            bank['pelvis'].numpy())
