"""SPIN estimate ingestion: convert per-frame SPIN/VIBE outputs (shape
betas, weak-perspective cameras, joint rotation matrices, crop bboxes)
into the data store's pose schema (kp3d / bones / skts / cyls /
rest_pose / c2ws / focals).

The port's copy of ``anerf_tpu/data/spin.py``: offline preprocessing on
the host, numpy with the rotation-to-axis-angle step through the port's
``ops/rotations`` on the CPU (reference core/process_spin.py:14-232
uses torch + torchgeometry + smplx; only the SMPL rest-pose-from-betas
step needs the SMPL body model, so that one is gated on the optional
``smplx`` package, and a precomputed ``rest_pose`` can be supplied
instead).
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ..ops.cylinder import get_kp_bounding_cylinder, swap_mat
from ..ops.fk import get_smpl_l2ws_np
from ..skeleton import SMPL_REST_POSE, SMPLSkeleton, Skeleton

# the reference datasets store poses at SURREAL scale; SPIN estimates are
# rescaled by this factor before ext_scale (process_spin.py:190)
DATASET_EXT_SCALE = 0.25 / 0.00035


def calculate_bone_length(pose: np.ndarray,
                          skel: Skeleton = SMPLSkeleton) -> np.ndarray:
    """Per-bone lengths of a (J, 3) pose (reference
    skeleton_utils.py:528-539)."""
    parents = np.asarray(skel.joint_trees)
    nonroot = np.asarray(skel.nonroot_id)
    return np.linalg.norm(pose[nonroot] - pose[parents[nonroot]], axis=-1)


def rot_to_axisang_np(rots: np.ndarray) -> np.ndarray:
    """Batched (..., 3, 3) -> (..., 3) axis-angle, numpy in and out,
    through ``ops/rotations.rot_to_axisang`` on the CPU (replaces
    torchgeometry.rotation_matrix_to_angle_axis)."""
    import torch

    from ..ops.rotations import rot_to_axisang
    rots = np.asarray(rots, np.float32)
    return rot_to_axisang(torch.from_numpy(rots.reshape(-1, 3, 3).copy())
                          ).numpy().reshape(*rots.shape[:-2], 3)


def convert_crop_cam_to_orig_img_and_focal(
        cam: np.ndarray, bbox: np.ndarray,
        img_width: int, img_height: int, focal: float = 5000.,
        resized_width: int = 224, resized_height: int = 224,
        new_focal: Optional[float] = None) -> np.ndarray:
    """Undo the SPIN crop: weak-perspective camera in crop coordinates
    -> [focal, tx, ty, cz] in the original image (VIBE-style; reference
    process_spin.py:46-98).  ``bbox`` rows are (cx, cy, h) square crops.
    """
    cam = np.asarray(cam, np.float64)
    bbox = np.asarray(bbox, np.float64)
    cz = 2 * focal / (resized_width * cam[:, 0])
    cx, cy, h = bbox[:, 0], bbox[:, 1], bbox[:, 2]
    hw, hh = img_width / 2., img_height / 2.
    f = h / resized_width * focal
    sx = cam[:, 0] * (1. / (img_width / h))
    sy = cam[:, 0] * (1. / (img_height / h))
    tx = ((cx - hw) / hw / sx) + cam[:, 1]
    ty = ((cy - hh) / hh / sy) + cam[:, 2]
    if new_focal is not None:
        cz = cz * new_focal / f
        f = np.full_like(f, new_focal)
    return np.stack([f, tx, ty, cz], axis=-1).astype(np.float32)


def pred_cams_to_orig_cam_params(
        cameras: np.ndarray, bboxes: np.ndarray,
        img_width: int = 512, img_height: int = 512,
        resized_width: int = 224, resized_height: int = 224,
        focal: float = 5000., ext_scale: float = 1.0,
        new_focal: Optional[float] = None
        ) -> Tuple[np.ndarray, np.ndarray]:
    """(focals, c2ws in NeRF convention) from SPIN weak-persp cameras
    (reference process_spin.py:157-179)."""
    orig = convert_crop_cam_to_orig_img_and_focal(
        cameras, bboxes, img_width=img_width, img_height=img_height,
        resized_width=resized_width, resized_height=resized_height,
        focal=focal, new_focal=new_focal)
    focals = orig[:, 0]
    cam_t = orig[:, 1:] * ext_scale
    c2ws = np.eye(4, dtype=np.float32)[None].repeat(len(orig), 0)
    c2ws[:, :3, -1] = -cam_t
    return focals.astype(np.float32), swap_mat(c2ws)


def rest_pose_from_betas(betas: np.ndarray,
                         gender: str = 'NEUTRAL',
                         smpl_model_path: str = 'smpl',
                         ) -> np.ndarray:
    """Mean zero-pose SMPL joint locations for the given shape betas,
    pelvis-centered (reference process_spin.py:110-127).  Requires the
    optional ``smplx`` package + SMPL model files."""
    try:
        import torch
        from smplx import SMPL
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError(
            'rest_pose_from_betas needs the optional smplx package and an '
            'SMPL model file; pass a precomputed rest_pose to '
            'process_spin_data instead') from e
    betas_t = torch.as_tensor(np.asarray(betas, np.float32))
    with torch.no_grad():
        dummy = torch.eye(3).view(1, 1, 3, 3).expand(len(betas_t), 24, 3, 3)
        smpl = SMPL(f'{smpl_model_path}/SMPL_{gender}.pkl',
                    joint_mapper=lambda joints: joints[:, :24])
        out = smpl(betas=betas_t, body_pose=dummy[:, 1:],
                   global_orient=dummy[:, :1], pose2rot=False)
    rest = out.joints.cpu().numpy()
    rest -= rest[:, 0:1]
    return rest.mean(0)


def get_keypoints_from_rotmats(
        rot_mats: np.ndarray, joints: np.ndarray, rest_pose: np.ndarray,
        ext_scale: float = 1.0, align_joint_idx: int = 8,
        ref_pose: np.ndarray = SMPL_REST_POSE,
        scale_rest_pose: bool = True,
        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """FK the per-frame SPIN rotations into world poses, with the rest
    pose rescaled so its mean bone length matches the canonical SMPL
    rest pose at ``ext_scale`` (reference process_spin.py:99-155,
    get_keypoints_from_betas minus the betas->rest_pose step).

    Returns (kp3d, bones, skts, scaled_rest_pose, pose_scale).
    """
    rest_pose = np.asarray(rest_pose, np.float32)
    if scale_rest_pose:
        ref = np.asarray(ref_pose, np.float32) * ext_scale
        pose_scale = (calculate_bone_length(ref).mean()
                      / calculate_bone_length(rest_pose).mean())
    else:
        pose_scale = 1.0
    rest_pose = rest_pose * pose_scale

    pelvis = np.asarray(joints, np.float32)[:, align_joint_idx] * pose_scale
    bones = rot_to_axisang_np(np.asarray(rot_mats, np.float32))
    l2ws = np.stack([get_smpl_l2ws_np(b, rest_pose=rest_pose)
                     for b in bones])
    l2ws[:, :, :3, -1] += pelvis[:, None]
    kp3d = l2ws[:, :, :3, -1].copy()
    skts = np.linalg.inv(l2ws)
    return (kp3d.astype(np.float32), bones.astype(np.float32),
            skts.astype(np.float32), rest_pose, float(pose_scale))


def process_spin_data(betas: Optional[np.ndarray],
                      cameras: np.ndarray,
                      joints: np.ndarray,
                      rot_mats: np.ndarray,
                      bboxes: np.ndarray,
                      rest_pose: Optional[np.ndarray] = None,
                      ref_pose: np.ndarray = SMPL_REST_POSE,
                      align_joint_idx: int = 8,
                      focal: float = 5000.,
                      res: Any = 512,
                      resized_res: int = 224,
                      ext_scale: float = 0.001,
                      dataset_ext_scale: float = 0.25 / 0.00035,
                      scale_rest_pose: bool = True,
                      new_focal: Optional[float] = None,
                      skel_type: Skeleton = SMPLSkeleton,
                      smpl_model_path: str = 'smpl',
                      ) -> Dict[str, np.ndarray]:
    """Full SPIN->h5-schema conversion (reference
    process_spin.py:183-233).  Either ``rest_pose`` (J,3) is given, or
    ``betas`` + the optional smplx package derive it."""
    res_H, res_W = (res, res) if isinstance(res, int) else res
    ext_scale = ext_scale * dataset_ext_scale

    if rest_pose is None:
        rest_pose = rest_pose_from_betas(betas,
                                         smpl_model_path=smpl_model_path)

    kp3d, bones, skts, rest_pose, pose_scale = get_keypoints_from_rotmats(
        rot_mats, joints, rest_pose, ext_scale=ext_scale,
        align_joint_idx=align_joint_idx, ref_pose=ref_pose,
        scale_rest_pose=scale_rest_pose)

    cyls = get_kp_bounding_cylinder(
        kp3d, ext_scale=ext_scale / dataset_ext_scale, skel=skel_type,
        extend_mm=250, head='-y')

    focals, c2ws = pred_cams_to_orig_cam_params(
        cameras, bboxes, img_width=res_W, img_height=res_H,
        resized_width=resized_res, resized_height=resized_res,
        focal=focal, ext_scale=pose_scale, new_focal=new_focal)

    return {'kp3d': kp3d, 'bones': bones, 'cyls': cyls.astype(np.float32),
            'skts': skts, 'rest_pose': rest_pose.astype(np.float32),
            'ext_scale': ext_scale, 'c2ws': c2ws.astype(np.float32),
            'focals': focals, 'pose_scale': pose_scale}


def read_spin_data(data_path: str, ext_scale: float = 0.001,
                   img_res: Any = 1000, bbox_res: int = 224,
                   rest_pose: Optional[np.ndarray] = None
                   ) -> Dict[str, Any]:
    """Load a SPIN output .pkl / .h5 and run the conversion (reference
    process_spin.py:14-43).  The .h5 branch reads deepdish-style files
    with plain h5py."""
    if data_path.endswith('.pkl'):
        with open(data_path, 'rb') as f:
            spin_data = pickle.load(f)
    else:
        spin_data = _load_deepdish_h5(data_path)

    img_paths = spin_data['img_path']
    betas = np.asarray(spin_data['pred_betas'])
    if 'pred_output' in spin_data:  # torch SMPLOutput list (pkl path)
        joints = np.concatenate(
            [np.asarray(spin_data['pred_output'][i].joints)
             for i in range(len(img_paths))])
    else:
        joints = np.asarray(spin_data['pred_joints'])
    rot_mats = np.asarray(spin_data['pred_rot_mat'])
    bboxes = np.asarray(spin_data['bbox_params'])
    cameras = np.asarray(spin_data.get('pred_camera',
                                       spin_data.get('pred_cam')))

    ret = process_spin_data(betas, cameras, joints, rot_mats, bboxes,
                            rest_pose=rest_pose, res=img_res,
                            resized_res=bbox_res, ext_scale=ext_scale,
                            scale_rest_pose=True)
    ret['img_path'] = img_paths
    if 'pose_3d' in spin_data:
        ret['gt_kp3d'] = np.asarray(spin_data['pose_3d'], np.float32)
    if 'selected_idx' in spin_data:
        ret['selected_idx'] = spin_data['selected_idx']
    ret['betas'] = betas
    return ret


def _load_deepdish_h5(path: str) -> Dict[str, Any]:
    """Minimal reader for deepdish-written h5 dicts (plain datasets +
    '/data' subgroups)."""
    import h5py

    out: Dict[str, Any] = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            key = name.split('/')[1] if name.startswith('data/') else name
            out.setdefault(key, obj[()])

    with h5py.File(path, 'r') as f:
        root = f['data'] if 'data' in f else f
        for k in root:
            v = root[k]
            if isinstance(v, h5py.Dataset):
                out[k] = v[()]
            else:
                v.visititems(lambda n, o, k=k: out.setdefault(
                    k, o[()]) if isinstance(o, h5py.Dataset) else None)
    return out
