"""Offline raw-dataset -> data store preprocessing.

The port's copy of ``anerf_tpu/data/preprocess.py``: converts the raw
capture formats (SURREAL renders, Human3.6M frames, Mixamo renders,
MonoPerfCap sequences, ZJU-MoCap, MPI-INF-3DHP) into the unified schema
the data layer reads, written as a numpy data store (``data/store.py``,
``write_store``) in place of anerf_tpu's HDF5 file, at anerf_tpu's file
name with ``.npstore`` for ``.h5``, the name ``loaders.DATASET_CATALOG``
reads.  Behavior mirrors the reference's ``process_*`` functions
(core/load_surreal.py:98-300, core/load_h36m.py:17-249,
core/load_mixamo.py:14-106, core/load_perfcap.py:12-52,
core/load_zju.py:179-534, core/load_3dhp.py:81-141) with vectorized
numpy replacing the per-element python loops.

These run on the host (numpy; the one rotation step through the port's
``ops/rotations`` on the CPU): they are one-time converters, not part
of the device's compute path.  Heavy optional deps (imageio, cv2,
scipy.io, smplx) are imported inside the functions that need them so
the rest of the package stays importable without them.
"""
from __future__ import annotations

import glob
import os
import pickle
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.cylinder import (get_kp_bounding_cylinder, nerf_c2w_to_extrinsic,
                            swap_mat, world_to_cam_np)
from ..ops.fk import get_smpl_l2ws_np
from ..ops.rays import get_rays_np
from ..skeleton import SMPL_REST_POSE, SMPLSkeleton
from .spin import (DATASET_EXT_SCALE, calculate_bone_length,
                   read_spin_data, rot_to_axisang_np)
from .store import write_store


def _imread(path):
    import imageio.v2 as imageio
    return np.asarray(imageio.imread(path))


def dilate_masks(masks: np.ndarray, extend_iter: int = 1,
                 kernel_size: int = 5) -> np.ndarray:
    """Binary dilation with a ``kernel_size``² ones kernel, iterated
    (reference load_surreal.py:50-59 via cv2.dilate) — pure numpy so the
    converters don't require OpenCV.

    masks: (N, H, W) or (N, H, W, 1) in {0, 1}.
    """
    squeeze = masks.ndim == 4
    m = (masks[..., 0] if squeeze else masks) > 0
    r = kernel_size // 2
    for _ in range(extend_iter):
        acc = np.zeros_like(m)
        for dy in range(-r, r + 1):
            shifted = np.roll(m, dy, axis=1)
            if dy > 0:
                shifted[:, :dy] = False
            elif dy < 0:
                shifted[:, dy:] = False
            for dx in range(-r, r + 1):
                s2 = np.roll(shifted, dx, axis=2)
                if dx > 0:
                    s2[:, :, :dx] = False
                elif dx < 0:
                    s2[:, :, dx:] = False
                acc |= s2
        m = acc
    out = m.astype(masks.dtype)
    return out[..., None] if squeeze else out


def skeleton3d_to_2d(kps: np.ndarray, c2ws: np.ndarray, H, W, focals,
                     centers=None) -> np.ndarray:
    """Project world keypoints into per-frame image coordinates
    (reference skeleton_utils.py:475-488)."""
    kp2ds = []
    for i, (kp, c2w) in enumerate(zip(kps, c2ws)):
        f = focals[i] if not np.isscalar(focals) else focals
        h = H if np.isscalar(H) else H[i]
        w = W if np.isscalar(W) else W[i]
        center = centers[i] if centers is not None else None
        ext = nerf_c2w_to_extrinsic(c2w)
        kp2ds.append(world_to_cam_np(kp, ext, h, w, f, center))
    return np.array(kp2ds)


def get_temporal_validity(img_paths) -> Tuple[np.ndarray, np.ndarray]:
    """valid[i]=0 when frame i-1 is not the consecutive previous frame
    of the same sequence; also a per-frame sequence id (reference
    load_mixamo.py:136-159)."""
    def get_num(name):
        base = os.path.splitext(os.path.basename(name))[0]
        digits = ''.join(c for c in str(base) if c.isdigit())
        return int(digits) if digits else 0

    n = len(img_paths)
    valid = np.ones(n)
    seq_map = np.zeros(n, np.int32)
    valid[0] = 0
    seq_cnt = 0
    paths = [p.decode() if isinstance(p, bytes) else str(p)
             for p in img_paths]
    for i in range(1, n):
        if (os.path.dirname(paths[i - 1]) != os.path.dirname(paths[i])
                or abs(get_num(paths[i]) - get_num(paths[i - 1])) > 1):
            valid[i] = 0
            seq_cnt += 1
        seq_map[i] = seq_cnt
    return valid, seq_map


# ---------------------------------------------------------------------------
# SURREAL
# ---------------------------------------------------------------------------

# axis fixes applied to the SURREAL export (reference load_surreal.py:104-115)
_SURREAL_ROT_ROOTBONE = np.array([[1., 0., 0.], [0., 0., -1.], [0., 1., 0.]],
                                 np.float32)
_SURREAL_ROT_GLOB = np.diag([1., -1., -1.]).astype(np.float32)
# shape betas used by the SURREAL generation code (load_surreal.py:114-116)
SURREAL_BETAS = np.array([[-0.8010307, 0.6838105, 0.7480726, -1.1379223,
                           -0.32415348, -0.8404733, -0.4795286, -0.63125765,
                           -0.13453396, 1.4934114]], np.float32)


def cylinder_mask_prefilter(sampling_masks: np.ndarray,
                            cyls: np.ndarray,
                            c2ws: np.ndarray,
                            img_cam_indices: np.ndarray,
                            H: int, W: int, focal: float) -> np.ndarray:
    """Zero sampling-mask pixels whose rays never enter the subject's
    bounding cylinder, so the pixel sampler only proposes useful rays
    (reference load_surreal.py:252-276).  Vectorized over images.

    cyls rows are (cx, cz, radius, top, bot); the 2D distance test uses
    the ground-plane (x, z) components of the rays.
    """
    n_imgs = len(sampling_masks)
    n_kps = len(cyls)
    out = sampling_masks.copy()
    rays_cache = {}
    for i in range(n_imgs):
        cam_idx = int(img_cam_indices[i])
        if cam_idx not in rays_cache:
            ro, rd = get_rays_np(H, W, focal, c2ws[cam_idx])
            ro2 = ro.reshape(-1, 3)[:, [0, 2]]
            rd2 = rd.reshape(-1, 3)[:, [0, 2]]
            far = ro2 + rd2 * 100.
            of = far - ro2
            of_norm = np.linalg.norm(of, axis=-1)
            rays_cache[cam_idx] = (ro2, of, of_norm)
        ro2, of, of_norm = rays_cache[cam_idx]
        cyl = cyls[i % n_kps]
        od = cyl[:2] - ro2
        # 2D cross product (z-component): point-to-line distance
        dist = np.abs(of[:, 0] * od[:, 1] - of[:, 1] * od[:, 0]) / of_norm
        out[i, ..., 0] *= (dist < cyl[2]).reshape(H, W).astype(out.dtype)
    return out


def process_surreal_data(store_path: str, data_path: str,
                         extend_iter: int = 2, ext_scale: float = 0.001
                         ) -> Dict[str, np.ndarray]:
    """SURREAL render dirs -> a data store at ``store_path`` (the
    catalog's ``surreal/surreal_train_h5py.npstore``; reference
    load_surreal.py:98-300).

    Each ``<seq>_<id>/`` dir holds a ``metadata.pkl`` (cams, joints3D,
    poses, focal) plus ``*-*/imageSequences/*.png`` renders and
    ``*-*/*segm.mat`` segmentation masks.  Images are laid out
    (N_cams, N_seqs * N_kp_per_seq).
    """
    from scipy.io import loadmat

    ext_scale = ext_scale * DATASET_EXT_SCALE
    sg = lambda p: sorted(glob.glob(p))
    data_dirs = sg(os.path.join(data_path, '*_*/'))

    cams, kp_3d, bone_poses, render_types, seq_cam_type, focals = \
        [], [], [], [], [], []
    fg_masks, imgs = None, None
    for i, data_dir in enumerate(data_dirs):
        with open(os.path.join(data_dir, 'metadata.pkl'), 'rb') as f:
            meta = pickle.load(f)
        focals.append(meta['focal'] * meta['int_scale'])

        render_type = meta['render_type']
        cam = meta['cams']
        if render_type not in render_types:
            render_types.append(render_type)
            cam[..., :3, -1] *= ext_scale
            cams.append(cam)
        seq_cam_type.append(render_types.index(render_type))

        n_kp_seq = meta['N_kp']
        n_cam_seq = meta['N_cams']
        n_cam_sub = meta['N_cam_per_subdir']
        kp_3d.append(meta['joints3D'] * ext_scale)
        bone_poses.append(meta['poses'].reshape(n_kp_seq, -1, 3))

        fg_seq = []
        for fg_path in sg(os.path.join(data_dir, '*-*/', '*segm.mat')):
            fg = loadmat(fg_path)['data']
            fg = fg.reshape(n_cam_sub, n_kp_seq, *fg.shape[-2:])
            fg_seq.append((fg > 0).astype(np.uint8))
        fg_seq = np.concatenate(fg_seq, axis=0)
        if fg_masks is None:
            fg_masks = np.zeros((min(n_cam_seq, fg_seq.shape[0]),
                                 len(data_dirs) * fg_seq.shape[1],
                                 *fg_seq.shape[-2:]), np.uint8)
        fg_masks[:, i * fg_seq.shape[1]:(i + 1) * fg_seq.shape[1]] = \
            fg_seq[:len(fg_masks)]

        img_paths = np.array(
            sg(os.path.join(data_dir, '*-*/', 'imageSequences/*.png')))
        img_seq = np.stack([_imread(p)[..., :3] for p in img_paths])
        img_seq = img_seq.reshape(-1, n_kp_seq, *img_seq.shape[1:])
        if imgs is None:
            imgs = np.zeros((*fg_masks.shape, 3), np.uint8)
        imgs[:, i * n_kp_seq:(i + 1) * n_kp_seq] = img_seq[:len(imgs)]

    kp_3d = np.concatenate(kp_3d).reshape(-1, 24, 3)
    bone_poses = np.concatenate(bone_poses).reshape(-1, 24, 3)
    n_kps = kp_3d.shape[0]
    focal = float(np.mean(focals))
    H, W = imgs.shape[-3:-1]
    imgs = imgs.reshape(-1, H, W, 3)
    fg_masks = fg_masks.reshape(-1, H, W)

    # per-image camera index within the per-type camera bank
    seq_cam_type = np.array(seq_cam_type)
    n_seqs, n_kp_seq = len(data_dirs), n_kps // max(len(data_dirs), 1)
    n_cams_per_type = imgs.shape[0] // n_kps
    idx = np.arange(n_cams_per_type).reshape(-1, 1, 1)
    idx = np.broadcast_to(idx, (n_cams_per_type, n_seqs, n_kp_seq)).copy()
    img_cam_indices = (idx + seq_cam_type[None, :, None]
                       * n_cams_per_type).reshape(-1)

    sampling_masks = (fg_masks if extend_iter == 0
                      else dilate_masks(fg_masks, extend_iter))
    fg_masks = fg_masks[..., None]
    sampling_masks = sampling_masks[..., None]

    c2ws = np.array(cams).reshape(-1, 4, 4)
    glob4 = np.eye(4, dtype=np.float32)
    glob4[:3, :3] = _SURREAL_ROT_GLOB
    c2ws = glob4[None] @ c2ws

    # re-root the global orientation into the NeRF coordinate frame
    # (load_surreal.py:231-238)
    import torch

    from ..ops.rotations import axisang_to_rot
    root_rots = (_SURREAL_ROT_ROOTBONE[None] @ axisang_to_rot(
        torch.from_numpy(bone_poses[:, 0].astype(np.float32))).numpy())
    bone_poses[:, 0] = rot_to_axisang_np(root_rots)
    kp_3d = kp_3d @ _SURREAL_ROT_GLOB.T

    l2ws = np.stack([get_smpl_l2ws_np(b, SMPL_REST_POSE, scale=ext_scale)
                     for b in bone_poses])
    l2ws[:, :, :3, -1] = kp_3d
    skts = np.linalg.inv(l2ws)

    cyls = get_kp_bounding_cylinder(
        kp_3d, ext_scale=ext_scale / DATASET_EXT_SCALE, skel=SMPLSkeleton,
        extend_mm=250, head='-y')
    sampling_masks = cylinder_mask_prefilter(
        sampling_masks, cyls, c2ws, img_cam_indices, H, W, focal)

    data = {
        'imgs': imgs, 'masks': fg_masks, 'sampling_masks': sampling_masks,
        'bkgds': (np.ones((1, H, W, 3)) * 255).astype(np.uint8),
        'bkgd_idxs': np.zeros(len(imgs), np.int64),
        'kp3d': kp_3d.astype(np.float32),
        'gt_kp3d': kp_3d.astype(np.float32),
        'bones': bone_poses.astype(np.float32),
        'skts': skts.astype(np.float32),
        'cyls': cyls.astype(np.float32),
        'rest_pose': (SMPL_REST_POSE * ext_scale).astype(np.float32),
        'betas': SURREAL_BETAS,
        'c2ws': c2ws[img_cam_indices].astype(np.float32),
        'focals': np.full(len(imgs), focal, np.float32),
        'ext_scale': ext_scale,
    }
    write_store(store_path, data)
    return data


# ---------------------------------------------------------------------------
# MonoPerfCap
# ---------------------------------------------------------------------------

def process_perfcap_data(data_path: str, subject: str = 'Weipeng_outdoor',
                         ext_scale: float = 0.001, img_res=(1080, 1920),
                         bbox_res: int = 224, extend_iter: int = 2) -> str:
    """MonoPerfCap frames + masks + SPIN h5 -> processed store (reference
    load_perfcap.py:12-52)."""
    spin_data = read_spin_data(
        os.path.join(data_path, 'MonoPerfCap', f'MonoPerfCap-{subject}.h5'),
        ext_scale=ext_scale, img_res=img_res, bbox_res=bbox_res)
    img_paths = spin_data['img_path']

    bkgd = _imread(os.path.join(data_path, 'MonoPerfCap',
                                f'{subject}/bkgd.png'))
    imgs, masks = [], []
    for p in img_paths:
        p = p.decode() if isinstance(p, bytes) else str(p)
        img = _imread(os.path.join(data_path, p))
        mask = _imread(os.path.join(
            data_path, p.replace('/images/', '/masks/')))[..., None]
        masks.append((mask >= 2).astype(np.uint8))
        imgs.append(img)
    masks = np.array(masks)

    data = {
        'imgs': np.array(imgs),
        'masks': masks,
        'sampling_masks': dilate_masks(masks[..., 0], extend_iter)[..., None],
        'kp_idxs': np.arange(len(masks)),
        'cam_idxs': np.arange(len(masks)),
        'bkgds': bkgd[None],
        'bkgd_idxs': np.zeros(len(masks), np.int64),
        **{k: v for k, v in spin_data.items() if k != 'img_path'},
        'img_paths': np.array([str(p).encode() for p in img_paths]),
    }
    name = os.path.join(data_path, 'MonoPerfCap',
                        f'{subject}/{subject}_processed_h5py.npstore')
    return write_store(name, data)


# ---------------------------------------------------------------------------
# Mixamo
# ---------------------------------------------------------------------------

def remap_mixamo_kp_idxs(kp_idxs: np.ndarray, seq_lens: Sequence[int],
                         n_cam: int = 4) -> np.ndarray:
    """Offset per-sequence frame ids into a global pose-bank index
    (reference load_mixamo.py:64-73): each sequence contributes
    ``seq_len // n_cam`` unique poses."""
    kp_idxs = kp_idxs.copy()
    i = 0
    start = 0
    for seq_len in seq_lens:
        kp_idxs[start:start + seq_len] += i
        start += seq_len
        i += seq_len // n_cam
    return kp_idxs


def process_mixamo_data(data_path: str, subject: str = 'James',
                        ext_scale: float = 0.001, bbox_res: int = 224,
                        extend_iter: int = 2, n_cam: int = 4) -> str:
    """Mixamo 4-camera renders + SPIN h5 -> processed store (reference
    load_mixamo.py:14-106).  Images are white-composited through their
    masks; ground-truth joints come from per-sequence metadata.pickle."""
    spin_data = read_spin_data(
        os.path.join(data_path, subject, f'{subject}.h5'),
        ext_scale=ext_scale, img_res=1000, bbox_res=bbox_res)
    img_paths = spin_data['img_path']

    imgs, masks, kp_idxs, cam_idxs = [], [], [], []
    seq_dict: 'OrderedDict[str, List[int]]' = OrderedDict()
    for i, p in enumerate(img_paths):
        p = p.decode() if isinstance(p, bytes) else str(p)
        parts = p.split('/')
        d = '/'.join(parts[:3])
        seq_name, img_name = parts[1], parts[-1]
        cam_idxs.append(int(parts[2].split('_')[-1]))
        kp_idxs.append(int(img_name[5:-4]) - 1)
        seq_dict.setdefault(seq_name, []).append(i)

        img = _imread(os.path.join(data_path, p))[..., :3]
        mask = (_imread(os.path.join(data_path, f'{d}/Masks/{img_name}'))
                [..., :1] >= 2).astype(np.uint8)
        imgs.append(img * mask + (1 - mask) * 255)
        masks.append(mask)

    gt_kps, joint_names = [], None
    for k in seq_dict:
        with open(os.path.join(data_path, subject, k, 'Camera_0',
                               'metadata.pickle'), 'rb') as f:
            meta = pickle.load(f)
        for pose in meta['gt_pose']:
            pose = pose.item() if hasattr(pose, 'item') else pose
            if joint_names is None:
                joint_names = list(pose.keys())
            gt_kps.append(np.array([pose[j] for j in joint_names]))

    kp_idxs = remap_mixamo_kp_idxs(
        np.array(kp_idxs), [len(v) for v in seq_dict.values()], n_cam)
    masks = np.array(masks)
    temp_val, _ = get_temporal_validity(img_paths)

    data = {
        'imgs': np.array(imgs),
        'masks': masks,
        'sampling_masks': dilate_masks(masks[..., 0], extend_iter)[..., None],
        'kp_idxs': kp_idxs,
        'cam_idxs': np.array(cam_idxs),
        'gt_kp3d': np.array(gt_kps, np.float32) * ext_scale,
        'bkgds': (np.ones((1, *masks.shape[1:3], 3)) * 255).astype(np.uint8),
        'bkgd_idxs': np.zeros(len(masks), np.int64),
        'temp_validity': temp_val,
        **{k: v for k, v in spin_data.items() if k != 'img_path'},
        'img_paths': np.array([str(p).encode() for p in img_paths]),
    }
    name = os.path.join(data_path, subject,
                        f'{subject}_processed_h5py.npstore')
    return write_store(name, data)


# ---------------------------------------------------------------------------
# Human3.6M
# ---------------------------------------------------------------------------

H36M_CAMERAS = ('54138969', '55011271', '58860488', '60457274')
H36M_CHAIR_SEQS = ('Sitting-', 'Eating-', 'Phoning-', 'Smoking-')


def extract_background(data_path: str, subject: str = 'S9',
                       use_chair_seqs: bool = False) -> np.ndarray:
    """Per-camera clean plates: average (or median, for chair
    sequences) of non-person pixels over all frames (reference
    load_h36m.py:17-112)."""
    from .spin import _load_deepdish_h5
    mask_data = _load_deepdish_h5(
        os.path.join(data_path, f'{subject}_mask_fixed.h5'))
    mask_img_path = mask_data['index']
    H = W = mask_data['masks'].shape[-2]

    if use_chair_seqs:
        per_cam: List[List[np.ndarray]] = [[] for _ in H36M_CAMERAS]
    else:
        bkgds = np.zeros((len(H36M_CAMERAS), H, W, 3), np.float32)
        cnts = np.zeros((len(H36M_CAMERAS), H, W, 1), np.float32)

    for i, img_path in enumerate(mask_img_path):
        img_path = (img_path.decode() if isinstance(img_path, bytes)
                    else str(img_path))
        has_chair = any(s in img_path for s in H36M_CHAIR_SEQS)
        if has_chair != use_chair_seqs:
            continue
        img = _imread(os.path.join(data_path, img_path))
        if img.shape[0] != H:   # one camera is 1002x1000
            img = img[1:-1]
        cam_idx = next(e for e, c in enumerate(H36M_CAMERAS)
                       if c in img_path)
        mask = mask_data['masks'][i]
        if use_chair_seqs:
            per_cam[cam_idx].append(img)
        else:
            bkgds[cam_idx] += (img / 255.) * (1 - mask)
            cnts[cam_idx] += (1 - mask)

    if use_chair_seqs:
        out = np.array([np.median(b, axis=0) for b in per_cam]
                       ).astype(np.uint8)
        np.save(os.path.join(data_path, f'{subject}_chair_bkgds_.npy'), out)
    else:
        out = ((bkgds / np.maximum(cnts, 1)) * 255.).astype(np.uint8)
        np.save(os.path.join(data_path, f'{subject}_clean_bkgds_.npy'), out)
    return out


def process_h36m_data(data_path: str, subject: str = 'S9',
                      ext_scale: float = 0.001, res: float = 1.0,
                      bbox_res: int = 224, extend_iter: int = 2,
                      camera_name: Optional[str] = None) -> str:
    """H36M frames + DeepLab masks + SPIN h5 -> processed store (reference
    load_h36m.py:114-249).  Background index = camera id, offset by
    len(cameras) for chair sequences (they use the chair clean plates).
    """
    from .spin import _load_deepdish_h5

    if camera_name is None:
        spin_h5 = os.path.join(data_path,
                               f'{subject}_SPIN_rect_output-maxmin.h5')
        mask_h5 = os.path.join(data_path,
                               f'{subject}_mask_deeplab_crop.h5')
    else:
        sub = 1 if subject == 'S1' else 5
        spin_h5 = os.path.join(
            data_path, f'{subject}-camera=[{camera_name}]-subsample={sub}.h5')
        mask_h5 = os.path.join(
            data_path, f'{subject}_{camera_name}_mask_deeplab_crop.h5')

    bkgds = np.load(os.path.join(
        data_path, f"{subject.replace('s', '')}_clean_bkgds.npy"))
    chair_bkgds = np.load(os.path.join(
        data_path, f"{subject.replace('s', '')}_chair_bkgds.npy"))
    bkgds = np.concatenate([bkgds, chair_bkgds], axis=0)

    mask_data = _load_deepdish_h5(mask_h5)
    masks = mask_data['masks'].astype(np.uint8)
    if masks.ndim <= 3:
        masks = masks[..., None]
    if masks.max() > 1:
        masks = (masks >= 2).astype(np.uint8)
    H = W = masks.shape[-2]
    if 'res' in mask_data:
        res = float(mask_data['res'])
    if res != 1.0:
        H, W = int(H / res), int(W / res)

    est = read_spin_data(spin_h5, ext_scale, img_res=H, bbox_res=bbox_res)
    if res != 1.0:
        est['focals'] = est['focals'] * res

    sampling_masks = dilate_masks(masks[..., 0], extend_iter)[..., None]

    cameras = H36M_CAMERAS if subject != 'S1' else (H36M_CAMERAS[-1],)
    imgs, cam_idxs = [], []
    for p in est['img_path']:
        p = p.decode() if isinstance(p, bytes) else str(p)
        offset = len(cameras) * any(s in p for s in H36M_CHAIR_SEQS)
        cam_idxs.append(next(e for e, c in enumerate(cameras) if c in p)
                        + offset)
        img = _imread(os.path.join(data_path, p))
        if img.shape[0] != H and res == 1.0:
            img = img[1:-1]
        if res != 1.0:
            import cv2
            img = cv2.resize(img, (int(res * W), int(res * H)),
                             interpolation=cv2.INTER_AREA)
        imgs.append(img)

    data = {
        'imgs': np.array(imgs),
        'masks': masks,
        'sampling_masks': sampling_masks,
        'bkgd_idxs': np.array(cam_idxs),
        'bkgds': bkgds,
        'img_paths': np.array([str(p).encode()
                               for p in mask_data['index']]),
        **{k: v for k, v in est.items() if k != 'img_path'},
    }
    name = (f'{subject}_processed_h5py.npstore' if camera_name is None
            else f'{subject}_{camera_name}_processed_h5py.npstore')
    return write_store(os.path.join(data_path, name), data)


# ---------------------------------------------------------------------------
# ZJU-MoCap
# ---------------------------------------------------------------------------

# rotates the ZJU world so the ground plane lies on x-z like every other
# dataset in the schema (reference load_zju.py:13-15)
ZJU_TO_NERF_ROT = np.array([[1., 0., 0.],
                            [0., 0., -1.],
                            [0., 1., 0.]], dtype=np.float32)

# NeuralBody per-subject training lengths / start frames
# (reference load_zju.py:17-29,189-194)
ZJU_NUM_TRAIN_FRAMES = {
    '313': 60, '315': 300, '377': 300, '386': 300, '387': 300,
    '390': 300, '392': 300, '393': 300, '394': 300, '395': 300,
    '396': 540,
}
ZJU_BEGIN_FRAME = {'390': 700, '396': 810}

# H36M-in-ZJU-layout per-subject recipe: Posing sequence only,
# (num_train_frames, num_eval_frames), frame_interval=5
# (reference load_zju.py:344-371)
H36M_ZJU_FRAMES = {
    'S1': (150, 49), 'S5': (250, 127), 'S6': (150, 83), 'S7': (300, 200),
    'S8': (250, 87), 'S9': (260, 133), 'S11': (200, 82),
}


def zju_read_mask(subject_path: str, img_path: str,
                  erode_border: bool = False, border: int = 5,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Union of the ``mask/`` and ``mask_cihp/`` segmentations for one
    frame, plus the dilated sampling mask (reference load_zju.py:31-68,
    following the NeuralBody repo).  cv2-free: uses the package's own
    binary morphology.

    Returns (mask, sampling_mask), both (H, W) uint8 in {0, 1}.
    """
    stem = os.path.splitext(img_path)[0] + '.png'
    mask = None
    for sub in ('mask', 'mask_cihp'):
        p = os.path.join(subject_path, sub, stem)
        if not os.path.exists(p):
            continue
        m = (_imread(p) != 0)
        m = m.any(-1) if m.ndim == 3 else m
        mask = m if mask is None else (mask | m)
    if mask is None:
        raise FileNotFoundError(
            f'no mask/ or mask_cihp/ entry for {img_path} under '
            f'{subject_path}')
    mask = mask.astype(np.uint8)
    sampling = dilate_masks(mask[None], extend_iter=3,
                            kernel_size=border)[0]
    if erode_border:
        # zero the uncertain 1px-ish band around the silhouette:
        # dilate(mask) - erode(mask) (reference load_zju.py:60-63)
        dilated = dilate_masks(mask[None], 1, border)[0]
        eroded = 1 - dilate_masks(1 - mask[None], 1, border)[0]
        sampling = np.where((dilated - eroded) == 1, 0, sampling)
    return mask, sampling.astype(np.uint8)


def zju_smpl_to_pose_data(bones: np.ndarray, root_bones: np.ndarray,
                          root_locs: np.ndarray, rest_pose_raw: np.ndarray,
                          ext_scale: float = 0.001,
                          scale_to_ref: bool = False,
                          ref_pose: np.ndarray = SMPL_REST_POSE,
                          skel=SMPLSkeleton,
                          ) -> Dict[str, np.ndarray]:
    """Pure geometry of the reference's ``get_smpls``
    (load_zju.py:70-176) with the SMPL forward factored out, so it is
    testable (and runnable) without the optional smplx package.

    ZJU poses live in yet-another coordinate system:
    ``x_world = R'(R x + t) + T'`` where (R, t) is the standard SMPL
    articulation and (R', T') = (Rh, Th) a global rotation/translation.
    We fold ``Rn @ R'`` (Rn = ground-plane alignment) into the root bone
    and move the root joint to ``Rn R' T + Rn T'`` where T is the
    (uncentered) pelvis of the shaped rest pose — exactly the reference's
    ``joints = (Rn R' R X + T) - T + Rn R' T + Rn T'`` correction
    (load_zju.py:118-166), exploiting that the SMPL root joint location
    is pose-invariant so the smplx call is unnecessary for joints.

    Args:
      bones: (N, 24, 3) per-frame axis-angle SMPL pose (``params['poses']``).
      root_bones: (N, 3) global rotation Rh (``params['Rh']``).
      root_locs: (N, 3) global translation Th (``params['Th']``).
      rest_pose_raw: (24, 3) UNCENTERED zero-pose joints for the
        subject's betas (pelvis NOT at the origin) — from smplx when
        available, or precomputed.

    Returns dict with kp3d / bones / skts / rest_pose / cyls /
    root_locs / pose_scale.
    """
    from scipy.spatial.transform import Rotation

    bones = np.asarray(bones, np.float32).reshape(-1, 24, 3)
    root_bones = np.asarray(root_bones, np.float32).reshape(-1, 3)
    root_locs = np.asarray(root_locs, np.float32).reshape(-1, 3)
    rest_pose_raw = np.asarray(rest_pose_raw, np.float32).reshape(24, 3)
    Rn = ZJU_TO_NERF_ROT.astype(np.float64)

    # compose the ground-plane alignment and ZJU global rotation into
    # the root bone (reference load_zju.py:106-112)
    Rp = Rotation.from_rotvec(root_bones.astype(np.float64)).as_matrix()
    R0 = Rn[None] @ Rp
    new_root = Rotation.from_matrix(R0).as_rotvec().astype(np.float32)

    pelvis_T = rest_pose_raw[0].astype(np.float64)
    rest_pose = rest_pose_raw - rest_pose_raw[0:1]
    if scale_to_ref:
        ref = np.asarray(ref_pose, np.float32) * ext_scale
        pose_scale = (calculate_bone_length(ref).mean()
                      / calculate_bone_length(rest_pose).mean())
    else:
        pose_scale = 1.0
    rest_pose = (rest_pose * pose_scale).astype(np.float32)

    # root joint in the NeRF world: Rn R' T + Rn T'
    # (reference load_zju.py:152-166; the -T + T of the posed pelvis
    # cancels because the SMPL root is pose-invariant)
    roots = (np.einsum('nij,j->ni', R0, pelvis_T)
             + root_locs.astype(np.float64) @ Rn.T) * pose_scale
    roots = roots.astype(np.float32)

    out_bones = bones.copy()
    out_bones[:, 0] = new_root
    l2ws = np.stack([get_smpl_l2ws_np(b, rest_pose=rest_pose)
                     for b in out_bones])
    l2ws[:, :, :3, -1] += roots[:, None]
    kp3d = l2ws[:, :, :3, -1].copy()
    skts = np.linalg.inv(l2ws)
    cyls = get_kp_bounding_cylinder(
        kp3d, ext_scale=ext_scale, skel=skel, extend_mm=250,
        top_expand_ratio=1.00, bot_expand_ratio=0.25, head='-y')
    return {
        'kp3d': kp3d.astype(np.float32),
        'bones': out_bones.astype(np.float32),
        'skts': skts.astype(np.float32),
        'rest_pose': rest_pose.astype(np.float32),
        'cyls': np.asarray(cyls, np.float32),
        'root_locs': roots,
        'pose_scale': float(pose_scale),
    }


def zju_extrinsics_to_nerf(Rs: np.ndarray, Ts: np.ndarray, Ks: np.ndarray,
                           res: Optional[float] = None,
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ZJU per-camera (R, T, K) -> NeRF-format c2ws / focals / centers
    (reference load_zju.py:283-310): invert the world-to-cam extrinsic,
    rotate into the ground-aligned frame, swap to NeRF axis convention.

    Rs: (C, 3, 3); Ts: (C, 3, 1) in mm; Ks: (C, 3, 3).
    """
    Rs = np.asarray(Rs, np.float64)
    Ts = np.asarray(Ts, np.float64).reshape(-1, 3, 1) / 1000.0  # mm -> m
    Ks = np.asarray(Ks, np.float64).copy()
    C = len(Rs)
    ext = np.zeros((C, 4, 4))
    ext[:, :3, :3] = Rs
    ext[:, :3, 3:] = Ts
    ext[:, 3, 3] = 1.0
    c2ws = np.linalg.inv(ext)
    Rn = ZJU_TO_NERF_ROT.astype(np.float64)
    c2ws[:, :3, 3:] = Rn @ c2ws[:, :3, 3:]
    c2ws[:, :3, :3] = Rn @ c2ws[:, :3, :3]
    if res is not None:
        Ks[:, :2] = Ks[:, :2] * res
    focals = np.stack([Ks[:, 0, 0], Ks[:, 1, 1]], -1)
    centers = Ks[:, :2, -1]
    return (swap_mat(c2ws).astype(np.float32), focals.astype(np.float32),
            centers.astype(np.float32))


def zju_background_median(imgs: np.ndarray, masks: np.ndarray,
                          cam_idxs: np.ndarray, num_cams: int,
                          row_chunk: int = 64) -> np.ndarray:
    """Per-camera background plates: per-pixel median over the frames
    where that pixel is outside the person mask (reference
    load_zju.py:267-281 — theirs is a per-pixel python double loop; this
    is the vectorized equivalent via masked nanmedian, chunked over rows
    to bound the float32 working set).

    imgs: (N, H, W, 3) uint8; masks: (N, H, W, 1); cam_idxs: (N,).
    Returns (num_cams, H, W, 3) uint8 (zeros for cameras with no frames
    or pixels never seen as background).
    """
    N, H, W, _ = imgs.shape
    bkgds = np.zeros((num_cams, H, W, 3), np.uint8)
    for c in np.unique(cam_idxs):
        sel = cam_idxs == c
        ci = imgs[sel]
        cm = masks[sel].reshape(-1, H, W, 1)
        for r0 in range(0, H, row_chunk):
            r1 = min(r0 + row_chunk, H)
            vals = np.where(cm[:, r0:r1] > 0, np.nan,
                            ci[:, r0:r1].astype(np.float32))
            with np.errstate(all='ignore'):
                import warnings
                with warnings.catch_warnings():
                    warnings.simplefilter('ignore', RuntimeWarning)
                    med = np.nanmedian(vals, axis=0)
            bkgds[c, r0:r1] = np.nan_to_num(med).astype(np.uint8)
    return bkgds


def _zju_undistort(img: np.ndarray, K: np.ndarray,
                   D: np.ndarray) -> np.ndarray:
    """Brown-Conrady undistortion (cv2 when present, else identity for
    zero-distortion inputs)."""
    D = np.asarray(D, np.float64).ravel()
    if not D.any():
        return img
    try:
        import cv2
    except ImportError as e:  # pragma: no cover - cv2 is baked in
        raise ImportError('non-zero lens distortion needs cv2') from e
    return cv2.undistort(img, np.asarray(K, np.float64), D)


def _zju_load_params(subject_path: str, kp_ids: Sequence[int],
                     param_dir: str = 'params',
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """Load NeuralBody ``params/{id}.npy`` SMPL dicts -> stacked
    (bones, betas, Rh, Th) (reference load_zju.py:85-101)."""
    bones, betas, rhs, ths = [], [], [], []
    for kp_id in kp_ids:
        p = np.load(os.path.join(subject_path, param_dir, f'{kp_id}.npy'),
                    allow_pickle=True).item()
        bones.append(np.asarray(p['poses'], np.float32).reshape(-1, 24, 3))
        betas.append(np.asarray(p['shapes'], np.float32).reshape(-1, 10))
        rhs.append(np.asarray(p['Rh'], np.float32).reshape(-1, 3))
        ths.append(np.asarray(p['Th'], np.float32).reshape(-1, 3))
    return (np.concatenate(bones), np.concatenate(betas),
            np.concatenate(rhs), np.concatenate(ths))


def _zju_collect_images(subject_path: str, img_paths: Sequence[str],
                        cam_idxs: np.ndarray, cams: Dict[str, Any],
                        H: int, W: int, res: Optional[float],
                        erode_border: bool,
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read + undistort (+ resize) every frame and its masks
    (reference load_zju.py:229-263)."""
    n = len(img_paths)
    imgs = np.zeros((n, H, W, 3), np.uint8)
    masks = np.zeros((n, H, W, 1), np.uint8)
    sampling = np.zeros((n, H, W, 1), np.uint8)
    for i, (img_path, cam_idx) in enumerate(zip(img_paths, cam_idxs)):
        K = np.array(cams['K'][cam_idx])
        D = np.array(cams['D'][cam_idx])
        img = _imread(os.path.join(subject_path, img_path))[..., :3]
        mask, smask = zju_read_mask(subject_path, img_path,
                                    erode_border=erode_border)
        img = _zju_undistort(img, K, D)
        mask = np.minimum(_zju_undistort(mask, K, D), 1)
        smask = np.minimum(_zju_undistort(smask, K, D), 1)
        if res is not None and res != 1.0:
            import cv2
            img = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
            mask = cv2.resize(mask, (W, H),
                              interpolation=cv2.INTER_NEAREST)
            smask = cv2.resize(smask, (W, H),
                               interpolation=cv2.INTER_NEAREST)
        imgs[i] = img
        masks[i] = mask[..., None]
        sampling[i] = smask[..., None]
    return imgs, masks, sampling


def process_zju_data(data_path: str, subject: str = '377',
                     training_view: Sequence[int] = (0, 6, 12, 18),
                     i_intv: int = 1, split: str = 'train',
                     ext_scale: float = 0.001, res: Optional[float] = None,
                     rest_pose_raw: Optional[np.ndarray] = None,
                     smpl_model_path: str = 'smpl',
                     skel=SMPLSkeleton) -> str:
    """ZJU-MoCap (NeuralBody layout: CoreView_{subject}/annots.npy +
    per-camera frames + mask[_cihp]/ + params/) -> unified store
    (reference load_zju.py:179-380).

    ``rest_pose_raw``: (24, 3) uncentered zero-pose joints for the
    subject's betas.  When None it is derived from the stored betas via
    the optional smplx package; passing it precomputed makes the whole
    converter smplx-free (see ``zju_smpl_to_pose_data``).
    """
    assert ext_scale == 0.001, 'ZJU data is in the 1m=0.001 system'
    H = W = 1024
    ni = ZJU_NUM_TRAIN_FRAMES[subject]
    begin_i = ZJU_BEGIN_FRAME.get(subject, 0)
    if res is not None:
        H, W = int(H * res), int(W * res)

    subject_path = os.path.join(data_path, f'CoreView_{subject}')
    annots = np.load(os.path.join(subject_path, 'annots.npy'),
                     allow_pickle=True).item()
    cams = annots['cams']
    num_cams = len(cams['K'])

    if split == 'train':
        view = list(training_view)
        idxs = slice(begin_i, begin_i + ni * i_intv)
    else:  # NeuralBody novel-view eval protocol (load_zju.py:209-216)
        view = [1, 4, 5, 10, 17, 20]
        stop = 556 if subject == '392' else 601
        idxs = np.concatenate([np.arange(1, 31), np.arange(400, stop)])
        i_intv = 1

    ims = np.array(annots['ims'])[idxs][::i_intv]
    img_paths = np.array([np.array(d['ims'])[view] for d in ims]).ravel()
    cam_idxs = np.array([np.arange(len(d['ims']))[view]
                         for d in ims]).ravel()

    imgs, masks, sampling = _zju_collect_images(
        subject_path, img_paths, cam_idxs, cams, H, W, res,
        erode_border=True)

    # frame id -> pose id (313/315 name frames differently,
    # load_zju.py:255-258)
    if subject in ('313', '315'):
        kp_idxs = np.array([int(os.path.basename(p).split('_')[4])
                            for p in img_paths])
    else:
        kp_idxs = np.array([int(os.path.splitext(os.path.basename(p))[0])
                            for p in img_paths])

    bkgds = zju_background_median(imgs, masks, cam_idxs, num_cams)
    c2ws, focals, centers = zju_extrinsics_to_nerf(
        np.array(cams['R']), np.array(cams['T']), np.array(cams['K']),
        res=res)

    uniq_ids = np.unique(kp_idxs)
    bones, betas, rhs, ths = _zju_load_params(subject_path, uniq_ids)
    if rest_pose_raw is None:
        rest_pose_raw = _zju_rest_pose_from_betas(
            betas, smpl_model_path=smpl_model_path)
    pose = zju_smpl_to_pose_data(bones, rhs, ths, rest_pose_raw,
                                 ext_scale=ext_scale, scale_to_ref=False,
                                 skel=skel)

    # remap frame ids to pose-bank rows (load_zju.py:319-325)
    if split == 'test':
        kp_idxs = np.arange(len(kp_idxs))
    elif subject in ('313', '315'):
        kp_idxs = kp_idxs - 1
    elif subject in ZJU_BEGIN_FRAME:
        kp_idxs = kp_idxs - ZJU_BEGIN_FRAME[subject]

    data = {
        'imgs': imgs, 'bkgds': bkgds, 'bkgd_idxs': cam_idxs,
        'masks': masks, 'sampling_masks': sampling,
        'c2ws': c2ws, 'img_pose_indices': cam_idxs,
        'kp_idxs': np.asarray(kp_idxs), 'centers': centers,
        'focals': focals, 'kp3d': pose['kp3d'],
        'betas': betas.astype(np.float32), 'bones': pose['bones'],
        'skts': pose['skts'], 'cyls': pose['cyls'],
        'rest_pose': pose['rest_pose'],
        'ext_scale': np.array(ext_scale, np.float32),
        'img_shape': np.array([len(imgs), H, W, 3]),
    }
    return write_store(os.path.join(data_path,
                                    f'{subject}_{split}_h5py.npstore'), data)


def _zju_rest_pose_from_betas(betas: np.ndarray,
                              smpl_model_path: str = 'smpl',
                              gender: str = 'neutral') -> np.ndarray:
    """UNCENTERED zero-pose joints for mean betas via the optional smplx
    package (reference load_zju.py:125-139 keeps the pelvis offset as T)."""
    try:
        import torch
        from smplx import SMPL
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError(
            'deriving the ZJU rest pose from betas needs the optional '
            'smplx package; pass rest_pose_raw= precomputed instead') from e
    betas_t = torch.as_tensor(np.asarray(betas, np.float32)).mean(0)[None]
    with torch.no_grad():
        dummy = torch.eye(3).view(1, 1, 3, 3).expand(1, 24, 3, 3)
        smpl = SMPL(model_path=smpl_model_path, gender=gender,
                    joint_mapper=lambda joints: joints[:, :24])
        out = smpl(betas=betas_t, body_pose=dummy[:, 1:],
                   global_orient=dummy[:, :1], pose2rot=False)
    return out.joints[0].cpu().numpy().astype(np.float32)


def process_h36m_zju_data(data_path: str, subject: str = 'S1',
                          training_view: Sequence[int] = (0, 1, 2),
                          split: str = 'train',
                          res: Optional[float] = None,
                          ext_scale: float = 0.001,
                          rest_pose_raw: Optional[np.ndarray] = None,
                          skel=SMPLSkeleton) -> str:
    """H36M packaged in the ZJU/AnimatableNeRF layout (Posing sequence
    only) -> unified store (reference load_zju.py:344-534)."""
    assert ext_scale == 0.001
    H = W = 1000
    if res is not None and res != 1.0:
        H, W = int(H * res), int(W * res)

    n_train, n_eval = H36M_ZJU_FRAMES[subject]
    i_intv = 5
    subj_root = os.path.join(data_path, subject)
    annots = np.load(os.path.join(subj_root, 'Posing', 'annots.npy'),
                     allow_pickle=True).item()
    subject_path = os.path.join(subj_root, 'Posing')
    cams = annots['cams']
    num_cams = len(cams['K'])

    if split == 'train':
        view = list(training_view)
        i0, ni = 0, n_train
    else:
        view = [v for v in range(num_cams) if v not in training_view] or [0]
        i0, ni = n_train * i_intv, n_eval

    ims = annots['ims'][i0:i0 + ni * i_intv][::i_intv]
    img_paths = np.array([np.array(d['ims'])[view] for d in ims]).ravel()
    cam_idxs = np.array([np.arange(len(d['ims']))[view]
                         for d in ims]).ravel()

    imgs, masks, sampling = _zju_collect_images(
        subject_path, img_paths, cam_idxs, cams, H, W, res,
        erode_border=True)

    kp_ids = np.array([int(os.path.splitext(os.path.basename(p))[0])
                       for p in img_paths])
    kp_ids, kp_idxs = np.unique(kp_ids, return_inverse=True)

    bkgds = zju_background_median(imgs, masks, cam_idxs, num_cams)
    c2ws, focals, centers = zju_extrinsics_to_nerf(
        np.array(cams['R']), np.array(cams['T']), np.array(cams['K']),
        res=res)

    bones, betas, rhs, ths = _zju_load_params(subject_path, kp_ids,
                                              param_dir='new_params')
    if rest_pose_raw is None:
        rest_pose_raw = _zju_rest_pose_from_betas(
            betas, smpl_model_path=os.path.join(data_path, 'smplx', 'smpl'))
    pose = zju_smpl_to_pose_data(bones, rhs, ths, rest_pose_raw,
                                 ext_scale=ext_scale, scale_to_ref=False,
                                 skel=skel)

    data = {
        'imgs': imgs, 'bkgds': bkgds, 'bkgd_idxs': cam_idxs,
        'masks': masks, 'sampling_masks': sampling,
        'c2ws': c2ws, 'img_pose_indices': cam_idxs,
        'kp_idxs': np.asarray(kp_idxs), 'centers': centers,
        'focals': focals, 'kp3d': pose['kp3d'],
        'betas': betas.astype(np.float32), 'bones': pose['bones'],
        'skts': pose['skts'], 'cyls': pose['cyls'],
        'rest_pose': pose['rest_pose'],
        'ext_scale': np.array(ext_scale, np.float32),
        'img_shape': np.array([len(imgs), H, W, 3]),
    }
    return write_store(os.path.join(data_path,
                                    f'{subject}_{split}_h5py.npstore'), data)


# ---------------------------------------------------------------------------
# MPI-INF-3DHP
# ---------------------------------------------------------------------------

def process_3dhp_data(data_path: str, subject: str = 'S1',
                      ext_scale: float = 0.001, bbox_res: int = 224,
                      extend_iter: int = 2) -> str:
    """MPI-INF-3DHP SPIN estimates + frames -> store (reference
    load_3dhp.py:81-141)."""
    spin_data = read_spin_data(
        os.path.join(data_path, f'{subject}_SPIN_output.h5'),
        ext_scale=ext_scale, img_res=2048, bbox_res=bbox_res)
    img_paths = spin_data['img_path']

    imgs, masks = [], []
    for p in img_paths:
        p = p.decode() if isinstance(p, bytes) else str(p)
        imgs.append(_imread(os.path.join(data_path, p))[..., :3])
        mask_p = p.replace('/imageSequence/', '/FGmasks/')
        mask = _imread(os.path.join(data_path, mask_p))
        masks.append((mask[..., :1] >= 128).astype(np.uint8))
    masks = np.array(masks)

    data = {
        'imgs': np.array(imgs),
        'masks': masks,
        'sampling_masks': dilate_masks(masks[..., 0], extend_iter)[..., None],
        'bkgds': np.zeros((1, *masks.shape[1:3], 3), np.uint8),
        'bkgd_idxs': np.zeros(len(masks), np.int64),
        **{k: v for k, v in spin_data.items() if k != 'img_path'},
        'img_paths': np.array([str(p).encode() for p in img_paths]),
    }
    return write_store(os.path.join(data_path,
                                    f'{subject}_processed.npstore'), data)
