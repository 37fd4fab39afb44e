"""The port's offline tools against anerf_tpu's, on the CPU:
``data/spin.py`` (SPIN estimate ingestion), the SMPL sources of
``eval/metrics.py``'s pose metrics, ``data/mask_extract.py`` and its
command line ``anerf_torch.extract_masks``, and the numpy helpers
``ops/fk.get_rest_pose_from_l2ws_np``,
``ops/rays.get_near_far_in_cylinder_np`` and
``models/nerf_mlp.count_params``.

Inputs are those of ``tests/test_spin_zju.py``,
``tests/test_pose_eval_oracle.py`` and ``tests/test_mask_and_tbreader.py``.
Bars: numpy code copied from anerf_tpu bit-equal; the rotation-to-axis-
angle step (the port's ``ops/rotations`` on the CPU where anerf_tpu
runs jnp) and what FK builds from it within 1e-5; the FK source of
``pose_metrics_from_smpl_params`` (the port's torch FK) within 1e-5
relative.  The device entry points raise without CUDA unless the CPU is
asked for.
"""
import os
import pickle
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anerf_tpu.data import mask_extract as JM
from anerf_tpu.data import spin as JS
from anerf_tpu.eval import metrics as JE
from anerf_tpu.ops.rotations import axisang_to_rot
from anerf_torch.data import mask_extract as TM
from anerf_torch.data import spin as TS
from anerf_torch.eval import metrics as TE
from anerf_torch.skeleton import SMPL_REST_POSE

from test_torch_threads import one_torch_thread  # noqa: F401

ROT_TOL = 1e-5


def _spin_inputs(seed=1, n=3):
    """``test_spin_zju.test_process_spin_data_fk_consistency``'s inputs."""
    rng = np.random.RandomState(seed)
    bones = rng.normal(scale=0.2, size=(n, 24, 3)).astype(np.float32)
    rot_mats = np.asarray(axisang_to_rot(jnp.asarray(
        bones.reshape(-1, 3)))).reshape(n, 24, 3, 3)
    joints = rng.normal(scale=0.3, size=(n, 49, 3)).astype(np.float32)
    cams = np.abs(rng.rand(n, 3)) + 0.5
    bboxes = np.stack([rng.uniform(100, 400, n), rng.uniform(100, 400, n),
                       rng.uniform(150, 250, n)], -1)
    return rng, bones, rot_mats, joints, cams, bboxes


def _same(a, b, rot_keys=(), path=''):
    """Two outputs of the converters' dicts, key by key."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], rot_keys, k)
        return
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), path
        for x, y in zip(a, b):
            _same(x, y, rot_keys, path)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, path
    if path in rot_keys:
        np.testing.assert_allclose(b, a, rtol=ROT_TOL, atol=ROT_TOL,
                                   err_msg=path)
    else:
        assert np.array_equal(a, b), path


SPIN_ROT_KEYS = ('bones', 'kp3d', 'skts', 'cyls')


# ---- data/spin.py -------------------------------------------------------------

def test_spin_camera_and_bone_helpers_bit_equal():
    rng = np.random.RandomState(0)
    cam = np.abs(rng.rand(5, 3)) + 0.3
    bbox = np.stack([rng.uniform(100, 400, 5), rng.uniform(100, 400, 5),
                     rng.uniform(100, 300, 5)], -1)
    for kw in ({}, dict(new_focal=1234.)):
        _same(JS.convert_crop_cam_to_orig_img_and_focal(cam, bbox, 512, 480,
                                                        **kw),
              TS.convert_crop_cam_to_orig_img_and_focal(cam, bbox, 512, 480,
                                                        **kw))
        _same(JS.pred_cams_to_orig_cam_params(cam, bbox, 512, 480,
                                              ext_scale=0.3, **kw),
              TS.pred_cams_to_orig_cam_params(cam, bbox, 512, 480,
                                              ext_scale=0.3, **kw))
    pose = rng.normal(size=(24, 3)).astype(np.float32)
    _same(JS.calculate_bone_length(pose), TS.calculate_bone_length(pose))
    assert JS.DATASET_EXT_SCALE == TS.DATASET_EXT_SCALE


def test_rot_to_axisang_np_matches_jax():
    _, bones, rot_mats, _, _, _ = _spin_inputs()
    j, t = JS.rot_to_axisang_np(rot_mats), TS.rot_to_axisang_np(rot_mats)
    assert t.shape == j.shape == bones.shape and t.dtype == j.dtype
    np.testing.assert_allclose(t, j, rtol=0, atol=ROT_TOL)
    np.testing.assert_allclose(t, bones, rtol=0, atol=1e-4)


@pytest.mark.parametrize('scale_rest_pose', [True, False])
def test_process_spin_data_matches_jax(scale_rest_pose):
    _, _, rot_mats, joints, cams, bboxes = _spin_inputs()
    rest = SMPL_REST_POSE.copy() * 2.0
    kw = dict(rest_pose=rest, scale_rest_pose=scale_rest_pose, res=(480, 512))
    _same(JS.process_spin_data(None, cams, joints, rot_mats, bboxes, **kw),
          TS.process_spin_data(None, cams, joints, rot_mats, bboxes, **kw),
          SPIN_ROT_KEYS)


def _spin_dict(n=3):
    rng, _, rot_mats, joints, cams, bboxes = _spin_inputs(n=n)
    return {'img_path': np.array([f'img/{i:04d}.png'.encode()
                                  for i in range(n)]),
            'pred_betas': rng.normal(size=(n, 10)),
            'pred_joints': joints, 'pred_rot_mat': rot_mats,
            'bbox_params': bboxes, 'pred_camera': cams,
            'pose_3d': rng.normal(size=(n, 17, 3)),
            'selected_idx': np.arange(n)}


def test_read_spin_data_pkl_and_deepdish_h5(tmp_path):
    """A pickle, and an HDF5 file laid out as deepdish writes a dict
    (the arrays under ``/data``, one of them a group of one dataset)."""
    data = _spin_dict()
    pkl = str(tmp_path / 'spin.pkl')
    with open(pkl, 'wb') as f:
        pickle.dump(data, f)
    h5 = str(tmp_path / 'spin.h5')
    with h5py.File(h5, 'w') as f:
        g = f.create_group('data')
        for k, v in data.items():
            if k == 'pose_3d':
                g.create_group(k).create_dataset('i0', data=v)
            else:
                g.create_dataset(k, data=v)
    rest = SMPL_REST_POSE * 1.1
    for path in (pkl, h5):
        _same(JS.read_spin_data(path, rest_pose=rest, img_res=512),
              TS.read_spin_data(path, rest_pose=rest, img_res=512),
              SPIN_ROT_KEYS)
    _same(JS._load_deepdish_h5(h5), TS._load_deepdish_h5(h5))


def test_smplx_paths_raise_without_smplx(monkeypatch):
    """``rest_pose_from_betas`` and ``_smpl_vertices`` need the optional
    smplx package: without it both packages raise.  (Absent here, but
    tests/ref_oracle.py installs a stub of it into ``sys.modules`` for
    the reference's imports, which a worker that ran such a test before
    this one still holds: the test hides it.)"""
    monkeypatch.setitem(sys.modules, 'smplx', None)
    betas = np.zeros((1, 10), np.float32)
    for mod in (JS, TS):
        with pytest.raises(ImportError, match='smplx'):
            mod.rest_pose_from_betas(betas)
    bones = np.zeros((2, 24, 3), np.float32)
    for mod in (JE, TE):
        with pytest.raises(ImportError, match='smplx'):
            mod._smpl_vertices('smpl', betas, bones)
        with pytest.raises(ImportError, match='smplx'):
            mod.pose_metrics_from_smpl_params(
                np.zeros((2, 17, 3)), bones=bones, betas=betas,
                j_regressor=np.ones((17, 5)), smpl_model_path='smpl')


# ---- eval/metrics.py's SMPL sources -------------------------------------------

def _synthetic_vertices(seed=0, n=5, v=40):
    """``test_pose_eval_oracle._synthetic``."""
    rng = np.random.RandomState(seed)
    verts = rng.normal(scale=0.3, size=(n, v, 3)).astype(np.float32)
    reg = rng.uniform(0, 1, size=(17, v)).astype(np.float32)
    reg /= reg.sum(-1, keepdims=True)
    return verts, reg


def _close_scores(a, b, rtol=ROT_TOL):
    assert sorted(a) == sorted(b)
    for k in a:
        assert abs(a[k] - b[k]) <= rtol * abs(a[k]) + 1e-12, (k, a[k], b[k])


def test_vertex_source_matches_jax():
    verts, reg = _synthetic_vertices(seed=3)
    assert TE.SPIN_TO_CANON == JE.SPIN_TO_CANON
    assert TE.CANON_PELVIS == JE.CANON_PELVIS
    _same(JE.vertices2joints(reg, verts), TE.vertices2joints(reg, verts))
    pred = TE.h36m_joints_from_vertices(verts, reg)
    _same(JE.h36m_joints_from_vertices(verts, reg), pred)
    gt = (pred + np.random.RandomState(7).normal(scale=0.03, size=pred.shape)
          ).astype(np.float32)
    j = JE.pose_metrics_from_smpl_params(gt, vertices=verts, j_regressor=reg)
    t = TE.pose_metrics_from_smpl_params(gt, vertices=verts, j_regressor=reg)
    _close_scores(j, t)
    assert j == t       # the same numpy code


@pytest.mark.parametrize('pelvis', [False, True], ids=['no_pelvis', 'pelvis'])
def test_fk_source_matches_jax(pelvis):
    """Source 3 through the port's FK (torch, on the CPU) against
    anerf_tpu's jnp FK, within 1e-5 relative."""
    from anerf_torch.ops import fk as TF
    rng = np.random.RandomState(4)
    n = 6
    bones = rng.normal(scale=0.3, size=(n, 24, 3)).astype(np.float32)
    root = rng.normal(scale=0.1, size=(n, 3)).astype(np.float32) \
        if pelvis else None
    rest = SMPL_REST_POSE * 1.05
    noisy = bones + rng.normal(scale=0.05, size=bones.shape)
    gt = np.stack([TF.get_smpl_l2ws_np(b, rest)[:, :3, 3] for b in noisy])
    if pelvis:
        gt = gt + root[:, None]
    kw = dict(bones=bones, pelvis=root, rest_pose=rest)
    j = JE.pose_metrics_from_smpl_params(gt, **kw)
    t = TE.pose_metrics_from_smpl_params(gt, device='cpu', **kw)
    assert 10. < j['mpjpe'] < 1e3
    _close_scores(j, t)


def test_fk_source_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    bones = np.zeros((2, 24, 3), np.float32)
    with pytest.raises(RuntimeError, match='CUDA'):
        TE.pose_metrics_from_smpl_params(np.zeros((2, 24, 3)), bones=bones,
                                         rest_pose=SMPL_REST_POSE)


# ---- data/mask_extract.py and the command line ------------------------------

def _person_frames(n=2, H=40, W=32):
    """``test_mask_and_tbreader._person_frames``."""
    imgs = np.zeros((n, H, W, 3), np.uint8)
    imgs[:, 10:30, 8:24] = 200
    gt = np.zeros((n, H, W), np.uint8)
    gt[:, 10:30, 8:24] = 1
    return imgs, gt


@pytest.fixture(scope='module')
def thresh_model(tmp_path_factory):
    """``test_mask_and_tbreader``'s brightness-thresholding TorchScript
    'model': PASCAL logits, person (15) where the input is bright."""
    class Thresh(torch.nn.Module):
        def forward(self, x: torch.Tensor):
            raw = x[:, :1] * 0.229 + 0.485
            person = (raw > 0.5).float()
            logits = torch.zeros(x.shape[0], 21, x.shape[2], x.shape[3],
                                 device=x.device)
            logits[:, 15:16] = person * 10.
            logits[:, 0:1] = (1. - person) * 10.
            return {'out': logits}

    path = str(tmp_path_factory.mktemp('seg') / 'thresh.ts')
    torch.jit.script(Thresh()).save(path)
    return path


def test_mask_helpers_bit_equal():
    rng = np.random.default_rng(0)
    bk = (rng.random((40, 40, 3)) * 255).astype(np.uint8)
    imgs = np.repeat(bk[None], 2, 0).copy()
    imgs[:, 10:25, 12:28] = 250
    imgs[1, 30:33, 3:5] = 0         # a speck the opening removes
    _same(JM.masks_from_background(imgs, bk), TM.masks_from_background(
        imgs, bk))
    lab = rng.integers(0, 21, (1, 8, 8))
    _same(JM.segment_person(imgs, lambda x: lab),
          TM.segment_person(imgs, lambda x: lab))
    _same(JM.create_pascal_label_colormap(),
          TM.create_pascal_label_colormap())
    _same(JM.label_to_color_image(lab[0]), TM.label_to_color_image(lab[0]))
    assert TM.LABEL_NAMES == JM.LABEL_NAMES
    assert TM.PERSON_LABEL == JM.PERSON_LABEL == 15
    m = (rng.random((12, 12)) > 0.5).astype(np.uint8)
    for op in ('dilate', 'erode'):
        _same(JM._binary_morph(m, 3, op), TM._binary_morph(m, 3, op))


def test_torchscript_backend_matches_jax(thresh_model):
    imgs, gt = _person_frames()
    j_fn = JM.torchscript_seg_fn(thresh_model)
    t_fn = TM.torchscript_seg_fn(thresh_model, device='cpu')
    _same(j_fn(imgs), t_fn(imgs))
    for kw in (dict(input_size=None, dilate=0), dict(input_size=24,
                                                     dilate=1)):
        masks = TM.extract_masks(imgs, t_fn, **kw)
        _same(JM.extract_masks(imgs, j_fn, **kw), masks)
    np.testing.assert_array_equal(
        TM.extract_masks(imgs, t_fn, input_size=None, dilate=0)[..., 0], gt)
    bboxes = np.array([[16, 20, 16], [16, 20, 16]], np.float32)
    _same(JM.extract_bbox_masks(imgs, bboxes, j_fn, input_size=None,
                                mul=1.0, dilate=1),
          TM.extract_bbox_masks(imgs, bboxes, t_fn, input_size=None,
                                mul=1.0, dilate=1))


def test_model_backends_without_device_need_cuda(thresh_model, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        TM.torchscript_seg_fn(thresh_model)
    with pytest.raises(RuntimeError, match='CUDA'):
        TM.transformers_seg_fn(model=torch.nn.Identity())


@pytest.mark.parametrize('backend', ['background', 'torchscript'])
def test_extract_masks_command_line(tmp_path, thresh_model, backend):
    """``python -m anerf_torch.extract_masks`` on PNG frames: the masks
    it writes are anerf_tpu's functions' on the same frames."""
    import imageio.v2 as imageio
    from anerf_torch.extract_masks import main
    imgs, _ = _person_frames(n=3)
    frames = tmp_path / 'frames'
    frames.mkdir()
    for i, img in enumerate(imgs):
        imageio.imwrite(str(frames / f'{i:03d}.png'), img)
    out = str(tmp_path / 'masks')
    argv = ['--images', str(frames / '*.png'), '--backend', backend,
            '--out', out]
    if backend == 'background':
        bkgd = np.zeros_like(imgs[0])
        imageio.imwrite(str(tmp_path / 'bkgd.png'), bkgd)
        argv += ['--bkgd', str(tmp_path / 'bkgd.png')]
        ref = JM.masks_from_background(imgs, bkgd)
    else:
        argv += ['--model', thresh_model, '--input_size', '24', '--device',
                 'cpu']
        ref = JM.extract_masks(imgs, JM.torchscript_seg_fn(thresh_model),
                               input_size=24, dilate=1)
    masks = main(argv)
    _same(ref, masks)
    for i in range(3):
        png = imageio.imread(os.path.join(out, f'{i:03d}.png'))
        assert np.array_equal(png, ref[i, ..., 0] * 255)


# ---- the numpy helpers ------------------------------------------------------

def test_numpy_helpers_match_jax():
    from anerf_tpu.models import nerf_mlp as JN
    from anerf_tpu.ops import fk as JF
    from anerf_tpu.ops import rays as JR
    from anerf_torch.models import nerf_mlp as TN
    from anerf_torch.ops import fk as TF
    from anerf_torch.ops import rays as TR
    rng = np.random.RandomState(5)
    l2ws = TF.get_smpl_l2ws_np(rng.normal(scale=0.3, size=(24, 3)),
                               SMPL_REST_POSE * 0.9)
    rest = TF.get_rest_pose_from_l2ws_np(l2ws)
    _same(JF.get_rest_pose_from_l2ws_np(l2ws), rest)
    np.testing.assert_allclose(rest, SMPL_REST_POSE * 0.9, atol=1e-5)
    rays_o = rng.normal(size=(64, 3)).astype(np.float32)
    rays_d = rng.normal(size=(64, 3)).astype(np.float32)
    cyl = np.concatenate([rng.normal(scale=0.3, size=(64, 2)),
                          rng.uniform(0.2, 1.5, (64, 1)),
                          rng.normal(size=(64, 2))], -1).astype(np.float32)
    near, far = TR.get_near_far_in_cylinder_np(rays_o, rays_d, cyl)
    _same(JR.get_near_far_in_cylinder_np(rays_o, rays_d, cyl), (near, far))
    assert (near != 0.35).any() and (near == 0.35).any()
    cfg = JN.NeRFConfig(depth=2, width=16, input_ch=9, input_ch_bones=3,
                        input_ch_views=5, use_viewdirs=True)
    j_params = JN.init_nerf_params(jax.random.PRNGKey(0), cfg)
    t_params = jax.tree_util.tree_map(lambda x: torch.tensor(np.asarray(x)),
                                      j_params)
    assert TN.count_params(t_params) == JN.count_params(j_params) > 0
