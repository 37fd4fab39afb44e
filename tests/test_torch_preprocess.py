"""The port's raw-dataset converters (``anerf_torch/data/preprocess.py``)
against anerf_tpu's, on the CPU.

For each of the eight converters a synthetic raw tree of 2-4 frames at
32x32 is written with what this environment has (PNGs through imageio,
``.mat`` through ``scipy.io.savemat``, pickles, deepdish-style HDF5
through h5py, ``.npy``); anerf_tpu's converter writes its HDF5 file and
the port's writes a data store at the same name with ``.npstore`` for
``.h5`` (the name ``loaders.DATASET_CATALOG`` reads), and the two are
compared key by key: integer and uint8 arrays, byte strings and float
arrays bit-equal, except the float arrays that pass through
``ops/rotations`` (the SURREAL root bone, the SPIN estimates'
rotation-to-axis-angle step and what FK builds from them), held within
1e-5.  The ZJU store loads through the port's ``ZJUMocapDataset`` as
``tests/test_preprocess.py`` loads anerf_tpu's.  The pure helpers are
held bit-equal on random inputs.

The SPIN-based converters derive the rest pose from the estimated betas
through the SMPL body model (``spin.rest_pose_from_betas``, the optional
smplx package, absent here); both packages get one stand-in for it, a
canonical rest pose scaled by the betas' mean.
"""
import os
import pickle

import h5py
import imageio.v2 as imageio
import numpy as np
import pytest

from anerf_tpu.data import preprocess as JP
from anerf_torch.data import preprocess as TP
from anerf_torch.data.store import open_store

from test_torch_threads import one_torch_thread  # noqa: F401

S = 32          # image side
ROT_TOL = 1e-5
# the keys whose floats come through ops/rotations
SPIN_ROT_KEYS = ('bones', 'kp3d', 'skts', 'cyls')


def _compare(h5_path, store_path, rot_keys=()):
    """anerf_tpu's HDF5 file and the port's store, key by key."""
    assert store_path == h5_path[:-len('.h5')] + '.npstore'
    with h5py.File(h5_path, 'r') as f:
        ref = {k: f[k][()] for k in f}
    got = open_store(store_path)
    assert sorted(ref) == sorted(got)
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.dtype,
                                                           b.dtype)
        if k in rot_keys:
            np.testing.assert_allclose(b, a, rtol=ROT_TOL, atol=ROT_TOL,
                                       err_msg=k)
        else:
            assert np.array_equal(a, b), k
    return got


def _png(path, img):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    imageio.imwrite(path, img)


def _frames(rng, n, c=3):
    return rng.integers(0, 255, (n, S, S, c)).astype(np.uint8)


def _person(n, lo=8, hi=24, value=255):
    m = np.zeros((n, S, S), np.uint8)
    m[:, lo:hi, lo + 2:hi - 2] = value
    return m


def _spin_h5(path, img_paths, seed):
    """A deepdish-style SPIN output file: the arrays at the root."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    n = len(img_paths)
    rots = Rotation.from_rotvec(rng.normal(scale=0.3, size=(n * 24, 3))
                                ).as_matrix().reshape(n, 24, 3, 3)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with h5py.File(path, 'w') as f:
        f.create_dataset('img_path', data=np.array(
            [p.encode() for p in img_paths]))
        f.create_dataset('pred_betas', data=rng.normal(size=(n, 10)))
        f.create_dataset('pred_joints',
                         data=rng.normal(scale=0.3, size=(n, 49, 3)))
        f.create_dataset('pred_rot_mat', data=rots.astype(np.float32))
        f.create_dataset('bbox_params', data=np.stack(
            [rng.uniform(12, 20, n), rng.uniform(12, 20, n),
             rng.uniform(20, 30, n)], -1))
        f.create_dataset('pred_camera', data=np.abs(rng.normal(
            size=(n, 3))) + 0.5)


# ---- SURREAL ----------------------------------------------------------------

def _surreal_tree(root):
    """One sequence of 2 poses seen by 2 cameras: metadata.pickle, a
    segmentation .mat and 4 renders."""
    from scipy.io import savemat
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(0)
    n_kp, n_cam = 2, 2
    d = os.path.join(root, 'seq_0')
    cams = np.tile(np.eye(4, dtype=np.float32), (n_cam, 1, 1))
    cams[:, :3, :3] = Rotation.from_rotvec(rng.normal(
        scale=0.1, size=(n_cam, 3))).as_matrix()
    cams[:, 2, 3] = 2.5 / JP.DATASET_EXT_SCALE / 0.001
    meta = {'focal': 30., 'int_scale': 1., 'render_type': 'a', 'cams': cams,
            'N_kp': n_kp, 'N_cams': n_cam, 'N_cam_per_subdir': n_cam,
            'joints3D': rng.normal(scale=100., size=(n_kp, 24, 3)),
            'poses': rng.normal(scale=0.2, size=(n_kp, 72))}
    os.makedirs(os.path.join(d, 'cam-0', 'imageSequences'))
    with open(os.path.join(d, 'metadata.pkl'), 'wb') as f:
        pickle.dump(meta, f)
    savemat(os.path.join(d, 'cam-0', 'run_segm.mat'),
            {'data': _person(n_cam * n_kp, value=3)})
    for i, img in enumerate(_frames(rng, n_cam * n_kp, 4)):
        _png(os.path.join(d, 'cam-0', 'imageSequences', f'{i:04d}.png'), img)


def test_process_surreal_data(tmp_path):
    root = str(tmp_path)
    _surreal_tree(root)
    h5 = os.path.join(root, 'surreal', 'surreal_train_h5py.h5')
    j = JP.process_surreal_data(h5, root)
    store = h5[:-3] + '.npstore'
    t = TP.process_surreal_data(store, root)
    assert sorted(j) == sorted(t)
    got = _compare(h5, store, rot_keys=('bones', 'skts'))
    assert got['sampling_masks'].sum() > 0


# ---- SPIN-based converters: MonoPerfCap, Mixamo, MPI-INF-3DHP ---------------

@pytest.fixture
def body_model(monkeypatch):
    """The stand-in for the SMPL body model's rest pose, in both
    packages' ``spin`` modules."""
    from anerf_tpu.data import spin as JS
    from anerf_torch.data import spin as TS
    from anerf_torch.skeleton import SMPL_REST_POSE

    def rest_pose_from_betas(betas, gender='NEUTRAL', smpl_model_path='smpl'):
        return SMPL_REST_POSE * np.float32(1 + 0.01 * np.mean(betas))
    for mod in (JS, TS):
        monkeypatch.setattr(mod, 'rest_pose_from_betas', rest_pose_from_betas)


def test_process_perfcap_data(tmp_path, body_model):
    root, subj = str(tmp_path), 'Weipeng_outdoor'
    rng = np.random.default_rng(1)
    paths = [f'MonoPerfCap/{subj}/images/{i:06d}.png' for i in range(3)]
    for p, img, m in zip(paths, _frames(rng, 3), _person(3, value=3)):
        _png(os.path.join(root, p), img)
        _png(os.path.join(root, p.replace('/images/', '/masks/')), m)
    _png(os.path.join(root, 'MonoPerfCap', subj, 'bkgd.png'),
         _frames(rng, 1)[0])
    _spin_h5(os.path.join(root, 'MonoPerfCap', f'MonoPerfCap-{subj}.h5'),
             paths, 2)
    h5 = JP.process_perfcap_data(root, subj)
    _compare(h5, TP.process_perfcap_data(root, subj), SPIN_ROT_KEYS)


def test_process_mixamo_data(tmp_path, body_model):
    root, subj = str(tmp_path), 'James'
    rng = np.random.default_rng(3)
    paths = [f'{subj}/{seq}/Camera_{c}/Image{k:04d}.png'
             for seq in ('walk', 'run') for k in (1,) for c in (0, 1)]
    for p, img, m in zip(paths, _frames(rng, len(paths)),
                         _person(len(paths), value=3)):
        _png(os.path.join(root, p), img)
        d, name = os.path.dirname(p), os.path.basename(p)
        _png(os.path.join(root, d, 'Masks', name),
             np.repeat(m[..., None], 3, -1))
    for seq in ('walk', 'run'):
        meta = {'gt_pose': [{f'j{i}': rng.normal(size=3) for i in range(4)}
                            for _ in range(1)]}
        with open(os.path.join(root, subj, seq, 'Camera_0',
                               'metadata.pickle'), 'wb') as f:
            pickle.dump(meta, f)
    _spin_h5(os.path.join(root, subj, f'{subj}.h5'), paths, 4)
    h5 = JP.process_mixamo_data(root, subj, n_cam=2)
    _compare(h5, TP.process_mixamo_data(root, subj, n_cam=2),
             SPIN_ROT_KEYS)


def test_process_3dhp_data(tmp_path, body_model):
    root = str(tmp_path)
    rng = np.random.default_rng(5)
    paths = [f'S1/Seq1/imageSequence/video_0/frame_{i:06d}.jpg.png'
             for i in range(3)]
    for p, img, m in zip(paths, _frames(rng, 3), _person(3)):
        _png(os.path.join(root, p), img)
        _png(os.path.join(root, p.replace('/imageSequence/', '/FGmasks/')),
             np.repeat(m[..., None], 3, -1))
    _spin_h5(os.path.join(root, 'S1_SPIN_output.h5'), paths, 6)
    h5 = JP.process_3dhp_data(root, 'S1')
    _compare(h5, TP.process_3dhp_data(root, 'S1'), SPIN_ROT_KEYS)


# ---- Human3.6M ----------------------------------------------------------------

def _h36m_paths(seqs):
    """A frame of each camera, in the sequence ``seqs`` names for it
    (Sitting is a chair sequence)."""
    return [f'S9/{seq}-1.{cam}/000001.png'
            for seq, cam in zip(seqs, JP.H36M_CAMERAS)]


def _h36m_tree(root, seqs):
    rng = np.random.default_rng(7)
    paths = _h36m_paths(seqs)
    for p, img in zip(paths, _frames(rng, len(paths))):
        _png(os.path.join(root, p), img)
    masks = (_person(len(paths)) > 0).astype(np.uint8)[..., None]
    for name in ('S9_mask_fixed.h5', 'S9_mask_deeplab_crop.h5'):
        with h5py.File(os.path.join(root, name), 'w') as f:
            f.create_dataset('index', data=np.array(
                [p.encode() for p in paths]))
            f.create_dataset('masks', data=masks)
    for name in ('S9_clean_bkgds.npy', 'S9_chair_bkgds.npy'):
        np.save(os.path.join(root, name), _frames(rng, 4))
    _spin_h5(os.path.join(root, 'S9_SPIN_rect_output-maxmin.h5'), paths, 8)
    return paths


@pytest.mark.parametrize('chair', [False, True], ids=['clean', 'chair'])
def test_extract_background(tmp_path, chair):
    """Each package on its own copy of the tree (both write the plates
    to the same ``.npy`` name)."""
    out = {}
    seqs = ['Sitting' if chair else 'Walking'] * 4
    for name, mod in (('jax', JP), ('torch', TP)):
        root = str(tmp_path / name)
        _h36m_tree(root, seqs)
        plates = mod.extract_background(root, 'S9', use_chair_seqs=chair)
        kind = 'chair' if chair else 'clean'
        saved = np.load(os.path.join(root, f'S9_{kind}_bkgds_.npy'))
        assert np.array_equal(saved, plates)
        out[name] = plates
    assert out['jax'].dtype == out['torch'].dtype == np.uint8
    assert np.array_equal(out['jax'], out['torch'])
    assert out['torch'].any()


def test_process_h36m_data(tmp_path, body_model):
    root = str(tmp_path)
    _h36m_tree(root, ['Walking', 'Walking', 'Sitting', 'Sitting'])
    h5 = JP.process_h36m_data(root, 'S9')
    got = _compare(h5, TP.process_h36m_data(root, 'S9'), SPIN_ROT_KEYS)
    # the chair sequence's frames take the chair plates
    assert list(got['bkgd_idxs']) == [0, 1, 6, 7]


# ---- ZJU-MoCap and H36M in its layout -----------------------------------------

def _zju_subject(subj, n_frames, n_cams, param_dir, rng, frame_ids=None):
    """The NeuralBody layout under ``subj``: per-camera frames, masks,
    SMPL parameters and annots.npy."""
    from scipy.spatial.transform import Rotation
    frame_ids = list(range(n_frames)) if frame_ids is None else frame_ids
    ims = []
    for f in frame_ids:
        rels = []
        for c in range(n_cams):
            rel = f'cam{c}/{f:06d}.jpg'
            _png(os.path.join(subj, rel), _frames(rng, 1)[0])
            _png(os.path.join(subj, 'mask', f'cam{c}', f'{f:06d}.png'),
                 _person(1)[0])
            rels.append(rel)
        ims.append({'ims': rels})
        os.makedirs(os.path.join(subj, param_dir), exist_ok=True)
        np.save(os.path.join(subj, param_dir, f'{f}.npy'), {
            'poses': rng.normal(scale=0.05, size=(1, 72)).astype(np.float32),
            'shapes': rng.normal(scale=0.1, size=(1, 10)).astype(np.float32),
            'Rh': rng.normal(scale=0.2, size=(1, 3)).astype(np.float32),
            'Th': rng.normal(size=(1, 3)).astype(np.float32)})
    Ks = np.tile(np.diag([800., 800., 1.]), (n_cams, 1, 1))
    Ks[:, 0, 2] = Ks[:, 1, 2] = 512.0
    np.save(os.path.join(subj, 'annots.npy'), {
        'cams': {'K': list(Ks), 'D': [np.zeros(5)] * n_cams,
                 'R': list(Rotation.from_rotvec(rng.normal(
                     scale=0.2, size=(n_cams, 3))).as_matrix()),
                 'T': list(rng.normal(size=(n_cams, 3, 1)) * 500. + 2000.)},
        'ims': ims})


def _rest_raw():
    from anerf_torch.skeleton import SMPL_REST_POSE
    return SMPL_REST_POSE * 0.9 + np.array([0.01, -0.3, 0.02], np.float32)


def test_process_zju_data(tmp_path, monkeypatch):
    """``test_preprocess.py``'s raw layout (3 frames, 2 cameras), and the
    store read back through the port's ``ZJUMocapDataset``."""
    from anerf_torch.data.loaders import ZJUMocapDataset
    root = str(tmp_path)
    _zju_subject(os.path.join(root, 'CoreView_377'), 3, 2, 'params',
                 np.random.default_rng(9))
    for mod in (JP, TP):
        monkeypatch.setitem(mod.ZJU_NUM_TRAIN_FRAMES, '377', 3)
    kw = dict(subject='377', training_view=(0, 1), split='train',
              res=S / 1024.0, rest_pose_raw=_rest_raw())
    h5 = JP.process_zju_data(root, **kw)
    store = TP.process_zju_data(root, **kw)
    _compare(h5, store)
    ds = ZJUMocapDataset(store, subject='377', N_samples=8, split='full')
    out = ds.get_item(2, np.random.default_rng(0))   # frame 1, cam 0
    assert out['rays_o'].shape == (8, 3)
    np.testing.assert_allclose(out['kp3d'][0], ds.kp3d[1], atol=1e-6)
    assert int(ds.cam_idxs_lut[2]) == 0


def test_process_h36m_zju_data(tmp_path, monkeypatch):
    """The Posing sequence at frame interval 5: 2 training frames of 2
    cameras (frames 0 and 5 of 10), resized from 32 to 1000 x res."""
    root = str(tmp_path)
    _zju_subject(os.path.join(root, 'S1', 'Posing'), 10, 2, 'new_params',
                 np.random.default_rng(11))
    for mod in (JP, TP):
        monkeypatch.setitem(mod.H36M_ZJU_FRAMES, 'S1', (2, 1))
    kw = dict(subject='S1', training_view=(0, 1), split='train',
              res=S / 1000.0, rest_pose_raw=_rest_raw())
    h5 = JP.process_h36m_zju_data(root, **kw)
    got = _compare(h5, TP.process_h36m_zju_data(root, **kw))
    assert got['imgs'].shape == (4, S * S, 3)
    assert list(got['kp_idxs']) == [0, 0, 1, 1]


# ---- the pure helpers ---------------------------------------------------------

def test_helpers_bit_equal():
    rng = np.random.default_rng(12)
    masks = (rng.random((3, 20, 20)) > 0.9).astype(np.uint8)
    for it, k in ((1, 5), (2, 3)):
        assert np.array_equal(JP.dilate_masks(masks, it, k),
                              TP.dilate_masks(masks, it, k))
        assert np.array_equal(JP.dilate_masks(masks[..., None], it, k),
                              TP.dilate_masks(masks[..., None], it, k))
    paths = [b'a/Image0001.png', b'a/Image0002.png', b'a/Image0004.png',
             b'b/Image0005.png', b'b/Image0006.png']
    for a, b in zip(JP.get_temporal_validity(paths),
                    TP.get_temporal_validity(paths)):
        assert np.array_equal(a, b)
    kp = rng.integers(0, 2, 16)
    assert np.array_equal(JP.remap_mixamo_kp_idxs(kp, [8, 8], 4),
                          TP.remap_mixamo_kp_idxs(kp, [8, 8], 4))
    c2ws = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    c2ws[:, 2, 3] = 2.0
    kps = rng.normal(scale=0.2, size=(2, 5, 3)).astype(np.float32)
    assert np.array_equal(JP.skeleton3d_to_2d(kps, c2ws, 64, 64, [90., 100.]),
                          TP.skeleton3d_to_2d(kps, c2ws, 64, 64, [90., 100.]))
    imgs = rng.integers(0, 255, (6, 8, 8, 3)).astype(np.uint8)
    fg = (rng.random((6, 8, 8, 1)) > 0.5).astype(np.uint8)
    cam = np.array([0, 0, 0, 1, 1, 1])
    assert np.array_equal(JP.zju_background_median(imgs, fg, cam, 3),
                          TP.zju_background_median(imgs, fg, cam, 3))
    for name in ('ZJU_TO_NERF_ROT', 'SURREAL_BETAS', 'H36M_CAMERAS',
                 'H36M_CHAIR_SEQS', 'ZJU_NUM_TRAIN_FRAMES', 'ZJU_BEGIN_FRAME',
                 'H36M_ZJU_FRAMES'):
        a, b = getattr(JP, name), getattr(TP, name)
        assert type(a) is type(b) and np.array_equal(a, b) if isinstance(
            a, np.ndarray) else a == b, name
