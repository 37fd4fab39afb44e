"""The port's rendering entry point and the modules it needs, against
anerf_tpu on the CPU.

Same numpy inputs (made from seeds) go through both packages:
- the eight render-pose generators, at 1e-5 on the FK output (kp3d,
  skts), the cameras, the focals, the framecode rows and the bones
  (pose-rotate's root bones through their rotation matrices: at an
  angle of pi the axis-angle's sign is arbitrary);
- ``pose_params_to_pose_data`` on a rot6d bank and ``rot_to_axisang``
  (random rotations and angles near 0 and pi), at 1e-5;
- the render catalog, equal apart from the store suffix;
- ``render_pts_density`` at 1e-5 x the density's max (both f32 plain
  paths: they differ in summation order only), ``extract_mesh`` at
  res 16 (the same vertex and face counts, vertices within 1e-4), and
  the host mesh code bit for bit;
- the PNG writer and ``save_images`` read back with imageio, and
  ``draw_skeleton_2d`` against anerf_tpu's cv2 drawing, pixel for pixel;
- ``anerf_torch.run_render.main`` against ``run_render.main`` on an
  anerf_tpu checkpoint of ``configs/synthetic_tiny.txt``: the same file
  names, frames within 1e-3 x the frame's max (the render bar of
  tests/test_torch_render.py) and eval scores within 1e-3; every render
  type from the msgpack, the port's ``.pt`` and a reference ``.tar``.
"""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anerf_tpu.render import catalog as j_catalog
from anerf_tpu.render import mesh as j_mesh
from anerf_tpu.render import poses as j_poses

from anerf_torch import testing_utils as T
from anerf_torch.interop import params_from_numpy
from anerf_torch.ops import rotations as t_rot
from anerf_torch.render import catalog as t_catalog
from anerf_torch.render import mesh as t_mesh
from anerf_torch.render import poses as t_poses

from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, 'configs', 'synthetic_tiny.txt')
TOL = 1e-5


def _scene(n=6, seed=0):
    """kps, bones, c2ws, focals, rest_pose of ``n`` random frames."""
    rest, bones, _, kps, _, _ = T.synthetic_pose(n, seed=seed)
    rng = np.random.RandomState(seed + 100)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        a = rng.uniform(-0.5, 0.5)
        c2ws[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                           [-np.sin(a), 0, np.cos(a)]]
        c2ws[i, :3, 3] = rng.normal(scale=0.1, size=3) + [0, 0, 2.7]
    focals = rng.uniform(40, 60, n).astype(np.float32)
    return kps, bones, c2ws, focals, rest


def _rot(aa):
    return t_rot.axisang_to_rot(torch.as_tensor(aa, dtype=torch.float32))


GENERATORS = {
    'bullet': lambda P, s: P.load_bullettime(
        *s, [0, 2], n_bullet=3, undo_rot=True, center_cam=True,
        center_kps=False),
    'retarget': lambda P, s: P.load_retarget(
        *s, [0, 2], length=3, skip=2, center_kps=True),
    'interpolate': lambda P, s: P.load_interpolate(
        *s, [0, 2, 3], n_step=3, center_cam=True, mix_framecodes=True),
    'animate': lambda P, s: P.load_animate(
        *s, [0, 1, 3], joints=[16, 18, 20], n_step=3, center_kps=True),
    # frame 4's root unrotated: the orbit's 180-degree steps are at pi
    'poserot': lambda P, s: P.load_pose_rotate(
        s[0], np.where(np.arange(6)[:, None, None] * np.eye(24)[:, :1] == 4,
                       0., s[1]), *s[2:], [4], n_bullet=12),
    'correction': lambda P, s: P.load_correction(
        s[0] + 0.01, s[1] * 0.5, *s, [0, 3], n_step=3),
    'selected': lambda P, s: P.load_selected(*s, [2, 4]),
    'bubble': lambda P, s: P.load_bubble(*s, [0, 5], n_step=4),
}


@pytest.mark.parametrize('name', sorted(GENERATORS))
def test_pose_generators_match_jax(name):
    s = _scene()
    ref = GENERATORS[name](j_poses, s)
    got = GENERATORS[name](t_poses, s)
    assert sorted(ref) == sorted(got)
    for k in ref:
        a = np.asarray(ref[k], np.float64)
        b = np.asarray(got[k], np.float64)
        assert a.shape == b.shape, k
        if name == 'poserot' and k == 'bones':
            # the orbit passes through pi: compare the rotations
            a, b = _rot(ref[k]).numpy(), _rot(got[k]).numpy()
        np.testing.assert_allclose(b, a, atol=TOL, rtol=0, err_msg=k)
    if name == 'poserot':
        # the orbit's root angles do reach pi (the hard case)
        assert (got['bones'][:, 1:] == s[1][4, 1:]).all()
        angles = np.linalg.norm(got['bones'][:, 0], axis=-1)
        assert np.abs(angles - np.pi).min() < 1e-3


def test_rot_to_axisang_matches_jax():
    """Random rotations and angles near 0 and pi: the rotation rebuilt
    from the port's axis-angle is the input, and the JAX one's."""
    from anerf_tpu.ops import rotations as j_rot
    rng = np.random.RandomState(3)
    axes = rng.normal(size=(60, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    angles = np.concatenate([
        rng.uniform(0, np.pi, 20),
        [0., 1e-8, 1e-6, 1e-4, 1e-3, 1e-2] + list(rng.uniform(0, 1e-3, 4)),
        np.pi - np.array([0., 1e-7, 1e-5, 1e-4, 1e-3, 1e-2, 3e-2]),
        np.pi - rng.uniform(0, 1e-3, 23)])
    R = _rot(axes * angles[:, None]).numpy()
    got = t_rot.rot_to_axisang(torch.as_tensor(R))
    ref = np.asarray(j_rot.rot_to_axisang(jnp.asarray(R)))
    np.testing.assert_allclose(_rot(got.numpy()).numpy(), R, atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(_rot(got.numpy()).numpy(), _rot(ref).numpy(),
                               atol=TOL, rtol=0)
    # quaternions with w >= 0 agree wherever the angle is below pi
    q_t = t_rot.rot_to_quat(torch.as_tensor(R)).numpy()
    q_j = np.asarray(j_rot.rot_to_quat(jnp.asarray(R)))
    below = angles < np.pi - 1e-2
    np.testing.assert_allclose(q_t[below], q_j[below], atol=TOL, rtol=0)


def test_pose_params_to_pose_data_matches_jax():
    from anerf_tpu.training.pose_opt import pose_params_to_pose_data as jf
    from anerf_torch.training.pose_opt import pose_params_to_pose_data as tf
    rest, bones, pelvis, _, _, _ = T.synthetic_pose(7, seed=2)
    rng = np.random.RandomState(2)
    rot6d = t_rot.rot_to_rot6d(_rot(bones * 4.)).numpy() \
        + rng.normal(scale=0.05, size=(7, 24, 6)).astype(np.float32)
    bank = {'pelvis': pelvis, 'bones': rot6d}
    ref = jf(bank, rest, ext_scale=0.001)
    got = tf({k: torch.as_tensor(v) for k, v in bank.items()}, rest,
             ext_scale=0.001)
    assert len(ref) == len(got) == 6
    for a, b in zip(ref, got):
        assert isinstance(b, np.ndarray) and b.dtype == np.float32
        np.testing.assert_allclose(b, np.asarray(a), atol=TOL, rtol=0)


def _catalog_entries():
    cat = j_catalog.init_catalog(data_root='/nonexistent')
    return [f'{d}/{e}' for d, ents in sorted(cat.items())
            for e in sorted(ents) if e != 'gt_to_mask_map']


@pytest.mark.parametrize('entry', _catalog_entries())
def test_catalog_entry_matches_jax(entry, tmp_path):
    """Every render type of the entry resolves to anerf_tpu's dict, the
    data path to the store beside its HDF5 file."""
    (tmp_path / 'h36m').mkdir()
    np.save(tmp_path / 'h36m' / 'S9_val_idxs.npy', np.arange(3, 9))
    root = str(tmp_path)
    ds, name = entry.split('/')
    types = [k for k in j_catalog.init_catalog(data_root=root)[ds][name]
             if k not in ('data_h5', 'refined', 'idx_map')]
    assert types
    for rt in types:
        ref = j_catalog.resolve_entry(entry, rt, data_root=root)
        got = t_catalog.resolve_entry(entry, rt, data_root=root)
        assert sorted(ref) == sorted(got)
        assert got['data_h5'] == os.path.splitext(ref['data_h5'])[0] \
            + '.npstore'
        assert ref['data_h5'].endswith('.h5')
        for k in ref:
            if k != 'data_h5':
                a, b = ref[k], got[k]
                assert np.array_equal(np.asarray(a), np.asarray(b)), (rt, k)
    with pytest.raises(KeyError):
        t_catalog.resolve_entry(entry, 'nosuchtype', data_root=root)


def _density_scene(with_fine=True):
    from anerf_tpu.models.factory import build_raycast_config as j_build
    from anerf_tpu.models.factory import embed_state as j_state
    from anerf_tpu.models.factory import init_raycaster_params as j_init
    from anerf_tpu.utils.config import load_config as j_load
    from anerf_torch.models.factory import build_raycast_config as t_build
    from anerf_torch.models.factory import embed_state as t_state
    from anerf_torch.utils.config import load_config as t_load
    j_cfg, t_cfg = j_load(TINY), t_load(TINY)
    j_rc = j_build(j_cfg, n_framecodes=4)
    t_rc = t_build(t_cfg, n_framecodes=4)
    j_params = j_init(jax.random.PRNGKey(1), j_rc, j_cfg)
    if not with_fine:
        j_params = dict(j_params, fine=None)
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        j_params))
    rest, bones, pelvis, kps, skts, _ = T.synthetic_pose(1, seed=5)
    pose = {'kps': kps, 'skts': skts, 'bones': bones}
    return (j_rc, j_params, j_state(j_cfg, j_rc, 500), t_rc, t_params,
            t_state(t_cfg, t_rc, 500), pose)


@pytest.mark.parametrize('with_fine', [True, False])
def test_render_pts_density_matches_jax(with_fine):
    from anerf_tpu.models.raycaster import render_pts_density as jf
    from anerf_torch.models.raycaster import render_pts_density as tf
    j_rc, j_p, j_st, t_rc, t_p, t_st, pose = _density_scene(with_fine)
    rng = np.random.RandomState(0)
    pts = (pose['kps'][0, :1] + rng.uniform(-0.4, 0.4, (300, 1, 3))
           ).astype(np.float32)
    ref = np.asarray(jf(j_rc, j_p, jnp.asarray(pts),
                        {k: jnp.asarray(v) for k, v in pose.items()}, j_st))
    with torch.inference_mode():
        got = tf(t_rc, t_p, torch.as_tensor(pts),
                 {k: torch.as_tensor(v) for k, v in pose.items()},
                 t_st).numpy()
    assert got.shape == ref.shape == (300, 1, 1)
    scale = np.abs(ref).max()
    assert scale > 0 and np.abs(got - ref).max() <= TOL * scale


def test_extract_mesh_matches_jax():
    j_rc, j_p, j_st, t_rc, t_p, t_st, pose = _density_scene()
    j_pose = {k: jnp.asarray(v) for k, v in pose.items()}
    t_pose = {k: torch.as_tensor(v) for k, v in pose.items()}
    sig_j = j_mesh.extract_density_grid(j_rc, j_p, j_pose, radius=0.5,
                                        res=16, state=j_st)
    sig_t = t_mesh.extract_density_grid(t_rc, t_p, t_pose, radius=0.5,
                                        res=16, state=t_st)
    assert sig_t.shape == sig_j.shape == (17, 17, 17)
    assert np.abs(sig_t - sig_j).max() <= TOL * np.abs(sig_j).max()
    # a threshold in the widest gap between grid values around the 80th
    # percentile, so that no corner sits within rounding of it
    v = np.sort(sig_j.ravel())
    i = int(0.8 * len(v))
    k = i - 50 + int(np.argmax(np.diff(v[i - 50:i + 50])))
    thres = float(0.5 * (v[k] + v[k + 1]))
    ref = j_mesh.extract_mesh(j_rc, j_p, j_pose, radius=0.5, res=16,
                              threshold=thres, state=j_st)
    got = t_mesh.extract_mesh(t_rc, t_p, t_pose, radius=0.5, res=16,
                              threshold=thres, state=t_st)
    assert len(ref[0]) > 0
    assert got[0].shape == ref[0].shape and got[1].shape == ref[1].shape
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[0], ref[0], atol=1e-4, rtol=0)


def test_host_mesh_code_equals_numpy_original(tmp_path):
    rng = np.random.RandomState(4)
    sigma = rng.normal(size=(9, 10, 8))
    kw = dict(threshold=0.3, origin=np.array([0.1, -0.2, 0.3]), spacing=0.5)
    verts, faces = j_mesh.marching_tetrahedra(sigma, **kw)
    got = t_mesh.marching_tetrahedra(sigma, **kw)
    assert len(faces) > 0
    np.testing.assert_array_equal(got[0], verts)
    np.testing.assert_array_equal(got[1], faces)
    np.testing.assert_array_equal(
        t_mesh.compute_vertex_normals(verts, faces),
        j_mesh.compute_vertex_normals(verts, faces))
    np.testing.assert_array_equal(
        t_mesh.rasterize_mesh(verts, faces, 40, 48),
        j_mesh.rasterize_mesh(verts, faces, 40, 48))
    c2w = np.eye(4)
    c2w[:3, 3] = verts.mean(0) + [0., 0., 6.]
    img = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        t_mesh.overlay_mesh(img, verts, faces, c2w, 30.),
        j_mesh.overlay_mesh(img, verts, faces, c2w, 30.))
    np.testing.assert_array_equal(
        t_mesh.render_turntable(verts, faces, n_views=3, H=24, W=24),
        j_mesh.render_turntable(verts, faces, n_views=3, H=24, W=24))
    t_mesh.save_ply(str(tmp_path / 't.ply'), verts, faces)
    j_mesh.save_ply(str(tmp_path / 'j.ply'), verts, faces)
    assert (tmp_path / 't.ply').read_bytes() == \
        (tmp_path / 'j.ply').read_bytes()
    for a, b in zip(t_mesh.load_ply(str(tmp_path / 't.ply')),
                    j_mesh.load_ply(str(tmp_path / 'j.ply'))):
        np.testing.assert_array_equal(a, b)


def test_png_writer_reads_back_bit_equal(tmp_path):
    import imageio.v2 as iio
    from anerf_tpu.utils.logging import save_images as j_save
    from anerf_torch.utils.image import write_png
    from anerf_torch.utils.logging import save_images as t_save
    rng = np.random.RandomState(0)
    for shape in ((1, 1, 3), (17, 23, 3), (64, 48, 3)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        write_png(str(tmp_path / 'a.png'), img)
        np.testing.assert_array_equal(iio.imread(str(tmp_path / 'a.png')),
                                      img)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / 'b.png'), np.zeros((4, 4), np.uint8))
    frames = rng.uniform(-0.1, 1.1, (3, 20, 24, 3)).astype(np.float32)
    t_save(str(tmp_path / 't'), frames, prefix='x')
    j_save(str(tmp_path / 'j'), frames, prefix='x')
    assert sorted(os.listdir(tmp_path / 't')) == \
        sorted(os.listdir(tmp_path / 'j')) == \
        ['x0000.png', 'x0001.png', 'x0002.png']
    for f in os.listdir(tmp_path / 'j'):
        np.testing.assert_array_equal(iio.imread(str(tmp_path / 't' / f)),
                                      iio.imread(str(tmp_path / 'j' / f)))


def test_save_video_names_and_fallback(tmp_path, monkeypatch, capsys):
    """With imageio present both packages write the same files (here
    its mp4 writer lacks ffmpeg, so both fall back to PNGs); without
    imageio the port writes the same PNGs and says so."""
    import imageio.v2 as iio
    from anerf_tpu.utils.logging import save_video as j_video
    from anerf_torch.utils.logging import save_video as t_video
    frames = np.random.RandomState(1).uniform(
        0, 1, (2, 12, 16, 3)).astype(np.float32)
    for d, fn in (('j', j_video), ('t', t_video)):
        (tmp_path / d).mkdir()
        fn(str(tmp_path / d / 'v.mp4'), frames)
    assert sorted(os.listdir(tmp_path / 't')) == \
        sorted(os.listdir(tmp_path / 'j'))
    monkeypatch.setitem(sys.modules, 'imageio', None)
    (tmp_path / 'n').mkdir()
    t_video(str(tmp_path / 'n' / 'v.mp4'), frames)
    assert 'imageio is not installed' in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / 'n')) == ['v_0000.png', 'v_0001.png']
    monkeypatch.undo()
    for i in range(2):
        np.testing.assert_array_equal(
            iio.imread(str(tmp_path / 'n' / f'v_{i:04d}.png')),
            (np.clip(frames[i], 0, 1) * 255).astype(np.uint8))


def test_draw_skeleton_matches_cv2():
    """The numpy drawing against anerf_tpu's cv2 one: joint dots and
    bone lines (OpenCV's clipping and Bresenham steps) pixel for pixel,
    with joints inside, on the edge of and outside the frame."""
    from anerf_tpu.utils.logging import draw_skeleton_2d as jf
    from anerf_torch.utils.logging import draw_skeleton_2d as tf
    _, _, _, kps, _, _ = T.synthetic_pose(3, seed=7)
    rng = np.random.RandomState(7)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 1.5
    for i in range(3):
        img = rng.uniform(0, 1, (64, 80, 3)).astype(np.float32)
        focal = 40. + 40. * i      # the limbs leave the frame at i > 0
        kp = (kps[i] - kps[i, :1]) * 400.     # root-centred, enlarged
        ref = jf(img, kp, c2w, focal)
        got = tf(img, kp, c2w, focal)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        differ = int((got != ref).any(-1).sum())
        assert differ == 0, differ
        drawn = (got != (np.clip(img, 0, 1) * 255).astype(np.uint8)
                 .astype(np.float32) / 255.).any(-1).sum()
        assert drawn > 50


# --- the entry point against run_render.py -------------------------------

def _reference_tar(path, params, pose_params, step):
    """A checkpoint in the reference's torch layout (nn.Linear weights
    (out, in), ``views_linears.0``), without the cutoff radii, which the
    entry points then rebuild from the config."""
    def net(p):
        sd = {}
        for i, lin in enumerate(p['pts_linears']):
            sd[f'pts_linears.{i}.weight'] = lin['w'].T.contiguous()
            sd[f'pts_linears.{i}.bias'] = lin['b']
        for ours, theirs in (('alpha_linear', 'alpha_linear'),
                             ('feature_linear', 'feature_linear'),
                             ('views_linear', 'views_linears.0'),
                             ('rgb_linear', 'rgb_linear')):
            sd[f'{theirs}.weight'] = p[ours]['w'].T.contiguous()
            sd[f'{theirs}.bias'] = p[ours]['b']
        sd['framecodes.codes.weight'] = p['framecodes']
        return sd
    torch.save({'network_fn_state_dict': net(params['coarse']),
                'network_fine_state_dict': net(params['fine']),
                'global_step': step,
                'poseopt_layer_state_dict': dict(pose_params)}, path)
    return path


@pytest.fixture(scope='module')
def cli(tmp_path_factory):
    """An anerf_tpu checkpoint of synthetic_tiny (its init, a pose bank
    moved off the data's poses), its args.txt, the synthetic HDF5 file
    and its store; the same state as the port's ``.pt``."""
    from anerf_tpu.data.h5_writer import make_synthetic_h5
    from anerf_tpu.data.loaders import get_dataset
    from anerf_tpu.models.factory import build_raycast_config
    from anerf_tpu.training.checkpoint import save_checkpoint as j_save
    from anerf_tpu.training.trainer import TrainSetup, init_train_state
    from anerf_tpu.utils.config import load_config, save_args_txt
    from anerf_torch.data.store import h5_to_store
    from anerf_torch.training.checkpoint import load_checkpoint
    from anerf_torch.training.checkpoint import save_checkpoint as t_save

    d = tmp_path_factory.mktemp('render_cli')
    h5 = make_synthetic_h5(str(d / 'synthetic.h5'), n_frames=6, H=24, W=24)
    store = h5_to_store(h5, str(d / 'synthetic.npstore'))
    cfg = load_config(TINY)
    cfg.basedir, cfg.datadir = str(d / 'logs'), h5
    attrs = get_dataset(cfg).get_meta()
    rc = build_raycast_config(cfg, skel=attrs['skel_type'],
                              n_framecodes=int(attrs['n_views']))
    setup = TrainSetup(cfg=cfg, rc=rc, skel=attrs['skel_type'],
                       rest_pose=jnp.asarray(attrs['rest_pose'],
                                             jnp.float32),
                       anchors=None, kp_map=None, rest_pose_idxs=None,
                       near=0., far=1.)
    state = init_train_state(setup, jax.random.PRNGKey(0),
                             init_kp3d=attrs['kp3d'],
                             init_bones=attrs['bones'])
    rng = np.random.RandomState(0)
    state['pose_params'] = {k: v + rng.normal(scale=0.05, size=v.shape)
                            .astype(np.float32)
                            for k, v in state['pose_params'].items()}
    logdir = os.path.join(cfg.basedir, cfg.expname)
    args_txt = save_args_txt(cfg, logdir)
    msgpack = j_save(logdir, state, 5)
    state = load_checkpoint(msgpack)
    pt = t_save(str(d / 'port'), state, 5)
    tar = _reference_tar(str(d / 'ref.tar'), state['params'],
                         state['pose_params'], 5)
    return {'dir': d, 'h5': h5, 'store': store, 'args': args_txt,
            'msgpack': msgpack, 'pt': pt, 'tar': tar}


def _argv(cli, which, ckpt, render_type, run, extra=()):
    return ['--nerf_args', cli['args'], '--ckptpath', cli[ckpt],
            '--dataset_path', cli['h5' if which == 'j' else 'store'],
            '--render_type', render_type, '--chunk', '512',
            '--outputdir', str(cli['dir'] / which), '--runname', run,
            *extra]


CLI_RUNS = {
    'bullet': ['--selected_idxs', '1', '--n_bullet', '3'],
    'val': ['--eval'],
    'selected': ['--render_refined', '--selected_idxs', '1', '4'],
    'interpolate': ['--mix_framecodes', '--selected_idxs', '0', '2',
                    '--n_step', '2'],
}


@pytest.mark.parametrize('render_type,ckpt',
                         [(rt, 'msgpack') for rt in sorted(CLI_RUNS)]
                         + [('selected', 'tar')])
def test_render_cli_matches_jax(cli, render_type, ckpt, monkeypatch):
    import run_render
    from anerf_tpu.utils import logging as j_logging
    from anerf_torch.run_render import main

    frames = {}
    j_save = j_logging.save_images

    def keep(outdir, rgbs, prefix=''):
        frames['j'] = np.asarray(rgbs)
        j_save(outdir, rgbs, prefix)

    monkeypatch.setattr(j_logging, 'save_images', keep)
    extra, run = CLI_RUNS[render_type], f'{render_type}_{ckpt}'
    run_render.main(_argv(cli, 'j', ckpt, render_type, run, extra))
    out = main(_argv(cli, 't', ckpt, render_type, run, extra), device='cpu')
    jdir, tdir = (cli['dir'] / w / run for w in 'jt')
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    ref, got = frames['j'], out['rgbs']
    assert got.shape == ref.shape and len(got) > 0
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-3 * scale
    assert out['accs'].max() > 0.5      # the frames hold the subject
    if render_type == 'val':
        def scores(d):
            rows = (d / 'score_final.txt').read_text().split('\n')
            return {k: float(v) for k, v in
                    (r.split(': ') for r in rows if r)}
        a, b = scores(jdir), scores(tdir)
        assert sorted(a) == sorted(b) and 'psnr' in a
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-3, (k, a[k], b[k])
        j_m = np.load(jdir / 'scores.npy', allow_pickle=True).item()
        t_m = np.load(tdir / 'scores.npy', allow_pickle=True).item()
        assert sorted(j_m) == sorted(t_m)


TYPE_ARGS = {
    'val': [], 'bullet': ['--n_bullet', '2'],
    'interpolate': ['--selected_idxs', '0', '1', '--n_step', '2'],
    'retarget': ['--selected_idxs', '0', '3'],
    'animate': ['--selected_idxs', '0', '1', '--n_step', '2'],
    'poserot': ['--n_bullet', '3'],
    'bubble': ['--n_step', '2'],
    'correction': ['--render_refined', '--n_step', '2'],
    'selected': ['--selected_idxs', '2'],
    'mesh': ['--mesh_res', '12', '--mesh_thres', '0.'],
}


@pytest.mark.parametrize('ckpt', ['msgpack', 'pt', 'tar'])
@pytest.mark.parametrize('render_type', sorted(TYPE_ARGS))
def test_render_cli_every_type(cli, render_type, ckpt):
    """Every render type from an anerf_tpu msgpack, the port's own
    checkpoint and a reference ``.tar``: its files, finite frames of the
    expected count."""
    from anerf_torch.run_render import main
    run = f'{render_type}_{ckpt}'
    out = main(_argv(cli, 't', ckpt, render_type, run,
                     TYPE_ARGS[render_type]), device='cpu')
    files = sorted(os.listdir(out['outdir']))
    if render_type == 'mesh':
        (m,) = out['meshes']
        assert len(m['verts']) > 0 and len(m['faces']) > 0
        assert files[0] == 'mesh_00000.ply' and len(files) == 21
        return
    n = len(out['rgbs'])
    expect = {'val': 4, 'bullet': 2, 'interpolate': 3, 'retarget': 2,
              'animate': 3, 'poserot': 3, 'bubble': 2, 'correction': 2,
              'selected': 1}[render_type]
    assert n == expect and np.isfinite(out['rgbs']).all()
    assert [f'{i:04d}.png' for i in range(n)] == files[:n]
    assert f'{render_type}_0000.png' in files or f'{render_type}.mp4' in files


def test_render_cli_needs_a_gpu_and_one_device(cli, monkeypatch):
    """``--mesh_devices 2`` in a world of one raises, naming torchrun
    (``tests/test_torch_parallel_cli.py`` renders over two ranks), and
    without CUDA the default device raises; neither writes a file."""
    from anerf_torch.run_render import main
    argv = _argv(cli, 't', 'pt', 'bullet', 'refused')
    with pytest.raises(ValueError, match='torchrun'):
        main(argv + ['--mesh_devices', '2'], device='cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        main(argv)
    assert not os.path.exists(cli['dir'] / 't' / 'refused')
