"""The port's checkpoints against anerf_tpu's.

A save/load round trip is exact; pruning and ``latest_checkpoint``
keep the same steps as anerf_tpu; ``restore_train_state`` takes the same
parts from the checkpoint and from the live state under ``finetune``
and ``no_poseopt_reload``; ``import_jax_checkpoint`` of an anerf_tpu
msgpack file equals ``train_state_from_jax`` of the state it holds;
and a reference-format ``.tar`` loads to the same trees in both.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anerf_tpu.models.factory import build_raycast_config as j_build
from anerf_tpu.skeleton import SMPLSkeleton as JSMPL
from anerf_tpu.training import checkpoint as JC
from anerf_tpu.training import pose_opt as JP
from anerf_tpu.training import trainer as JT

from anerf_torch import testing_utils as T
from anerf_torch.interop import tree_map, train_state_from_jax
from anerf_torch.training import checkpoint as TC

from test_torch_threads import one_torch_thread  # noqa: F401

N_FRAMES = 4


def _jax_state(seed, step):
    """A narrow flipflop/reset train state whose every leaf (moments,
    accumulator, trackers, snapshot) holds seed-dependent values."""
    cfg = T.surreal_config(N_rand=8, opt_pose=True, opt_pose_flipflop=True,
                           opt_pose_reset=True, netwidth=32, netdepth=2)
    rest, bones, _, kps, skts, cyls = T.synthetic_pose(N_FRAMES)
    setup = JT.TrainSetup(cfg=cfg, rc=j_build(cfg, n_framecodes=N_FRAMES),
                          skel=JSMPL, rest_pose=jnp.asarray(rest),
                          anchors=JP.make_anchors(kps, bones))
    state = JT.init_train_state(setup, jax.random.PRNGKey(0), kps, bones)
    rng = np.random.RandomState(seed)
    noisy = lambda x: x + jnp.asarray(rng.normal(size=x.shape), x.dtype) \
        if jnp.issubdtype(x.dtype, jnp.floating) else x + seed
    state = jax.tree_util.tree_map(noisy, state)
    state['step'] = jnp.asarray(step, jnp.int32)
    return setup, state


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    elif a is None:
        assert b is None
    elif torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype
        assert torch.equal(a, b)
    else:
        assert a == b and type(a) is type(b)


def test_save_load_round_trip(tmp_path):
    setup, js = _jax_state(1, 5)
    ts = train_state_from_jax(js)
    anchors = {k: torch.as_tensor(np.asarray(v))
               for k, v in setup.anchors.items()}
    path = TC.save_checkpoint(str(tmp_path), ts, 5, anchors=anchors)
    assert os.path.basename(path) == 'ckpt_00000005.pt'
    loaded = TC.load_checkpoint(path)
    _assert_trees_equal(loaded.pop('anchors'), anchors)
    _assert_trees_equal(loaded, ts)
    fresh = train_state_from_jax(_jax_state(2, 0)[1])
    restored, step = TC.restore_train_state(fresh, TC.load_checkpoint(path))
    assert step == 5
    _assert_trees_equal(restored, ts)
    pose = torch.load(TC.save_pose_checkpoint(str(tmp_path), ts, 5, anchors),
                      weights_only=False)
    assert pose['step'] == 5
    _assert_trees_equal(pose['pose_params'], ts['pose_params'])
    assert TC.load_pose_payload(path)['pose_params'].keys() == \
        ts['pose_params'].keys()


def test_pruning_and_latest_match_jax(tmp_path):
    setup, js = _jax_state(1, 0)
    ts = train_state_from_jax(js)
    jdir, tdir = tmp_path / 'j', tmp_path / 't'
    for step in (3, 10, 20, 7, 100):
        JC.save_checkpoint(str(jdir), js, step)
        TC.save_checkpoint(str(tdir), ts, step)
        kept_j = sorted(f.split('.')[0] for f in os.listdir(jdir))
        kept_t = sorted(f.split('.')[0] for f in os.listdir(tdir))
        assert kept_j == kept_t
        assert os.path.basename(JC.latest_checkpoint(str(jdir))).split('.')[0] \
            == os.path.basename(TC.latest_checkpoint(str(tdir))).split('.')[0]
    assert TC.latest_checkpoint(str(tmp_path / 'none')) is None


@pytest.mark.parametrize('finetune', [False, True])
@pytest.mark.parametrize('no_poseopt_reload', [False, True])
def test_restore_choices_match_jax(tmp_path, finetune, no_poseopt_reload):
    """Restore a checkpoint of one state into another: every part must
    come from where anerf_tpu takes it."""
    _, live = _jax_state(1, 2)
    _, saved = _jax_state(2, 9)
    path = JC.save_checkpoint(str(tmp_path), saved, 9)
    j_res, j_step = JC.restore_train_state(
        live, JC.load_checkpoint(path), finetune=finetune,
        no_poseopt_reload=no_poseopt_reload)
    t_ckpt = TC.save_checkpoint(str(tmp_path / 't'),
                                train_state_from_jax(saved), 9)
    t_res, t_step = TC.restore_train_state(
        train_state_from_jax(live), TC.load_checkpoint(t_ckpt),
        finetune=finetune, no_poseopt_reload=no_poseopt_reload)
    assert t_step == j_step
    _assert_trees_equal(t_res, train_state_from_jax(j_res))


def test_import_jax_checkpoint(tmp_path):
    setup, js = _jax_state(3, 11)
    path = JC.save_checkpoint(str(tmp_path), js, 11, anchors=setup.anchors)
    imported = TC.import_jax_checkpoint(path)
    _assert_trees_equal(imported.pop('anchors'),
                        {k: torch.as_tensor(np.asarray(v))
                         for k, v in setup.anchors.items()})
    _assert_trees_equal(imported, train_state_from_jax(js))
    # load_checkpoint takes the msgpack files as well
    assert TC.load_checkpoint(path)['step'] == 11
    pose = TC.import_jax_checkpoint(
        JC.save_pose_checkpoint(str(tmp_path), js, 11, setup.anchors))
    assert pose['step'] == 11
    _assert_trees_equal(pose['pose_params'],
                        train_state_from_jax(js)['pose_params'])


def _reference_tar(path):
    """A checkpoint in the reference's torch layout (nn.Linear weights
    (out, in), ``views_linears.0``, the pose layer and anchors)."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)

    def net():
        sd = {}
        for i, (fi, fo) in enumerate(((40, 16), (16, 16))):
            sd[f'pts_linears.{i}.weight'] = r(fo, fi)
            sd[f'pts_linears.{i}.bias'] = r(fo)
        for name, (fi, fo) in (('alpha_linear', (16, 1)),
                               ('feature_linear', (16, 16)),
                               ('views_linears.0', (30, 8)),
                               ('rgb_linear', (8, 3))):
            sd[f'{name}.weight'] = r(fo, fi)
            sd[f'{name}.bias'] = r(fo)
        sd['framecodes.codes.weight'] = r(5, 16)
        return sd
    torch.save({'network_fn_state_dict': net(),
                'network_fine_state_dict': net(),
                'embed_state_dict': {'cutoff_dist': r(24)},
                'global_step': 1234,
                'poseopt_layer_state_dict': {'pelvis': r(5, 3),
                                             'bones': r(5, 24, 3),
                                             'rest_pose': r(24, 3)},
                'poseopt_anchors': {'kps': r(5, 24, 3), 'bones': r(5, 24, 3),
                                    'unused': None}}, path)
    return path


def test_reference_tar_matches_jax(tmp_path):
    path = _reference_tar(str(tmp_path / 'ref.tar'))
    a, b = JC.load_torch_checkpoint(path), TC.load_torch_checkpoint(path)
    as_t = lambda tree: tree_map(lambda x: torch.as_tensor(np.asarray(x)) if
                                 not isinstance(x, int) else x, tree)
    _assert_trees_equal(as_t(b), as_t(a))


@pytest.mark.parametrize('legacy', [False, True])
@pytest.mark.parametrize('rot6d', [False, True])
def test_refined_pose_data_matches_jax(tmp_path, legacy, rot6d):
    """``load_refined_pose_data`` (the ``load_refined`` datasets' poses)
    of an anerf_tpu pose checkpoint: the same kp3d, bones, skts and
    cylinders, with and without the legacy coordinate flip and for an
    axis-angle or a rot6d bank."""
    from anerf_tpu.ops.rotations import axisang_to_rot, rot_to_rot6d
    setup, js = _jax_state(4, 6)
    bones = 0.3 * np.random.RandomState(4).normal(size=(N_FRAMES, 24, 3))
    js['pose_params'] = {'pelvis': js['pose_params']['pelvis'],
                         'bones': jnp.asarray(bones, jnp.float32)}
    if rot6d:
        js['pose_params']['bones'] = rot_to_rot6d(axisang_to_rot(
            js['pose_params']['bones']))
    path = JC.save_pose_checkpoint(str(tmp_path), js, 6, setup.anchors)
    a = JC.load_refined_pose_data(path, legacy=legacy)
    b = TC.load_refined_pose_data(path, legacy=legacy)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, np.asarray(x), rtol=0, atol=2e-5)
