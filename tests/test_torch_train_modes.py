"""The port's three pose modes against anerf_tpu's ``make_train_step``.

Joint mode (``opt_pose_joint``), the alternating mode
(``opt_pose_flipflop`` with ``opt_pose_reset``) and ``testopt``: from a
JAX state carried over by ``interop``, both packages step the same
batch on the CPU (the port's plain backend against JAX's XLA path,
``mlp_backend='xla'``) at R=8 rays on a narrow net, with the pose
optimizer on every 2nd step and the turn flipping every 3, over enough
steps to cross two pose fires (and, in the alternating mode, a turn
flip each way).  Bars: those of ``test_torch_train.py`` (losses,
parameters, moments, pose bank and accumulator), the NeRF and pose
Adam counts exact, the trackers within 1e-6 relative and the snapshot
within 1e-6.  Each step also checks the gates against the JAX stats.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_train import _compare_states

from anerf_tpu.models.factory import build_raycast_config as j_build
from anerf_tpu.skeleton import SMPLSkeleton as JSMPL
from anerf_tpu.training import pose_opt as JP
from anerf_tpu.training import trainer as JT

from anerf_torch import testing_utils as T
from anerf_torch.interop import train_state_from_jax
from anerf_torch.models.factory import build_raycast_config as t_build
from anerf_torch.skeleton import SMPLSkeleton
from anerf_torch.training import pose_opt as P
from anerf_torch.training import trainer as TT

from test_torch_threads import one_torch_thread  # noqa: F401

R, N_FRAMES = 8, 4

MODES = {
    # pose fires after steps 1 and 3
    'joint': (dict(opt_pose_joint=True), 4),
    # steps s read t = s + 1: pose turn t <= 2, NeRF turn t = 3-5 (the
    # NeRF Adam skips t = 1, 2, 3 and 7, 8, 9), pose turn again from
    # t = 6; pose fires at t = 2 and 8; snapshots at t = 6 and 0
    'alternating': (dict(opt_pose_flipflop=True, opt_pose_interval=3,
                         opt_pose_reset=True), 9),
    # the NeRF frozen, its Adam count still advancing; pose at 1 and 3
    'testopt': (dict(testopt=True), 4),
}


def _setups(mode):
    over, _ = MODES[mode]
    cfg_kw = dict(N_rand=R, perturb=0., raw_noise_std=0., opt_pose=True,
                  opt_pose_step=2, opt_pose_coef=0.1, opt_pose_lrate=5e-3,
                  netwidth=64, netdepth=3, **over)
    cfg_j = T.surreal_config(mlp_backend='xla', **cfg_kw)
    cfg_t = T.surreal_config(mlp_backend='plain', **cfg_kw)
    rest, bones, _, kps, skts, cyls = T.synthetic_pose(N_FRAMES)
    batch = T.synthetic_batch(R, N_FRAMES, kps, skts, bones, cyls)
    j_rc = dataclasses.replace(j_build(cfg_j, n_framecodes=N_FRAMES),
                               viewfac=False)
    j_setup = JT.TrainSetup(cfg=cfg_j, rc=j_rc, skel=JSMPL,
                            rest_pose=jnp.asarray(rest),
                            anchors=JP.make_anchors(kps, bones),
                            near=0.0, far=1.0)
    j_state = JT.init_train_state(j_setup, jax.random.PRNGKey(0),
                                  init_kp3d=kps, init_bones=bones)
    t_setup = TT.TrainSetup(cfg=cfg_t, rc=t_build(cfg_t,
                                                  n_framecodes=N_FRAMES),
                            skel=SMPLSkeleton, rest_pose=rest,
                            anchors=P.make_anchors(kps, bones), near=0.0,
                            far=1.0, device='cpu')
    return (j_setup, j_state, {k: jnp.asarray(v) for k, v in batch.items()},
            t_setup, T.to_device(batch, 'cpu'))


def _leaves(tree):
    return [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize('mode', sorted(MODES))
def test_mode_trajectory_matches_jax(mode):
    cfg_over, n_steps = MODES[mode]
    j_setup, js, jb, t_setup, tb = _setups(mode)
    j_step = jax.jit(JT.make_train_step(j_setup))
    t_step = TT.make_train_step(t_setup)
    ts = train_state_from_jax(js)
    flip = cfg_over.get('opt_pose_flipflop', False)
    assert ('kp_tracker' in ts) == flip
    assert ('pose_snapshot' in ts) == flip
    params0 = [t.clone() for t in TT.tree_leaves(ts['params'])]
    nerf_fires = pose_fires = 0
    for s in range(n_steps):
        gates = TT.step_gates(t_setup.cfg, s)
        bank_before = {k: v.clone() for k, v in ts['pose_params'].items()}
        nerf_before = [t.clone() for t in TT.tree_leaves(ts['params'])]
        js, j_stats = j_step(js, jb, jax.random.PRNGKey(7))
        ts, t_stats = t_step(ts, tb, torch.Generator())
        for k in ('total_loss', 'rgb_loss', 'rgb_loss0', 'kp_loss'):
            a, b = float(j_stats[k]), float(t_stats[k])
            assert abs(a - b) <= 1e-5 * abs(a) + 1e-9, (s, k, a, b)
        if flip:
            assert t_stats['nerf_gate'] == float(j_stats['nerf_gate']), s
            assert t_stats['pose_gate'] == float(j_stats['pose_gate']), s
            a, b = float(j_stats['kp_tracker_mean']), \
                float(t_stats['kp_tracker_mean'])
            assert abs(a - b) <= 1e-6 * abs(a), (s, a, b)
        nerf_fires += gates.nerf
        pose_fires += gates.pose
        # the host gates say what moved
        moved = any(not torch.equal(a, b) for a, b in
                    zip(nerf_before, TT.tree_leaves(ts['params'])))
        assert moved == (gates.nerf and mode != 'testopt'), s
        assert gates.pose == any(not torch.equal(bank_before[k],
                                                 ts['pose_params'][k])
                                 for k in bank_before), s
        if flip and s + 1 in (6,):
            # a pose turn starts: the snapshot is the pre-update bank
            for k in bank_before:
                assert torch.equal(ts['pose_snapshot'][k], bank_before[k])
        _compare_states(js, ts, pose_atol=1e-6, mom_cos=1e-6,
                        mom_ratio=1e-4)
    assert pose_fires == 2
    assert ts['opt_state']['count'] == nerf_fires == int(js['opt_state'][0].count)
    assert ts['pose_opt_state']['count'] == int(js['pose_opt_state'][0].count)
    if mode == 'alternating':
        assert nerf_fires == 3 and ts['opt_state']['count'] == 3
    else:
        assert nerf_fires == n_steps
    if mode == 'testopt':
        assert all(torch.equal(a, b) for a, b in
                   zip(params0, TT.tree_leaves(ts['params'])))
    if flip:
        for k in ('kp_loss_tracker', 'kp_loss_cnt'):
            np.testing.assert_allclose(
                ts['kp_tracker'][k].numpy(),
                np.asarray(js['kp_tracker'][k]), rtol=1e-6, atol=0)
        for a, b in zip(_leaves(js['pose_snapshot']),
                        [t.double().numpy() for t in
                         TT.tree_leaves(ts['pose_snapshot'])]):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_pose_step_window_off_by_one():
    """Joint mode's gate reads the window at s + 1 (warmup <= s+1 <=
    stop) while the accumulation reads it at s (warmup <= s < stop):
    the host gates of both packages agree around warmup and stop."""
    from anerf_tpu.training import flipflop as JF
    cfg = T.surreal_config(opt_pose=True, opt_pose_joint=True,
                           opt_pose_step=2, opt_pose_warmup=3,
                           opt_pose_stop=9)
    ff = JF.FlipFlopConfig(opt_pose_step=2, opt_pose_joint=True,
                           opt_pose_warmup=3, opt_pose_stop=9)
    fires = []
    for s in range(14):
        g = TT.step_gates(cfg, s)
        use_pose = 3 <= s < 9
        _, pose_g = JF.update_gates(ff, s + 1)
        assert g.pose == (bool(pose_g > 0) and use_pose), s
        assert g.accum == use_pose and g.nerf
        fires += [s] if g.pose else []
    assert fires == [3, 5, 7]
