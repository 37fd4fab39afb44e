"""The port's ``make_multi_train_step`` and ``stack_batches`` on the CPU.

(a) Against anerf_tpu's ``make_multi_train_step`` (tests/test_trainer.py
    ::test_multi_train_step_matches_sequential): two bundles of 3 steps
    from a JAX state carried over by ``interop``, the port's plain
    backend against JAX's XLA path at R=8 on a narrow net, no draws,
    pose every 2nd step, the target shifted by 0.01 a step.  Bars: those
    of ``test_torch_train.py``'s trajectories (losses within 1e-5
    relative; moments cosine > 1 - 1e-6, norm within 1e-4; 99.9% of the
    parameters within 2e-6 and all within 2 lr; the pose bank and
    accumulator within 1e-6; Adam counts exact).
(b) Against the port's own eager step: the same state, batches and
    generator (draws on) stepped one at a time and in bundles must give
    the same bits in every state tensor, counter and last-step stat, in
    the default, joint and alternating (reset snapshot, trackers) modes,
    over steps that cross the warmup/stop window, pose fires, NeRF-turn
    skips and snapshots, with tau changing every step.
(c) ``run_train.train`` with ``steps_per_dispatch=2`` on a synthetic
    store (tests/test_e2e.py::test_train_cli_steps_per_dispatch).
"""
import dataclasses
import json
import os

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
CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'synthetic_tiny.txt')


def _pose_scene(seed_batches):
    rest, bones, _, kps, skts, cyls = T.synthetic_pose(N_FRAMES)
    return rest, kps, bones, [T.synthetic_batch(R, N_FRAMES, kps, skts, bones,
                                                cyls, seed=s)
                              for s in seed_batches]


def _t_setup(cfg, rest, kps, bones):
    return TT.TrainSetup(cfg=cfg, rc=t_build(cfg, n_framecodes=N_FRAMES),
                         skel=SMPLSkeleton, rest_pose=rest,
                         anchors=P.make_anchors(kps, bones), near=0.0,
                         far=1.0, device='cpu')


# ---- (a) against anerf_tpu -----------------------------------------------

def test_multi_step_matches_jax():
    k = 3
    kw = dict(N_rand=R, perturb=0., raw_noise_std=0., opt_pose=True,
              opt_pose_step=2, opt_pose_coef=0.1, opt_pose_lrate=5e-3,
              netwidth=64, netdepth=3)
    cfg_j = T.surreal_config(mlp_backend='xla', **kw)
    cfg_t = T.surreal_config(mlp_backend='plain', **kw)
    rest, kps, bones, (batch,) = _pose_scene([0])
    batches = [dict(batch, target_s=batch['target_s'] + 0.01 * s)
               for s in range(2 * k)]
    j_rc = dataclasses.replace(j_build(cfg_j, n_framecodes=N_FRAMES),
                               viewfac=False)
    j_setup = JT.TrainSetup(cfg=cfg_j, rc=j_rc, skel=JSMPL,
                            rest_pose=jnp.asarray(rest),
                            anchors=JP.make_anchors(kps, bones),
                            near=0.0, far=1.0)
    js = JT.init_train_state(j_setup, jax.random.PRNGKey(0),
                             init_kp3d=kps, init_bones=bones)
    ts = train_state_from_jax(js, device='cpu')
    j_multi = jax.jit(JT.make_multi_train_step(j_setup, k))
    t_multi = TT.make_multi_train_step(_t_setup(cfg_t, rest, kps, bones), k)
    for b in range(2):
        bundle = batches[b * k:(b + 1) * k]
        js, j_stats = j_multi(js, JT.stack_batches(bundle),
                              jax.random.PRNGKey(7))
        ts, t_stats = t_multi(ts, TT.stack_batches(bundle), None)
        for key in ('total_loss', 'rgb_loss', 'rgb_loss0', 'kp_loss'):
            a, c = float(j_stats[key]), float(t_stats[key])
            assert abs(a - c) <= 1e-5 * abs(a) + 1e-9, (b, key, a, c)
    assert ts['step'] == int(js['step']) == 2 * k
    assert ts['pose_opt_state']['count'] == 3
    _compare_states(js, ts, pose_atol=1e-6, mom_cos=1e-6, mom_ratio=1e-4)


def test_stack_batches_matches_jax():
    _, _, _, batches = _pose_scene([0, 1, 2])
    a, b = JT.stack_batches(batches), TT.stack_batches(batches)
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key])


# ---- (b) against the eager port step, bit for bit --------------------------

# tau changes every step (cutoff_step 1e-3: a factor cutoff_rate a step)
BASE = dict(N_rand=R, netwidth=32, netdepth=3, mlp_backend='plain',
            opt_pose=True, opt_pose_step=2, opt_pose_coef=0.1,
            opt_pose_lrate=5e-3, cutoff_step=1e-3)
MODES = {
    # pose accumulates inside warmup 3 <= s < 8, fires at s = 3, 5, 7
    'default': dict(opt_pose_warmup=3, opt_pose_stop=8),
    # the joint gate's window 2 <= s + 1 <= 9
    'joint': dict(opt_pose_joint=True, opt_pose_warmup=2, opt_pose_stop=9,
                  freq_schedule=True),
    # turns flip every 3 iterations: NeRF skips and pose fires, the
    # reset snapshot at each pose-turn start, the CMA trackers
    'alternating': dict(opt_pose_flipflop=True, opt_pose_interval=3,
                        opt_pose_reset=True),
}


def _leaves(x):
    if isinstance(x, dict):
        return [(f'{k}.{n}', v) for k in sorted(x) for n, v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [(f'{i}.{n}', v) for i, e in enumerate(x) for n, v in _leaves(e)]
    return [('', x)]


def _same(a, b):
    return (torch.equal(a, b) if torch.is_tensor(a)
            else type(a) is type(b) and a == b)


@pytest.mark.parametrize('mode', sorted(MODES))
def test_multi_step_bit_equal_to_eager(mode):
    """1 eager step, 3 bundles of 4, 1 eager step against 14 eager steps
    (draws on, the same generator seed): every state entry, both Adam
    counts and the stats of each bundle's last step bit-equal."""
    k, n = 4, 14
    cfg = T.surreal_config(**BASE, **MODES[mode])
    rest, kps, bones, batches = _pose_scene(range(n))
    setup = _t_setup(cfg, rest, kps, bones)
    states, stats = [], []
    for bundled in (False, True):
        state = TT.init_train_state(setup, torch.Generator().manual_seed(0),
                                    init_kp3d=kps, init_bones=bones)
        gen = torch.Generator().manual_seed(3)
        step = TT.make_train_step(setup)
        multi = TT.make_multi_train_step(setup, k)
        seen = {}
        i = 0
        while i < n:
            if bundled and 1 <= i < 1 + 3 * k:
                state, st = multi(state, TT.stack_batches(batches[i:i + k]),
                                  gen)
                i += k
            else:
                state, st = step(state, T.to_device(batches[i], 'cpu'), gen)
                i += 1
            seen[i] = st
        states.append(state)
        stats.append(seen)
    eager, bundled = states
    assert bundled['step'] == eager['step'] == n
    for (name, a), (_, b) in zip(_leaves(eager), _leaves(bundled)):
        assert _same(a, b), name
    assert len(_leaves(eager)) == len(_leaves(bundled))
    for i, st in stats[1].items():
        assert st.keys() == stats[0][i].keys()
        for key in st:
            assert torch.equal(torch.as_tensor(st[key]),
                               torch.as_tensor(stats[0][i][key])), (i, key)
    # the range crossed what it should: pose fires at s = 3, 5, 7
    # (default, joint), at t = s + 1 = 2, 8, 14 with the NeRF on at
    # t = 4-6 and 10-12 only (alternating)
    counts = eager['opt_state']['count'], eager['pose_opt_state']['count']
    assert counts == {'default': (14, 3), 'joint': (14, 3),
                      'alternating': (6, 3)}[mode]


def test_multi_step_refuses_bad_bundles():
    cfg = T.surreal_config(**BASE)
    rest, kps, bones, batches = _pose_scene(range(2))
    setup = _t_setup(cfg, rest, kps, bones)
    with pytest.raises(ValueError, match='steps_per_dispatch'):
        TT.make_multi_train_step(setup, 0)
    state = TT.init_train_state(setup, torch.Generator().manual_seed(0),
                                init_kp3d=kps, init_bones=bones)
    with pytest.raises(ValueError, match='stacks 2 steps'):
        TT.make_multi_train_step(setup, 3)(state,
                                           TT.stack_batches(batches), None)
    assert state['step'] == 0


# ---- (c) the entry point ---------------------------------------------------

def test_train_cli_steps_per_dispatch(tmp_path):
    """``--steps_per_dispatch 2`` reaches the step count in bundles, logs
    finite losses and writes the checkpoint at its cadence."""
    from anerf_torch.data.writer import make_synthetic_store
    from anerf_torch.run_train import train
    from anerf_torch.utils.config import load_config
    store = make_synthetic_store(str(tmp_path / 'synthetic.npstore'),
                                 n_frames=6, H=24, W=24)
    cfg = load_config(CONFIG, expname='synthetic_tiny_spd',
                      basedir=str(tmp_path / 'logs'), datadir=store,
                      n_iters=6, i_print=2, i_weights=6, num_workers=1,
                      steps_per_dispatch=2)
    seen = []
    state = train(cfg, device='cpu',
                  on_step=lambda i, st, stats: seen.append(i))
    assert seen == [0, 2, 4, 6] and state['step'] == 6
    logdir = os.path.join(cfg.basedir, cfg.expname)
    with open(os.path.join(logdir, 'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    losses = [r['total_loss'] for r in recs if 'total_loss' in r]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert 'ckpt_00000006.pt' in os.listdir(logdir)
