"""The port's train step against anerf_tpu's ``make_train_step`` on the
CPU, and its Adam against optax.

A JAX train state crosses to the port through ``interop`` (fresh, and
taken mid-run with non-zero moments and a part-filled pose
accumulator); both packages then step the same batch.  The config is
deterministic (perturb 0, no density noise) at R=8 rays and full width,
with the pose optimizer firing every 2 steps, so a 4-step trajectory
crosses two fires.

Tolerances.  The plain backend against JAX's XLA path runs the f32
chain on both sides, so losses agree to f32 summation order (1e-5
relative; measured 6e-7) and the moments in direction (cosine
> 1 - 1e-6; measured 1 - 6e-9) and norm (1e-4; measured 2.6e-5).
Adam divides each gradient by its own running magnitude, so where a
gradient sits at f32 noise level its update can take either sign: a
parameter may then differ by up to 2 lr a step (lr 5e-4).  So 99.9% of
the parameters must agree within 2e-6 (measured 8.1e-7) and every one
within 2 lr (measured 4.6e-5); the pose bank within 1e-6 (measured
3.1e-7).  The fused backend against the Pallas kernels is held in
``test_torch_train_fused.py``.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from anerf_tpu.models.factory import build_raycast_config as j_build
from anerf_tpu.skeleton import SMPLSkeleton as JSMPL
from anerf_tpu.training import pose_opt as JP
from anerf_tpu.training import trainer as JT
from anerf_tpu.training.losses import nerf_lr_schedule as j_nerf_sched
from anerf_tpu.training.losses import pose_lr_schedule as j_pose_sched

from anerf_torch import testing_utils as T
from anerf_torch.interop import params_to_numpy, train_state_from_jax
from anerf_torch.models.factory import build_raycast_config as t_build
from anerf_torch.skeleton import SMPLSkeleton
from anerf_torch.training import losses as L
from anerf_torch.training import pose_opt as P
from anerf_torch.training import trainer as TT

R, N_FRAMES = 8, 4


def _cfg(backend, compute_dtype):
    return T.surreal_config(N_rand=R, perturb=0., raw_noise_std=0.,
                            opt_pose=True, opt_pose_step=2,
                            opt_pose_coef=0.1, opt_pose_lrate=5e-3,
                            mlp_backend=backend,
                            compute_dtype=compute_dtype)


def _setups(backend_j, backend_t, compute_dtype):
    cfg_j = _cfg(backend_j, compute_dtype)
    cfg_t = _cfg(backend_t, compute_dtype)
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


def _flat(tree):
    return [np.asarray(x, np.float64).ravel()
            for x in jax.tree_util.tree_leaves(tree)]


def train_state_to_numpy(state):
    """The port's train state with every tensor as float32 numpy."""
    adam = lambda s: None if s is None else {
        'count': s['count'], 'mu': params_to_numpy(s['mu']),
        'nu': params_to_numpy(s['nu'])}
    return {'params': params_to_numpy(state['params']),
            'opt_state': adam(state['opt_state']),
            'pose_params': params_to_numpy(state['pose_params']),
            'pose_opt_state': adam(state['pose_opt_state']),
            'pose_accum': params_to_numpy(state['pose_accum']),
            'step': state['step']}


def _jax_numpy_state(js):
    adam = lambda s: None if s is None else {
        'count': int(s[0].count), 'mu': s[0].mu, 'nu': s[0].nu}
    return {'params': js['params'], 'opt_state': adam(js['opt_state']),
            'pose_params': js['pose_params'],
            'pose_opt_state': adam(js['pose_opt_state']),
            'pose_accum': js['pose_accum'], 'step': int(js['step'])}


def _cos(a, b):
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na < 1e-20 and nb < 1e-20:
        return 1.0
    return a @ b / (na * nb + 1e-300)


LR = 5e-4


def _compare_states(js, ts, pose_atol, mom_cos, mom_ratio, upd_from=None,
                    upd_cos=None):
    """Parameters: 99.9% within 2e-6 and all within 2 lr; or, given the
    states before the step (``upd_from``), the direction of their
    update (``upd_cos``)."""
    js, ts = _jax_numpy_state(js), train_state_to_numpy(ts)
    assert js['step'] == ts['step']
    for k in ('opt_state', 'pose_opt_state'):
        assert js[k]['count'] == ts[k]['count'], k
        for m in ('mu', 'nu'):
            for a, b in zip(_flat(js[k][m]), _flat(ts[k][m])):
                assert _cos(a, b) > 1 - mom_cos, (k, m, _cos(a, b))
                if np.linalg.norm(a) > 1e-20:
                    assert abs(np.linalg.norm(b) / np.linalg.norm(a) - 1) \
                        < mom_ratio, (k, m)
    if upd_from is None:
        d = np.concatenate([np.abs(a - b) for a, b in
                            zip(_flat(js['params']), _flat(ts['params']))])
        assert np.quantile(d, 0.999) < 2e-6 and d.max() < 2 * LR, \
            (np.quantile(d, 0.999), d.max())
    else:
        j0, t0 = _flat(upd_from[0]['params']), _flat(upd_from[1]['params'])
        for a0, a, b0, b in zip(j0, _flat(js['params']), t0,
                                _flat(ts['params'])):
            assert _cos(a - a0, b - b0) > 1 - upd_cos
    for k in ('pose_params', 'pose_accum'):
        for a, b in zip(_flat(js[k]), _flat(ts[k])):
            np.testing.assert_allclose(b, a, rtol=0, atol=pose_atol)


def _run(j_step, js, jb, t_step, ts, tb, n, loss_rtol):
    for _ in range(n):
        js, j_stats = j_step(js, jb, jax.random.PRNGKey(7))
        ts, t_stats = t_step(ts, tb, torch.Generator())
        for k in ('total_loss', 'rgb_loss', 'rgb_loss0', 'kp_loss'):
            a, b = float(j_stats[k]), float(t_stats[k])
            assert abs(a - b) <= loss_rtol * abs(a) + 1e-9, (k, a, b)
    return js, ts


@pytest.fixture(scope='module')
def plain_pair():
    j_setup, j_state, jb, t_setup, tb = _setups('xla', 'plain', 'float32')
    return (j_setup, j_state, jb, t_setup, tb,
            jax.jit(JT.make_train_step(j_setup)),
            TT.make_train_step(t_setup))


def test_trajectory_plain_matches_xla_from_fresh(plain_pair):
    """4 steps from a fresh state, across the pose fires at steps 2 and
    4: losses, parameters, pose bank, accumulator and Adam moments."""
    _, j_state, jb, _, tb, j_step, t_step = plain_pair
    ts = train_state_from_jax(j_state)
    js, ts = _run(j_step, j_state, jb, t_step, ts, tb, 4, loss_rtol=1e-5)
    _compare_states(js, ts, pose_atol=1e-6, mom_cos=1e-6, mom_ratio=1e-4)
    # the pose bank moved at both fires
    assert ts['pose_opt_state']['count'] == 2


def test_trajectory_plain_matches_xla_from_mid_run(plain_pair):
    """A JAX state taken after 3 steps (moments non-zero, one pose
    gradient accumulated) continues identically in the port."""
    _, j_state, jb, _, tb, j_step, t_step = plain_pair
    js = j_state
    for _ in range(3):
        js, _ = j_step(js, jb, jax.random.PRNGKey(7))
    assert np.abs(np.asarray(js['pose_accum']['bones'])).max() > 0
    ts = train_state_from_jax(js)
    js, ts = _run(j_step, js, jb, t_step, ts, tb, 2, loss_rtol=1e-5)
    _compare_states(js, ts, pose_atol=1e-6, mom_cos=1e-6, mom_ratio=1e-4)


# ---- Adam and the schedules against optax --------------------------------

def test_adam_matches_optax_with_gated_fires():
    """The port's Adam against optax's chain over 6 updates with the
    NeRF schedule, and a gated copy that fires only on 3 of 6 steps
    (the pose optimizer): counts, moments and parameters."""
    rng = np.random.RandomState(0)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 10 ** rng.uniform(-6, 1)
              for s in shapes] for _ in range(6)]
    for sched_j, sched_t, fires in (
            (j_nerf_sched(5e-4, 2, 0.1, 2), L.nerf_lr_schedule(5e-4, 2, 0.1, 2),
             [True] * 6),
            (j_pose_sched(5e-3, 2, 0.5, 1, 2), L.pose_lr_schedule(5e-3, 2, 0.5,
                                                                   1, 2),
             [False, True, False, True, True, False])):
        tx = JT.make_optimizer(sched_j)
        jp = [jnp.asarray(x) for x in p0]
        jst = tx.init(jp)
        tp = [torch.tensor(x) for x in p0]
        tst = TT.adam_init(tp)
        for g, fire in zip(grads, fires):
            if not fire:
                continue
            upd, jst = tx.update([jnp.asarray(x) for x in g], jst, jp)
            jp = optax.apply_updates(jp, upd)
            TT.adam_update(tp, [torch.tensor(x) for x in g], tst, sched_t)
        assert tst['count'] == int(jst[0].count) == sum(fires)
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-7)
        for m in ('mu', 'nu'):
            for a, b in zip(getattr(jst[0], m), tst[m]):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=1e-6, atol=0)


@pytest.mark.parametrize('step', [0, 1, 999, 1000, 1999, 2000, 123456])
def test_schedules_match_jax(step):
    a = float(j_nerf_sched(5e-4, 250, 0.1, 1000)(step))
    assert L.nerf_lr_schedule(5e-4, 250, 0.1, 1000)(step) == a
    b = float(j_pose_sched(5e-4, 250, 0.3, 400, 20)(step))
    assert L.pose_lr_schedule(5e-4, 250, 0.3, 400, 20)(step) == b
