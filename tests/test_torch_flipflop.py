"""The port's FlipFlop scheduler against anerf_tpu's.

The gates are plain Python on the host in the port and jnp arrays in
anerf_tpu: over steps 0-200 they must agree exactly, on a grid of
interval, step, warmup, stop, joint and testopt.  The CMA trackers
(``index_add_`` in place of ``segment_sum``) must agree within 1e-6
relative on random losses with repeated frame indices.
"""
import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anerf_tpu.training import flipflop as JF
from anerf_torch.training import flipflop as TF

from test_torch_threads import one_torch_thread  # noqa: F401

GRID = [dict(opt_pose_interval=iv, opt_pose_step=st, opt_pose_warmup=wu,
             opt_pose_stop=sp, opt_pose_joint=jt, testopt=to,
             opt_pose_reset=rs)
        for iv, st, wu, sp, jt, to, rs in itertools.product(
            (1, 4), (1, 3), (0, 7), (None, 150), (False, True),
            (False, True), (True,))]


@pytest.mark.parametrize('kw', GRID, ids=lambda kw: '-'.join(
    f'{k[9:] if k.startswith("opt_pose_") else k}{int(v) if isinstance(v, bool) else v}'
    for k, v in kw.items()))
def test_gates_match_jax(kw):
    jf, tf = JF.FlipFlopConfig(**kw), TF.FlipFlopConfig(**kw)
    steps = jnp.arange(201)
    nerf_j, pose_j = JF.update_gates(jf, steps)
    peek_j = np.asarray(JF.peek_pose_turn(jf, steps))
    snap_j = np.broadcast_to(np.asarray(JF.snapshot_gate(jf, steps)), (201,))
    turn_j = np.asarray(JF.pose_turn(jf, steps))
    jt_j = np.asarray(JF.just_turned(jf, steps))
    for s in range(201):
        nerf_t, pose_t = TF.update_gates(tf, s)
        assert (nerf_t, pose_t) == (bool(nerf_j[s] > 0), bool(pose_j[s] > 0)), s
        assert TF.peek_pose_turn(tf, s) == bool(peek_j[s]), s
        assert TF.snapshot_gate(tf, s) == bool(snap_j[s]), s
        assert TF.pose_turn(tf, s) == bool(turn_j[s]), s
        assert TF.just_turned(tf, s) == bool(jt_j[s]), s


@pytest.mark.parametrize('reg_step', [None, 1, 7])
def test_anneal_pose_reg_matches_jax(reg_step):
    for s in (0, 1, 6, 7, 20, 99):
        a = float(JF.anneal_pose_reg(0.3, s, reg_step, 2.))
        b = TF.anneal_pose_reg(0.3, s, reg_step, 2.)
        assert abs(a - b) <= 1e-6 * abs(a), (s, a, b)


def test_trackers_match_jax():
    """Three rounds of per-ray losses onto 6 frames, with repeated and
    missing frame indices."""
    rng = np.random.RandomState(0)
    js = JF.init_tracker_state(6)
    ts = TF.init_tracker_state(6)
    for r in range(3):
        idx = rng.randint(0, 5, size=(40,)).astype(np.int32)
        loss = rng.uniform(0, 3, size=(40,)).astype(np.float32)
        js = JF.accumulate_loss(js, jnp.asarray(loss), jnp.asarray(idx))
        TF.accumulate_loss(ts, torch.as_tensor(loss),
                           torch.as_tensor(idx).long())
        for k in ('kp_loss_tracker', 'kp_loss_cnt'):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-6, atol=0)
        np.testing.assert_allclose(TF.get_trackers(ts).numpy(),
                                   np.asarray(JF.get_trackers(js)),
                                   rtol=1e-6, atol=0)
    sel = torch.tensor([0, 5, 2])
    np.testing.assert_allclose(TF.get_trackers(ts, sel).numpy(),
                               np.asarray(JF.get_trackers(js, jnp.asarray(
                                   sel.numpy()))), rtol=1e-6)


def test_snapshot_and_reset_copy():
    """The snapshot refreshes only at a pose-turn start (the trainer
    copies the bank in place where ``snapshot_gate`` holds), and neither
    it nor a reset aliases the live bank."""
    from anerf_torch.training.trainer import _where_
    ff = TF.FlipFlopConfig(opt_pose_interval=3, opt_pose_reset=True)
    bank = {'pelvis': torch.zeros(2, 3), 'bones': torch.zeros(2, 24, 3)}
    snap = TF.clone_tree(bank)
    assert snap['bones'].data_ptr() != bank['bones'].data_ptr()
    bank['bones'] += 1
    refresh = lambda s: _where_(torch.tensor(TF.snapshot_gate(ff, s)),
                                list(snap.values()), list(bank.values()))
    refresh(1)                                  # mid-turn: unchanged
    assert float(snap['bones'].max()) == 0.
    refresh(6)                                  # a pose turn starts
    assert float(snap['bones'].min()) == 1.
    assert snap['bones'].data_ptr() != bank['bones'].data_ptr()
    bank['bones'] += 1
    TF.reset_poseopt(bank, snap)
    assert float(bank['bones'].max()) == 1.
    bank['bones'] += 1
    assert float(snap['bones'].max()) == 1.
