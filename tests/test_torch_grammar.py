"""Recipes of the rest of the encoder grammar, and the legacy pose
regularizer, against anerf_tpu on the CPU.

The four combinations ``chip_smoke.py``'s grammar phase runs on the
card: kp 'relpos' + bone 'axisang' + view 'rayangle' with cutoff
windows (a 1152-wide trunk at the SURREAL recipe's widths), 'cat' +
'reldir' + 'world' and 'querypts' + 'axisang' + 'relray' without them,
and 'relpos' + 'reldir' + 'relray' with ``normalize_cutoff``.  Each
renders (``render_rays`` with the draws pinned through ``fixed``) and
takes one train step on the port's plain backend against anerf_tpu's
XLA path, at R=8 rays, 8 + 4 samples and 8x64 nets.  Then the mesh
path's ``render_pts_density`` for 'relpos', the refusal of 'axisang'
with a rot6d pose bank by both packages, and ``kp_reg_loss_legacy``
over its ``opt_pose_type`` grammar.

Tolerances.  Both sides run the f32 chain and differ by summation order
and transcendental rounding: maps and densities within 1e-5 x the
reference's max (``test_torch_ops.py``'s bar for f32 paths); the train
step at ``test_torch_train.py``'s bars for the plain backend (losses
1e-5 relative, 99.9% of the parameters within 2e-6 and all within
2 lr, the pose bank within 1e-6), but for the Adam moments: each within
1e-4 of its norm plus 1e-6 of the largest moment's norm in its tree.
The floor is for the fine net's alpha head, whose gradient at the
random init comes from the few samples of positive density: its first
moment's norm is 3e-7 to 8e-7 against 1e-2 to 2e-2 for the largest
leaf (measured), and its moments agree in direction but differ by up
to 8.3e-4 in norm, f32 summation noise (every other leaf within 2e-6).
The pose losses and their gradients within 1e-5 relative.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anerf_tpu.models import raycaster as jrc
from anerf_tpu.models.factory import build_raycast_config as j_build
from anerf_tpu.models.factory import embed_state as j_embed_state
from anerf_tpu.models.factory import init_raycaster_params as j_init
from anerf_tpu.ops.rotations import axisang_to_rot as j_axisang_to_rot
from anerf_tpu.ops.rotations import rot_to_rot6d as j_rot_to_rot6d
from anerf_tpu.skeleton import SMPLSkeleton as JSMPL
from anerf_tpu.training import pose_opt as JP
from anerf_tpu.training import trainer as JT

from anerf_torch import testing_utils as T
from anerf_torch.interop import params_from_numpy, train_state_from_jax
from anerf_torch.models import raycaster as trc
from anerf_torch.models.factory import build_raycast_config as t_build
from anerf_torch.models.factory import embed_state as t_embed_state
from anerf_torch.skeleton import SMPLSkeleton
from anerf_torch.training import pose_opt as P
from anerf_torch.training import trainer as TT

from test_torch_ops import _close
from test_torch_train import (_flat, _jax_numpy_state, _run,
                              train_state_to_numpy)
from test_torch_threads import one_torch_thread  # noqa: F401

R, N_FRAMES = 8, 4
LR = 5e-4
POSE_KEYS = ('kps', 'skts', 'bones', 'cyls')
MAPS = ('rgb_map', 'acc_map', 'disp_map', 'rgb0', 'acc0')
# (kp, bone, view, config overrides): the grammar phase's combinations
COMBOS = {
    'relpos-axisang-rayangle': ('relpos', 'axisang', 'rayangle',
                                dict(use_cutoff=True)),
    'cat-reldir-world': ('cat', 'reldir', 'world', dict(use_cutoff=False)),
    'querypts-axisang-relray': ('querypts', 'axisang', 'relray',
                                dict(use_cutoff=False)),
    'relpos-reldir-relray-normalize': ('relpos', 'reldir', 'relray',
                                       dict(use_cutoff=True,
                                            normalize_cutoff=True)),
}


def _cfg(name, backend):
    kp, bone, view, over = COMBOS[name]
    return T.surreal_config(
        kp_dist_type=kp, bone_type=bone, view_type=view, N_rand=R,
        N_samples=8, N_importance=4, netwidth=64, perturb=0.,
        raw_noise_std=0., opt_pose=True, opt_pose_step=2, opt_pose_coef=0.1,
        opt_pose_lrate=5e-3, mlp_backend=backend, **over)


def _scene():
    rest, bones, _, kps, skts, cyls = T.synthetic_pose(N_FRAMES)
    batch = T.synthetic_batch(R, N_FRAMES, kps, skts, bones, cyls)
    return rest, bones, kps, batch


@pytest.mark.parametrize('name', sorted(COMBOS))
def test_encode_inputs_matches_jax(name):
    """The encodings (v, r, d) each recipe hands the MLP."""
    cfg = _cfg(name, 'xla')
    _, _, kps, b = _scene()
    S = 5
    pts = np.random.RandomState(4).uniform(-0.5, 0.5, (R, S, 3)).astype(
        np.float32)
    j_rc, t_rc = j_build(cfg, n_framecodes=N_FRAMES), t_build(
        cfg, n_framecodes=N_FRAMES)
    cutoff = np.asarray(j_init(jax.random.PRNGKey(0), j_rc, cfg)[
        'cutoff_dist'])
    pose = {k: b[k] for k in POSE_KEYS}
    ref = jax.jit(lambda *a: jrc.encode_inputs(j_rc, *a))(
        {'cutoff_dist': jnp.asarray(cutoff)}, jnp.asarray(pts),
        jnp.asarray(b['rays_o']), jnp.asarray(b['rays_d']),
        {k: jnp.asarray(v) for k, v in pose.items()},
        j_embed_state(cfg, j_rc, 500))
    got = trc.encode_inputs(
        t_rc, {'cutoff_dist': torch.as_tensor(cutoff)}, torch.as_tensor(pts),
        torch.as_tensor(b['rays_o']), torch.as_tensor(b['rays_d']),
        {k: torch.as_tensor(v) for k, v in pose.items()},
        t_embed_state(cfg, t_rc, 500))
    widths = (t_rc.nerf.input_ch, t_rc.nerf.input_ch_bones,
              t_rc.nerf.input_ch_views)
    for a, g, width in zip(ref, got, widths):
        assert g.shape == (R, S, width)
        _close(a, g)


@pytest.mark.parametrize('name', sorted(COMBOS))
def test_render_rays_plain_matches_xla(name):
    cfg = _cfg(name, 'xla')
    _, _, _, b = _scene()
    j_rc = j_build(cfg, n_framecodes=N_FRAMES)
    t_rc = dataclasses.replace(t_build(cfg, n_framecodes=N_FRAMES),
                               mlp_backend='plain')
    j_params = j_init(jax.random.PRNGKey(0), j_rc, cfg)
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        j_params))
    rng = np.random.RandomState(7)
    S, I = j_rc.N_samples, j_rc.N_importance
    fixed = {'coarse_u': rng.uniform(size=(R, S)).astype(np.float32),
             'fine_u': rng.uniform(size=(R, I)).astype(np.float32)}
    ref = jax.jit(lambda *a: jrc.render_rays(
        j_rc, a[0], a[1], a[2], 0.0, 1.0, a[3], a[4], cam_idxs=a[5],
        fixed=a[6]))(
        j_params, jnp.asarray(b['rays_o']), jnp.asarray(b['rays_d']),
        {k: jnp.asarray(b[k]) for k in POSE_KEYS},
        j_embed_state(cfg, j_rc, 500), jnp.asarray(b['cam_idxs']),
        {k: jnp.asarray(v) for k, v in fixed.items()})
    tb = T.to_device(b, 'cpu')
    with torch.inference_mode():
        got = trc.render_rays(
            t_rc, t_params, tb['rays_o'], tb['rays_d'], 0.0, 1.0,
            {k: tb[k] for k in POSE_KEYS}, t_embed_state(cfg, t_rc, 500),
            cam_idxs=tb['cam_idxs'],
            fixed={k: torch.as_tensor(v) for k, v in fixed.items()})
    assert float(np.asarray(ref['acc_map']).max()) > 1e-3
    for k in MAPS:
        _close(ref[k], got[k])


@pytest.mark.parametrize('name', sorted(COMBOS))
def test_train_step_plain_matches_xla(name):
    """One step of ``make_train_step`` from the same state and batch."""
    cfg_j, cfg_t = _cfg(name, 'xla'), _cfg(name, 'plain')
    rest, bones, kps, batch = _scene()
    j_setup = JT.TrainSetup(cfg=cfg_j, rc=dataclasses.replace(
        j_build(cfg_j, n_framecodes=N_FRAMES), viewfac=False), skel=JSMPL,
        rest_pose=jnp.asarray(rest), anchors=JP.make_anchors(kps, bones),
        near=0.0, far=1.0)
    j_state = JT.init_train_state(j_setup, jax.random.PRNGKey(0),
                                  init_kp3d=kps, init_bones=bones)
    t_setup = TT.TrainSetup(cfg=cfg_t, rc=t_build(cfg_t,
                                                  n_framecodes=N_FRAMES),
                            skel=SMPLSkeleton, rest_pose=rest,
                            anchors=P.make_anchors(kps, bones), near=0.0,
                            far=1.0, device='cpu')
    assert t_setup.rc.mlp_backend == 'plain'
    js, ts = _run(jax.jit(JT.make_train_step(j_setup)), j_state,
                  {k: jnp.asarray(v) for k, v in batch.items()},
                  TT.make_train_step(t_setup), train_state_from_jax(j_state),
                  T.to_device(batch, 'cpu'), 1, loss_rtol=1e-5)
    js, ts = _jax_numpy_state(js), train_state_to_numpy(ts)
    assert js['step'] == ts['step']
    for k in ('opt_state', 'pose_opt_state'):
        assert js[k]['count'] == ts[k]['count'], k
        for m in ('mu', 'nu'):
            a, b = _flat(js[k][m]), _flat(ts[k][m])
            floor = 1e-6 * max(np.linalg.norm(x) for x in a)
            for i, (x, y) in enumerate(zip(a, b)):
                err = np.linalg.norm(x - y)
                assert err <= 1e-4 * np.linalg.norm(x) + floor, \
                    (k, m, i, err, np.linalg.norm(x), floor)
    d = np.concatenate([np.abs(a - b) for a, b in
                        zip(_flat(js['params']), _flat(ts['params']))])
    assert np.quantile(d, 0.999) < 2e-6 and d.max() < 2 * LR, \
        (np.quantile(d, 0.999), d.max())
    for k in ('pose_params', 'pose_accum'):
        for a, b in zip(_flat(js[k]), _flat(ts[k])):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_render_pts_density_relpos_matches_jax():
    """The mesh path's density for the 'relpos' + 'axisang' recipe, its
    windows on |pts - kps| (ROADMAP.md C.2)."""
    cfg = _cfg('relpos-axisang-rayangle', 'xla')
    j_rc = j_build(cfg, n_framecodes=N_FRAMES)
    t_rc = t_build(cfg, n_framecodes=N_FRAMES)
    j_params = j_init(jax.random.PRNGKey(1), j_rc, cfg)
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        j_params))
    _, bones, _, kps, skts, _ = T.synthetic_pose(1)
    pts = np.random.RandomState(3).uniform(-0.6, 0.6, (64, 1, 3)).astype(
        np.float32)
    pose = {'kps': kps, 'skts': skts, 'bones': bones}
    ref = jrc.render_pts_density(
        j_rc, j_params, jnp.asarray(pts),
        {k: jnp.asarray(v) for k, v in pose.items()},
        j_embed_state(cfg, j_rc, 500))
    with torch.inference_mode():
        got = trc.render_pts_density(
            t_rc, t_params, torch.as_tensor(pts),
            {k: torch.as_tensor(v) for k, v in pose.items()},
            t_embed_state(cfg, t_rc, 500))
    assert got.shape == (64, 1, 1)
    _close(ref, got)


def test_axisang_with_rot6d_bones_raises_in_both():
    """'axisang' feeds the pose's bones to the net as they are: a rot6d
    bank's 6-channel bones do not fit its 72-channel bone input, and
    both packages refuse them."""
    cfg = _cfg('querypts-axisang-relray', 'xla')
    _, _, _, b = _scene()
    j_rc = j_build(cfg, n_framecodes=N_FRAMES)
    t_rc = dataclasses.replace(t_build(cfg, n_framecodes=N_FRAMES),
                               mlp_backend='plain')
    j_params = j_init(jax.random.PRNGKey(0), j_rc, cfg)
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        j_params))
    rot6d = np.asarray(j_rot_to_rot6d(j_axisang_to_rot(
        jnp.asarray(b['bones']))))
    assert rot6d.shape == (R, 24, 6)
    pose = {k: b[k] for k in POSE_KEYS}
    pose['bones'] = rot6d
    with pytest.raises(Exception):
        jax.jit(lambda *a: jrc.render_rays(
            j_rc, a[0], a[1], a[2], 0.0, 1.0, a[3], a[4], cam_idxs=a[5]))(
            j_params, jnp.asarray(b['rays_o']), jnp.asarray(b['rays_d']),
            {k: jnp.asarray(v) for k, v in pose.items()},
            j_embed_state(cfg, j_rc, 500), jnp.asarray(b['cam_idxs']))
    with pytest.raises(RuntimeError):
        trc.render_rays(t_rc, t_params, torch.as_tensor(b['rays_o']),
                        torch.as_tensor(b['rays_d']), 0.0, 1.0,
                        {k: torch.as_tensor(v) for k, v in pose.items()},
                        t_embed_state(cfg, t_rc, 500),
                        cam_idxs=torch.as_tensor(b['cam_idxs']).long())


# -------------------------------------------------- kp_reg_loss_legacy ----

def _pose_case(seed, rot6d, temporal):
    """preds and regs of N=4 frames (anerf_tpu's tests/test_pose_legacy_
    loss.py ``make_case``), with the temporal neighbours and ground-truth
    joints when ``temporal``."""
    rng = np.random.default_rng(seed)
    N, J = 4, 24
    aa = (rng.normal(size=(N, J, 3)) * 0.4).astype(np.float32)
    reg_aa = aa + (rng.normal(size=aa.shape) * 0.05).astype(np.float32)
    rots = np.asarray(j_axisang_to_rot(jnp.asarray(aa)))
    reg_rots = np.asarray(j_axisang_to_rot(jnp.asarray(reg_aa)))
    bones = np.asarray(j_rot_to_rot6d(jnp.asarray(rots))) if rot6d else aa
    kps = rng.normal(size=(N, J, 3)).astype(np.float32)
    reg_kps = kps + (rng.normal(size=kps.shape) * 0.02).astype(np.float32)
    preds = {'kps': kps, 'bones': bones, 'rots': rots}
    regs = {'kps': reg_kps, 'bones': reg_aa, 'rots': reg_rots}
    extra = {}
    if temporal:
        tb = (rng.normal(size=(2 * N, J, 3)) * 0.4).astype(np.float32)
        regs['temp_bones'] = (np.asarray(j_rot_to_rot6d(j_axisang_to_rot(
            jnp.asarray(tb)))) if rot6d else tb)
        regs['temp_rots'] = np.asarray(j_axisang_to_rot(jnp.asarray(tb)))
        regs['temp_kps'] = rng.normal(size=(2 * N, J, 3)).astype(np.float32)
        regs['temp_valid'] = (rng.random(N) > 0.3).astype(np.float32)
        regs['temp_valid_next'] = (rng.random(N) > 0.3).astype(np.float32)
        extra['gt_kps'] = kps + rng.normal(size=kps.shape).astype(
            np.float32) * 0.01
    return preds, regs, extra


LEGACY = [('B', False, False, {}), ('B', True, False, {}),
          ('BE', True, False, {}), ('BL1', False, False, {}),
          ('BL1E', False, False, {}), ('RD', False, False, {}),
          ('RDE', True, False, {}), ('RDL1', False, False, {}),
          ('B', False, True, dict(temp_coef=0.05)),
          ('BL1', True, True, dict(temp_coef=0.05)),
          ('B', False, True, dict(temp_coef=0.05, use_temp_vel=True)),
          ('RDE', True, True, dict(temp_coef=0.05, use_temp_vel=True))]


@pytest.mark.parametrize('case', range(len(LEGACY)),
                         ids=[f'{t}-rot6d{r:d}-temp{m:d}-vel'
                              f'{int(kw.get("use_temp_vel", False))}'
                              for t, r, m, kw in LEGACY])
def test_kp_reg_loss_legacy_matches_jax(case):
    """Every output, and the gradients of the loss with respect to the
    predictions."""
    opt_type, rot6d, temporal, kw = LEGACY[case]
    preds, regs, extra = _pose_case(case, rot6d, temporal)
    kw = dict(kw, opt_pose_type=opt_type, opt_pose_tol=0.01,
              opt_pose_coef=2.0, use_rot6d=rot6d)

    def j_loss(p):
        out = JP.kp_reg_loss_legacy(
            p, {k: jnp.asarray(v) for k, v in regs.items()},
            gt_kps=(jnp.asarray(extra['gt_kps']) if extra else None), **kw)
        return out['kp_loss'], out
    (_, ref), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in preds.items()})
    t_preds = {k: torch.tensor(v, requires_grad=True)
               for k, v in preds.items()}
    got = P.kp_reg_loss_legacy(
        t_preds, {k: torch.as_tensor(v) for k, v in regs.items()},
        gt_kps=(torch.as_tensor(extra['gt_kps']) if extra else None), **kw)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    assert got['temp_loss'].item() != 0. or not temporal
    grads = torch.autograd.grad(got['kp_loss'], list(t_preds.values()),
                                allow_unused=True)
    for k, g in zip(t_preds, grads):
        want = np.asarray(j_grads[k])
        g = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(g, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max() + 1e-12,
                                   err_msg=k)


def test_kp_reg_loss_legacy_refuses_unknown_target():
    preds, regs, _ = _pose_case(0, False, False)
    with pytest.raises(NotImplementedError):
        P.kp_reg_loss_legacy({k: torch.as_tensor(v) for k, v in
                              preds.items()},
                             {k: torch.as_tensor(v) for k, v in
                              regs.items()}, opt_pose_type='X')
