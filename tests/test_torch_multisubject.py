"""Multi-subject rendering and training of the port against anerf_tpu on
the CPU.

Two synthetic subjects with different rest poses
(``testing_utils.synthetic_pose(n_subjects=2)``), each frame's FK taken
with its own subject's rest pose, each ray's subject index riding as one
extra view channel (reference raycasters.py:545-548).  The fused backend
runs the split-operand MLP (K5/K6 twins) there, as anerf_tpu runs
``pallas_mlp._fused_mlp``: the fused encode is for one subject only.

Bars, as in the single-subject files: maps within 1e-3 x the reference
map's max (``test_torch_render.py``), the fused train step at
``test_torch_train_fused.py``'s tolerances and the plain trajectory at
``test_torch_train.py``'s.
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
from anerf_tpu.skeleton import SMPLSkeleton as JSMPL
from anerf_tpu.training import pose_opt as JP
from anerf_tpu.training import trainer as JT

from anerf_torch import testing_utils as T
from anerf_torch.interop import params_from_numpy, train_state_from_jax
from anerf_torch.models import raycaster as trc
from anerf_torch.models.factory import build_raycast_config as t_build
from anerf_torch.models.factory import embed_state as t_embed_state
from anerf_torch.models.factory import init_raycaster_params as t_init
from anerf_torch.ops import fused_encmlp as FE
from anerf_torch.ops import fused_mlp as FM
from anerf_torch.skeleton import SMPLSkeleton
from anerf_torch.training import pose_opt as P
from anerf_torch.training import trainer as TT

from test_torch_render import MAPS, _close
from test_torch_train import (N_FRAMES, R, _cfg, _compare_states,
                              _jax_numpy_state, _run, train_state_to_numpy)
from test_torch_threads import one_torch_thread  # noqa: F401

POSE_KEYS = ('kps', 'skts', 'bones', 'cyls')


def _batch():
    """A two-subject scene's batch with each ray's subject, and the rest
    poses (2, J, 3) and each frame's subject.  The rays of seed 2: on
    those of seed 0 the coarse net's rgb-head gradients (~1e-7) ride on
    a few samples of density ~1e-4, where 1 - exp(-x) rounds differently
    in the two frameworks' f32 exp, and their Adam moments differ by
    3.4e-4 in norm, above ``test_torch_train.py``'s bar of 1e-4 (seed 2:
    3.0e-5)."""
    rest, bones, _, kps, skts, cyls = T.synthetic_pose(N_FRAMES,
                                                       n_subjects=2)
    subj = T.subject_of_frame(N_FRAMES, 2)
    batch = T.synthetic_batch(R, N_FRAMES, kps, skts, bones, cyls, seed=2)
    batch['subject_idxs'] = subj[batch['kp_idx']]
    assert set(batch['subject_idxs'].tolist()) == {0, 1}
    return rest, subj, kps, bones, batch


@pytest.mark.parametrize('t_backend,j_backend,compute_dtype',
                         [('plain', 'xla', 'float32'),
                          ('fused', 'pallas', 'bfloat16')])
def test_render_rays_matches_jax(t_backend, j_backend, compute_dtype):
    """render_rays of a 2-subject model with the jitter and noise pinned
    through ``fixed``: the plain backend against JAX's XLA path, the
    fused backend (K5/K6 twins) against the Pallas kernel in interpret
    mode."""
    _, _, _, _, b = _batch()
    cfg = T.surreal_config(N_rand=R, compute_dtype=compute_dtype)
    j_rc = dataclasses.replace(j_build(cfg, n_framecodes=N_FRAMES,
                                       n_subjects=2), mlp_backend=j_backend)
    t_rc = dataclasses.replace(t_build(cfg, n_framecodes=N_FRAMES,
                                       n_subjects=2), mlp_backend=t_backend)
    j_params = j_init(jax.random.PRNGKey(0), j_rc, cfg)
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        j_params))
    rng = np.random.RandomState(7)
    S, I = j_rc.N_samples, j_rc.N_importance
    fixed = {'coarse_u': rng.uniform(size=(R, S)).astype(np.float32),
             'fine_u': rng.uniform(size=(R, I)).astype(np.float32),
             'coarse_noise': rng.normal(size=(R, S)).astype(np.float32),
             'fine_noise': rng.normal(size=(R, S + I)).astype(np.float32)}
    ref = jrc.render_rays(
        j_rc, j_params, jnp.asarray(b['rays_o']), jnp.asarray(b['rays_d']),
        0.0, 1.0, {k: jnp.asarray(b[k]) for k in POSE_KEYS},
        j_embed_state(cfg, j_rc, 500), cam_idxs=jnp.asarray(b['cam_idxs']),
        subject_idxs=jnp.asarray(b['subject_idxs']),
        fixed={k: jnp.asarray(v) for k, v in fixed.items()})
    tb = T.to_device(b, 'cpu')
    with torch.inference_mode():
        got = trc.render_rays(
            t_rc, t_params, tb['rays_o'], tb['rays_d'], 0.0, 1.0,
            {k: tb[k] for k in POSE_KEYS}, t_embed_state(cfg, t_rc, 500),
            cam_idxs=tb['cam_idxs'], subject_idxs=tb['subject_idxs'],
            fixed={k: torch.as_tensor(v) for k, v in fixed.items()})
    for k in MAPS:
        _close(ref[k], got[k])


def test_subject_channel_changes_output():
    """The subject channel reaches the radiance head: the same rays with
    subject 0 and subject 1 give other colors and the same densities
    (the port of tests/test_multisubject.py's test of that name)."""
    _, _, _, _, b = _batch()
    cfg = T.surreal_config(N_rand=R, compute_dtype='bfloat16')
    rc = t_build(cfg, n_framecodes=N_FRAMES, n_subjects=2)
    assert rc.nerf.n_subjects == 2 and rc.mlp_backend == 'fused'
    params = t_init(torch.Generator().manual_seed(0), rc, cfg)
    tb = T.to_device(b, 'cpu')
    outs = []
    for s in (0, 1):
        with torch.inference_mode():
            outs.append(trc.render_rays(
                rc, params, tb['rays_o'], tb['rays_d'], 0.0, 1.0,
                {k: tb[k] for k in POSE_KEYS}, t_embed_state(cfg, rc, 0),
                cam_idxs=tb['cam_idxs'],
                subject_idxs=torch.full((R,), s, dtype=torch.long),
                generator=torch.Generator().manual_seed(7)))
    assert (outs[0]['rgb_map'] - outs[1]['rgb_map']).abs().max() > 1e-4
    np.testing.assert_allclose(outs[0]['alpha'].numpy(),
                               outs[1]['alpha'].numpy(), atol=1e-6)


def _setups(backend_j, backend_t, compute_dtype):
    """``test_torch_train._setups`` with two subjects: the rest poses,
    each frame's subject for FK and each ray's for the model."""
    rest, subj, kps, bones, batch = _batch()
    cfg_j = _cfg(backend_j, compute_dtype)
    cfg_t = _cfg(backend_t, compute_dtype)
    j_setup = JT.TrainSetup(
        cfg=cfg_j, rc=j_build(cfg_j, n_framecodes=N_FRAMES, n_subjects=2),
        skel=JSMPL, rest_pose=jnp.asarray(rest),
        anchors=JP.make_anchors(kps, bones),
        rest_pose_idxs=jnp.asarray(subj), near=0.0, far=1.0)
    j_state = JT.init_train_state(j_setup, jax.random.PRNGKey(0),
                                  init_kp3d=kps, init_bones=bones)
    t_setup = TT.TrainSetup(
        cfg=cfg_t, rc=t_build(cfg_t, n_framecodes=N_FRAMES, n_subjects=2),
        skel=SMPLSkeleton, rest_pose=rest,
        anchors=P.make_anchors(kps, bones), rest_pose_idxs=subj, near=0.0,
        far=1.0, device='cpu')
    return (j_setup, j_state, {k: jnp.asarray(v) for k, v in batch.items()},
            t_setup, T.to_device(batch, 'cpu'))


def test_step_fused_twins_match_pallas_interpret():
    """One multi-subject step on the fused backend (K5/K6 twins) against
    JAX's ``make_train_step`` with the Pallas kernel in interpret mode,
    at ``test_torch_train_fused.py``'s tolerances."""
    j_setup, j_state, jb, t_setup, tb = _setups('pallas', 'fused',
                                                'bfloat16')
    ts = train_state_from_jax(j_state)
    before = (_jax_numpy_state(j_state), train_state_to_numpy(ts))
    js, ts = _run(jax.jit(JT.make_train_step(j_setup)), j_state, jb,
                  TT.make_train_step(t_setup), ts, tb, 1, loss_rtol=1e-4)
    _compare_states(js, ts, pose_atol=1e-6, mom_cos=5e-4, mom_ratio=2e-2,
                    upd_from=before, upd_cos=1e-2)


def test_trajectory_plain_matches_xla():
    """2 multi-subject steps on the plain backend against JAX's XLA
    path, across the pose fire at step 2, at ``test_torch_train.py``'s
    tolerances."""
    j_setup, j_state, jb, t_setup, tb = _setups('xla', 'plain', 'float32')
    ts = train_state_from_jax(j_state)
    js, ts = _run(jax.jit(JT.make_train_step(j_setup)), j_state, jb,
                  TT.make_train_step(t_setup), ts, tb, 2, loss_rtol=1e-5)
    _compare_states(js, ts, pose_atol=1e-6, mom_cos=1e-6, mom_ratio=1e-4)
    assert ts['pose_opt_state']['count'] == 1


def test_single_subject_outside_fused_encode_takes_split_mlp(monkeypatch):
    """A one-subject config outside ``supported_config`` (trainable
    cutoffs) runs the split-operand MLP on the fused backend: three
    calls a render (both nets on the coarse samples, the fine net on
    the importance samples), none of the fused encode kernels."""
    cfg = T.surreal_config(N_rand=R, opt_cutoff=True)
    rc = t_build(cfg, n_framecodes=N_FRAMES)
    assert rc.mlp_backend == 'fused' and not FE.supported_config(rc)
    calls = []
    inner = FM.nerf_mlp_fused

    def spy(*args):
        calls.append([p.shape[-1] for p in args[3]])
        return inner(*args)
    monkeypatch.setattr(FM, 'nerf_mlp_fused', spy)
    monkeypatch.setattr(FE, 'encmlp_fwd', None)
    monkeypatch.setattr(FE, 'encmlp_dual_fwd', None)
    _, _, _, _, b = _batch()
    tb = T.to_device(b, 'cpu')
    params = t_init(torch.Generator().manual_seed(0), rc, cfg)
    with torch.inference_mode():
        out = trc.render_rays(rc, params, tb['rays_o'], tb['rays_d'], 0.0,
                              1.0, {k: tb[k] for k in POSE_KEYS},
                              t_embed_state(cfg, rc, 0),
                              cam_idxs=tb['cam_idxs'])
    assert calls == [[648, 16]] * 3
    assert torch.isfinite(out['rgb_map']).all()
