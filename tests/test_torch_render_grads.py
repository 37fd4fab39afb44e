"""Gradients of ``render_rays`` on the fused backend (K2/K4 on the coarse
samples, K1/K3 on the importance samples) with respect to params and
``skts`` against anerf_tpu's Pallas backend with ``fixed`` draws, on
the CPU.  The scene and the bars are those of
``test_torch_fused_bwd.py`` (cosine > 0.9999, norm ratio within 5e-3,
elementwise mean and worst bars).  Through the whole render path the
bf16 rounding flips compound over the coarse and fine passes and the
compositing, and tiny leaves (the framecodes of frames few rays hit)
carry most of the relative error: there the mean bar is 2e-3 (measured
at most 8.1e-4, worst element 9.9e-3).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from test_torch_fused_bwd import assert_grad_close, scene  # noqa: F401

from anerf_tpu.models import raycaster as jrc
from anerf_tpu.models.factory import embed_state as j_embed_state

from anerf_torch import testing_utils as T
from anerf_torch.models import raycaster as trc
from anerf_torch.models.factory import embed_state as t_embed_state


def _render_loss_j(rc, params, batch, est, pose, skts, fixed):
    p2 = dict(pose, skts=skts)
    out = jrc.render_rays(rc, params, batch['rays_o'], batch['rays_d'], 0.,
                          1., p2, est, cam_idxs=batch['cam_idxs'],
                          fixed=fixed)
    return ((out['rgb_map'] ** 2).mean() + (out['rgb0'] ** 2).mean()
            + (out['acc_map'] ** 2).mean())


def _render_loss_t(rc, params, batch, est, pose, skts, fixed):
    p2 = dict(pose, skts=skts)
    out = trc.render_rays(rc, params, batch['rays_o'], batch['rays_d'], 0.,
                          1., p2, est, cam_idxs=batch['cam_idxs'],
                          fixed=fixed)
    return ((out['rgb_map'] ** 2).mean() + (out['rgb0'] ** 2).mean()
            + (out['acc_map'] ** 2).mean())


@pytest.mark.parametrize('viewfac', [False, True])
def test_render_rays_gradients_match_jax(scene, viewfac):
    """Gradients of a loss on the rendered maps with respect to params
    and ``skts`` through the whole fused path (K2/K4 on the coarse
    samples, K1/K3 on the importance samples, compositing, the rank
    merge, view PE and the rigid transform) against JAX's Pallas
    backend with the same pinned draws.  Against JAX's default viewfac
    form the bar is anerf_tpu's own viewfac bar (cos > 0.998,
    |ratio - 1| < 3%, tests/test_pallas_encmlp.py:166-179)."""
    b = scene['batch']
    rng = np.random.RandomState(5)
    R, S, Si = 8, 64, 16
    fixed = {'coarse_u': rng.uniform(size=(R, S)).astype(np.float32),
             'fine_u': np.sort(rng.uniform(size=(R, Si)), -1)
             .astype(np.float32),
             'coarse_noise': rng.normal(size=(R, S)).astype(np.float32),
             'fine_noise': rng.normal(size=(R, S + Si)).astype(np.float32)}
    pose_np = {'kps': b['kps'], 'skts': b['skts'], 'bones': b['bones'],
               'cyls': b['cyls']}
    cfg = scene['cfg']
    j_rc = dataclasses.replace(scene['j_rc'], mlp_backend='pallas',
                               viewfac=viewfac)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    j_est = j_embed_state(cfg, j_rc, 2000)
    jl = lambda prm, sk: _render_loss_j(
        j_rc, prm, jb, j_est, {k: jnp.asarray(v) for k, v in pose_np.items()},
        sk, {k: jnp.asarray(v) for k, v in fixed.items()})
    g_ref = jax.grad(jl, argnums=(0, 1))(scene['j_params'],
                                         jnp.asarray(b['skts']))

    t_rc = dataclasses.replace(scene['t_rc'], mlp_backend='fused')
    tb = T.to_device(b, 'cpu')
    params = jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32), requires_grad=True),
        jax.tree_util.tree_map(np.asarray, scene['j_params']))
    skts = torch.tensor(b['skts'], requires_grad=True)
    loss = _render_loss_t(
        t_rc, params, tb, t_embed_state(cfg, t_rc, 2000),
        {k: torch.as_tensor(v) for k, v in pose_np.items()}, skts,
        {k: torch.as_tensor(v) for k, v in fixed.items()})
    leaves_t = jax.tree_util.tree_leaves(params) + [skts]
    grads_t = torch.autograd.grad(loss, leaves_t, allow_unused=True)
    leaves_j = jax.tree_util.tree_leaves(g_ref[0]) + [g_ref[1]]
    assert len(leaves_j) == len(grads_t)
    kw = (dict(cos_tol=2e-3, ratio_tol=3e-2, elementwise=False) if viewfac
          else dict(mean_tol=2e-3))
    for i, (a, gt) in enumerate(zip(leaves_j, grads_t)):
        gt = torch.zeros(a.shape) if gt is None else gt
        assert_grad_close(np.asarray(a, np.float32), gt.numpy(),
                          name=f'leaf {i}', **kw)
