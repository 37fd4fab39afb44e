"""Port render path vs anerf_tpu on the CPU: ``render_rays`` at the eval
variant and ``ImageRenderer.render_image``, flagship SURREAL recipe.

Both packages get the same numpy inputs and the same parameters (the
JAX tree converted through ``anerf_torch.interop``).  Tolerance: 1e-3 x
the reference map's max, the bar anerf_tpu holds its fused kernels to
against its XLA path (tests/test_pallas_encmlp.py:53); the f32 paths
differ only in summation order and transcendental rounding (those get
1e-5), and bf16 paths additionally by occasional bf16 rounding flips
between layers.  The rays are those of anerf_tpu's own fused-kernel
tests (``synthetic_batch`` seed 0), which hit the subject: on rays that
barely graze it the maps are ~1e-4 and a relative bar measures noise.
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
from anerf_tpu.render.renderer import ImageRenderer as JImageRenderer

from anerf_torch import testing_utils as T
from anerf_torch.interop import params_from_numpy
from anerf_torch.models import raycaster as trc
from anerf_torch.models.factory import build_raycast_config as t_build
from anerf_torch.models.factory import embed_state as t_embed_state
from anerf_torch.render.renderer import ImageRenderer

from test_torch_threads import one_torch_thread  # noqa: F401

MAPS = ('rgb_map', 'acc_map', 'disp_map', 'rgb0', 'acc0')


def _scene(n_rays, compute_dtype='float32'):
    cfg = T.surreal_config(N_rand=n_rays, compute_dtype=compute_dtype)
    rest, bones, pelvis, kps, skts, cyls = T.synthetic_pose(4)
    batch = T.synthetic_batch(n_rays, 4, kps, skts, bones, cyls)
    j_rc = j_build(cfg, n_framecodes=4)
    j_params = j_init(jax.random.PRNGKey(0), j_rc, cfg)
    t_rc = t_build(cfg, n_framecodes=4)
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        j_params))
    return dict(cfg=cfg, batch=batch, j_rc=j_rc, j_params=j_params,
                t_rc=t_rc, t_params=t_params, kps=kps, skts=skts,
                bones=bones, cyls=cyls)


def _close(ref, got, tol=1e-3):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    scale = np.abs(ref).max() + 1e-6
    err = np.abs(ref - got).max()
    assert err < tol * scale, (err, scale)


@pytest.mark.parametrize('compute_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('backend', ['plain', 'fused'])
def test_render_rays_eval_matches_jax(compute_dtype, backend):
    """Port render_rays (eval variant) against JAX render_rays on its
    'xla' backend.  backend='fused' runs the port's fused path, whose
    wrappers take the kernels' plain twins on CPU tensors."""
    s = _scene(12, compute_dtype)
    b = s['batch']
    pose_keys = ('kps', 'skts', 'bones', 'cyls')
    est_j = j_embed_state(s['cfg'], s['j_rc'], 10000)
    j_rc = dataclasses.replace(s['j_rc'].eval_variant(), mlp_backend='xla')
    ref = jrc.render_rays(
        j_rc, s['j_params'], jnp.asarray(b['rays_o']),
        jnp.asarray(b['rays_d']), 0.0, 1.0,
        {k: jnp.asarray(b[k]) for k in pose_keys}, est_j,
        cam_idxs=jnp.asarray(b['cam_idxs']))

    t_rc = dataclasses.replace(s['t_rc'].eval_variant(), mlp_backend=backend)
    tb = T.to_device(b, 'cpu')
    with torch.inference_mode():
        got = trc.render_rays(
            t_rc, s['t_params'], tb['rays_o'], tb['rays_d'], 0.0, 1.0,
            {k: tb[k] for k in pose_keys},
            t_embed_state(s['cfg'], s['t_rc'], 10000),
            cam_idxs=tb['cam_idxs'])
    # the plain f32 chain differs from JAX's only in summation order
    # (measured <= 5e-7 x scale)
    tol = 1e-5 if (backend, compute_dtype) == ('plain', 'float32') else 1e-3
    for k in MAPS:
        _close(ref[k], got[k], tol)


def test_render_rays_train_variant_pinned_randomness():
    """The stochastic (train) variant with the jitter and density noise
    pinned through ``fixed``, f32, plain backend."""
    s = _scene(8)
    b = s['batch']
    rc_j = dataclasses.replace(s['j_rc'], mlp_backend='xla')
    rng = np.random.RandomState(7)
    S, I = rc_j.N_samples, rc_j.N_importance
    fixed = {'coarse_u': rng.uniform(size=(8, S)).astype(np.float32),
             'fine_u': rng.uniform(size=(8, I)).astype(np.float32),
             'coarse_noise': rng.normal(size=(8, S)).astype(np.float32),
             'fine_noise': rng.normal(size=(8, S + I)).astype(np.float32)}
    pose_keys = ('kps', 'skts', 'bones', 'cyls')
    ref = jrc.render_rays(
        rc_j, s['j_params'], jnp.asarray(b['rays_o']),
        jnp.asarray(b['rays_d']), 0.0, 1.0,
        {k: jnp.asarray(b[k]) for k in pose_keys},
        j_embed_state(s['cfg'], s['j_rc'], 500),
        cam_idxs=jnp.asarray(b['cam_idxs']),
        fixed={k: jnp.asarray(v) for k, v in fixed.items()})
    tb = T.to_device(b, 'cpu')
    with torch.inference_mode():
        got = trc.render_rays(
            dataclasses.replace(s['t_rc'], mlp_backend='plain'),
            s['t_params'], tb['rays_o'], tb['rays_d'], 0.0, 1.0,
            {k: tb[k] for k in pose_keys},
            t_embed_state(s['cfg'], s['t_rc'], 500),
            cam_idxs=tb['cam_idxs'],
            fixed={k: torch.as_tensor(v) for k, v in fixed.items()})
    for k in MAPS:
        _close(ref[k], got[k], 1e-5)


@pytest.mark.parametrize('cam_idx', [-1, 2])
def test_render_image_matches_jax(cam_idx):
    """A small image through both ImageRenderers, with the mean code
    (cam_idx=-1, the renderer's default) and a per-frame code.  A chunk
    of 96 rays exercises the padded tail chunk and the per-chunk
    cylinder mean."""
    s = _scene(8)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 2.7
    kw = dict(chunk=96, near=0.0, far=1.0)
    est_j = j_embed_state(s['cfg'], s['j_rc'], 10000)
    jr = JImageRenderer(dataclasses.replace(s['j_rc'], mlp_backend='xla'),
                        s['j_params'], est_j, **kw)
    tr = ImageRenderer(s['t_rc'], s['t_params'],
                       t_embed_state(s['cfg'], s['t_rc'], 10000),
                       device='cpu', **kw)
    bg = np.full((20, 20, 3), 0.25, np.float32)
    args = (20, 20, 60.0, c2w, s['kps'][1], s['skts'][1], s['bones'][1])
    ref = jr.render_image(*args, cam_idx=cam_idx, bg=bg)
    got = tr.render_image(*args, cam_idx=cam_idx, bg=bg)
    for k in ('rgb', 'acc', 'disp'):
        _close(ref[k], got[k])
    assert [np.asarray(x).tolist() for x in ref['bbox']] == \
        [np.asarray(x).tolist() for x in got['bbox']]


def test_render_rays_generator_draws():
    """The train variant draws its jitter and noise from the generator:
    the same seed gives the same maps, another seed other ones."""
    s = _scene(8)
    tb = T.to_device(s['batch'], 'cpu')
    pose = {k: tb[k] for k in ('kps', 'skts', 'bones', 'cyls')}
    rc = dataclasses.replace(s['t_rc'], mlp_backend='plain')

    def run(seed):
        return trc.render_rays(rc, s['t_params'], tb['rays_o'], tb['rays_d'],
                               0.0, 1.0, pose, None, cam_idxs=tb['cam_idxs'],
                               generator=torch.Generator().manual_seed(seed))
    with torch.inference_mode():
        a, b, c = run(0), run(0), run(1)
    assert torch.isfinite(a['rgb_map']).all()
    assert torch.equal(a['rgb_map'], b['rgb_map'])
    assert not torch.equal(a['rgb_map'], c['rgb_map'])
