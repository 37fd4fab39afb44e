"""Which MLP kernels ``render_rays`` routes each shipped config to, on
the CPU, where the route is the one the card takes.

The fused encode kernels K1-K4 are compiled per static shape, for nets
256 or 512 wide of 1-32 layers (1-16 wider) at 1-13 kp bands
(``fused_encmlp.F_MAX``) and 1-21 view rows
(``fused_encmlp.kernel_shape``).
``fused_encmlp.kernel_shape_ok`` decides from the raycast config alone
whether they take it; a one-subject config on the fused backend that
they do not take runs the plain encode and the split-operand kernels
K5/K6 (``fused_mlp.nerf_mlp_fused``), as anerf_tpu falls back when its fused
kernel returns None (anerf_tpu/models/raycaster.py:344-352).  Every
shipped config builds with the port's encoders; the route is observed
by counting calls of the kernels' wrappers.  So is that of each encoder
type of the rest of the grammar: K5/K6 at its trunk width.
"""
import dataclasses
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anerf_tpu.models import raycaster as jrc
from anerf_tpu.models.factory import build_raycast_config as j_build
from anerf_tpu.models.factory import embed_state as j_embed_state
from anerf_tpu.models.factory import init_raycaster_params as j_init
from anerf_tpu.utils.config import load_config as j_load_config

from anerf_torch import testing_utils as T
from anerf_torch.interop import params_from_numpy
from anerf_torch.models import raycaster as trc
from anerf_torch.models.factory import build_raycast_config as t_build
from anerf_torch.models.factory import embed_state as t_embed_state
from anerf_torch.models.factory import init_raycaster_params as t_init
from anerf_torch.ops import fused_encmlp as FE
from anerf_torch.ops import fused_mlp as FM
from anerf_torch.training.trainer import tree_leaves
from anerf_torch.utils.config import load_config

from test_torch_encmlp_shapes_bwd import _assert_f64_close
from test_torch_render import MAPS, _close
from test_torch_threads import one_torch_thread  # noqa: F401

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'configs')
POSE_KEYS = ('kps', 'skts', 'bones', 'cyls')
N_FRAMES = 4

# the route of each shipped config: 'fused' (K1/K2 and their backwards;
# surreal_single's one view PE row, view_nb = 1, has its build), 'split'
# (the plain encode and K5/K6) or 'plain' (synthetic_tiny's 2 x 32 net
# maps to the plain backend: 'auto' takes the kernels for widths that
# are multiples of 256, as anerf_tpu's auto_worthwhile does, though
# K5/K6 take the net)
ROUTES = {'h36m_prot2.txt': 'fused', 'h36m_prot2_finetune.txt': 'fused',
          'mixamo.txt': 'fused', 'mixamo_finetune.txt': 'fused',
          'perfcap.txt': 'fused', 'perfcap_finetune.txt': 'fused',
          'surreal.txt': 'fused', 'surreal_single.txt': 'fused',
          'synthetic_tiny.txt': 'plain'}
# shipped configs changed in their net: surreal_single at a net 512
# wide, which the fused kernels take since ROADMAP B.1.2, and at 768,
# which they take since B.1.4's first part (the WIDE nets), as surreal
# at two 8 x 1024 nets, the 8 x 1024 flagship; surreal at
# 21 view rows with framecodes of 128, which they take since B.1.3, and
# with two subjects at 11 view rows, which runs the split route, whose
# K5/K6 take its views parts 792 + 1 + 16 since C.15; surreal at the kp
# band cap F_MAX (fused, B.1.4's kp-band row) and one band past it (split:
# the plain encode's exact sines, ROADMAP C.17); surreal at two 24-layer
# nets, which the fused kernels take since B.1.4's depth row
VARIANTS = {'surreal_single.txt:netwidth512': (
    'surreal_single.txt', dict(netwidth=512, netwidth_fine=512), 'fused'),
    'surreal_single.txt:netwidth768': (
    'surreal_single.txt', dict(netwidth=768, netwidth_fine=768), 'fused'),
    'surreal.txt:netwidth1024': (
    'surreal.txt', dict(netwidth=1024, netwidth_fine=1024), 'fused'),
    'surreal.txt:views10_codes128': (
    'surreal.txt', dict(multires_views=10, framecode_size=128,
                        opt_framecode=True), 'fused'),
    'surreal.txt:two_subjects_views5': (
    'surreal.txt', dict(multires_views=5, n_subjects=2), 'split'),
    f'surreal.txt:multires{FE.F_MAX}': (
    'surreal.txt', dict(multires=FE.F_MAX), 'fused'),
    f'surreal.txt:multires{FE.F_MAX + 1}': (
    'surreal.txt', dict(multires=FE.F_MAX + 1), 'split'),
    'surreal.txt:netdepth24': (
    'surreal.txt', dict(netdepth=24, netdepth_fine=24), 'fused')}


def test_every_shipped_config_is_listed():
    assert sorted(f for f in os.listdir(CONFIGS) if f.endswith('.txt')) \
        == sorted(ROUTES)


def _route_config(name):
    """(config, route) of a shipped config or of a variant of one."""
    if name in VARIANTS:
        path, over, route = VARIANTS[name]
        return load_config(os.path.join(CONFIGS, path), **over), route
    return load_config(os.path.join(CONFIGS, name)), ROUTES[name]


def _split_static(rc):
    """The split kernels' static shape for ``rc``'s parts, as
    ``_run_network`` hands them over."""
    views = ((rc.view_embed.out_dim,)
             + ((1,) if rc.n_subjects > 1 else ())
             + ((rc.nerf.framecode_ch,) if rc.nerf.use_framecode else ()))
    return FM.MLPStatic(depth=rc.nerf.depth, width=rc.nerf.width,
                        dparts=(rc.kp_embed.out_dim, rc.bone_embed.out_dim),
                        vparts=views, half=rc.nerf.width // 2,
                        skips=tuple(rc.nerf.skips))


def _spy(monkeypatch, module, name, calls):
    inner = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return inner(*args, **kwargs)
    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize('name', sorted(ROUTES) + sorted(VARIANTS))
def test_render_route(name, monkeypatch):
    """``kernel_shape_ok`` holds for exactly the one-subject configs
    routed to the fused kernels, and ``render_rays`` takes that route:
    the fused wrappers for those (K1 on both passes with a single net),
    the split wrapper (three calls, or two with a single net) and never
    a fused one for the rest on the fused backend (multi-subject models
    among them)."""
    cfg, route = _route_config(name)
    rc = t_build(cfg, n_framecodes=N_FRAMES)
    assert (FE.kernel_shape_ok(rc) and rc.n_subjects == 1) == \
        (route == 'fused')
    if route == 'plain':
        assert rc.mlp_backend == 'plain'
        FM._check_kernel_shape(_split_static(rc))   # K5/K6 would take it
        return
    assert rc.mlp_backend == 'fused'
    assert rc.n_subjects == 1 or route == 'split'
    if route == 'split':
        assert FE.supported_config(rc)
        FM._check_kernel_shape(_split_static(rc))   # K5/K6 take it
    calls = {}
    for module, fn in ((FE, 'encmlp_fwd'), (FE, 'encmlp_dual_fwd'),
                       (FM, 'nerf_mlp_fused')):
        _spy(monkeypatch, module, fn, calls)
    # few samples: the route does not depend on them
    rc = dataclasses.replace(rc, N_samples=8, N_importance=4)
    rest, bones, _, kps, skts, cyls = T.synthetic_pose(
        N_FRAMES, ext_scale=cfg.ext_scale)
    b = T.to_device(T.synthetic_batch(4, N_FRAMES, kps, skts, bones, cyls),
                    'cpu')
    params = t_init(torch.Generator().manual_seed(0), rc, cfg)
    with torch.inference_mode():
        out = trc.render_rays(rc, params, b['rays_o'], b['rays_d'], 0.0,
                              1.0, {k: b[k] for k in POSE_KEYS},
                              t_embed_state(cfg, rc, 0),
                              cam_idxs=b['cam_idxs'])
    assert all(torch.isfinite(out[k]).all() for k in MAPS if k in out)
    if route == 'fused' and rc.single_net:
        assert calls == {'encmlp_fwd': 2}
    elif route == 'fused':
        assert calls == {'encmlp_dual_fwd': 1, 'encmlp_fwd': 1}
    else:
        assert calls == {'nerf_mlp_fused': 2 if rc.single_net else 3}


# one encoder type of the rest of the grammar each, over the flagship
# recipe (reldist / reldir / relray); kp 'cat' and 'querypts' without
# cutoff windows, which their encodings do not fit (anerf_tpu raises)
GRAMMAR = {'relpos': dict(kp_dist_type='relpos'),
           'cat': dict(kp_dist_type='cat', use_cutoff=False),
           'querypts': dict(kp_dist_type='querypts', use_cutoff=False),
           'rayangle': dict(view_type='rayangle'),
           'world': dict(view_type='world'),
           'axisang': dict(bone_type='axisang'),
           'normalize_cutoff': dict(normalize_cutoff=True)}


@pytest.mark.parametrize('name', sorted(GRAMMAR))
def test_grammar_route(name, monkeypatch):
    """Every encoder type outside the fused encode (and
    ``normalize_cutoff``) takes the plain encode and the split kernels on
    the fused backend: K5's wrapper three times a render and K6's three
    times its backward, K1-K4's never; K5/K6 take the trunk width."""
    cfg = T.surreal_config(compute_dtype='bfloat16', **GRAMMAR[name])
    rc = t_build(cfg, n_framecodes=N_FRAMES)
    assert rc.mlp_backend == 'fused' and not FE.kernel_shape_ok(rc)
    FM._check_kernel_shape(_split_static(rc))
    calls = {}
    for module, fn in ((FE, 'encmlp_fwd'), (FE, 'encmlp_dual_fwd'),
                       (FE, 'encmlp_bwd'), (FE, 'encmlp_dual_bwd'),
                       (FM, 'mlp_fwd'), (FM, 'mlp_bwd')):
        _spy(monkeypatch, module, fn, calls)
    rc = dataclasses.replace(rc, N_samples=8, N_importance=4)
    _, bones, _, kps, skts, cyls = T.synthetic_pose(N_FRAMES)
    b = T.to_device(T.synthetic_batch(4, N_FRAMES, kps, skts, bones, cyls),
                    'cpu')
    params = t_init(torch.Generator().manual_seed(0), rc, cfg)
    for leaf in tree_leaves([params['coarse'], params['fine']]):
        leaf.requires_grad_(True)
    out = trc.render_rays(rc, params, b['rays_o'], b['rays_d'], 0.0, 1.0,
                          {k: b[k] for k in POSE_KEYS},
                          t_embed_state(cfg, rc, 0), cam_idxs=b['cam_idxs'])
    assert calls == {'mlp_fwd': 3}
    (out['rgb_map'].sum() + out['rgb0'].sum()).backward()
    assert calls == {'mlp_fwd': 3, 'mlp_bwd': 3}
    assert params['fine']['pts_linears'][0]['w'].grad is not None


def test_surreal_single_fused_matches_jax():
    """surreal_single's recipe (one net, 96 + 48 samples, no view PE
    bands) through the port's fused backend, which takes K1's twin on
    both passes (with viewfac on the coarse pass, where the gate takes
    it), against anerf_tpu's XLA path on the same parameters and pinned
    samples, at the render tests' bar (1e-3 x the reference map's
    max)."""
    path = os.path.join(CONFIGS, 'surreal_single.txt')
    R = 8
    j_cfg, t_cfg = j_load_config(path), load_config(path)
    _, bones, _, kps, skts, cyls = T.synthetic_pose(N_FRAMES)
    b = T.synthetic_batch(R, N_FRAMES, kps, skts, bones, cyls)
    j_rc = dataclasses.replace(j_build(j_cfg, n_framecodes=N_FRAMES),
                               mlp_backend='xla')
    t_rc = t_build(t_cfg, n_framecodes=N_FRAMES)
    assert t_rc.mlp_backend == 'fused' and FE.kernel_shape_ok(t_rc)
    j_params = j_init(jax.random.PRNGKey(0), j_rc, j_cfg)
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
        j_embed_state(j_cfg, j_rc, 500), cam_idxs=jnp.asarray(b['cam_idxs']),
        fixed={k: jnp.asarray(v) for k, v in fixed.items()})
    tb = T.to_device(b, 'cpu')
    with torch.inference_mode():
        got = trc.render_rays(
            t_rc, t_params, tb['rays_o'], tb['rays_d'], 0.0, 1.0,
            {k: tb[k] for k in POSE_KEYS}, t_embed_state(t_cfg, t_rc, 500),
            cam_idxs=tb['cam_idxs'],
            fixed={k: torch.as_tensor(v) for k, v in fixed.items()})
    for k in MAPS:
        _close(ref[k], got[k])


@pytest.mark.parametrize('bands', [FE.F_MAX, FE.F_MAX + 1])
def test_kp_band_cap_matches_jax(bands):
    """surreal.txt at the kp band cap F_MAX, which the fused backend runs
    on K1/K2's twins (the double-angle band recurrence), and one band
    past it, which it runs on the plain encode (exact sines) and K5's
    twin, against anerf_tpu's XLA path (exact sines) on the same
    parameters and pinned samples, at the render tests' bar (1e-3 x the
    reference map's max)."""
    path = os.path.join(CONFIGS, 'surreal.txt')
    R = 8
    j_cfg = j_load_config(path, multires=bands)
    t_cfg = load_config(path, multires=bands)
    _, bones, _, kps, skts, cyls = T.synthetic_pose(N_FRAMES)
    b = T.synthetic_batch(R, N_FRAMES, kps, skts, bones, cyls)
    j_rc = dataclasses.replace(j_build(j_cfg, n_framecodes=N_FRAMES),
                               mlp_backend='xla')
    t_rc = t_build(t_cfg, n_framecodes=N_FRAMES)
    assert t_rc.mlp_backend == 'fused'
    assert FE.kernel_shape_ok(t_rc) == (bands <= FE.F_MAX)
    j_params = j_init(jax.random.PRNGKey(0), j_rc, j_cfg)
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
        j_embed_state(j_cfg, j_rc, 500), cam_idxs=jnp.asarray(b['cam_idxs']),
        fixed={k: jnp.asarray(v) for k, v in fixed.items()})
    tb = T.to_device(b, 'cpu')
    with torch.inference_mode():
        got = trc.render_rays(
            t_rc, t_params, tb['rays_o'], tb['rays_d'], 0.0, 1.0,
            {k: tb[k] for k in POSE_KEYS}, t_embed_state(t_cfg, t_rc, 500),
            cam_idxs=tb['cam_idxs'],
            fixed={k: torch.as_tensor(v) for k, v in fixed.items()})
    for k in MAPS:
        _close(ref[k], got[k])


def _deep_port(t_rc, t_cfg, j_params, tb, fixed, loss):
    """The port's maps and gradients of ``loss`` with respect to every
    parameter (a torch copy of ``j_params``) through ``render_rays``."""
    t_params = jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32), requires_grad=True),
        jax.tree_util.tree_map(np.asarray, j_params))
    got = trc.render_rays(
        t_rc, t_params, tb['rays_o'], tb['rays_d'], 0.0, 1.0,
        {k: tb[k] for k in POSE_KEYS}, t_embed_state(t_cfg, t_rc, 500),
        cam_idxs=tb['cam_idxs'],
        fixed={k: torch.as_tensor(v) for k, v in fixed.items()})
    leaves = jax.tree_util.tree_leaves(t_params)
    grads = torch.autograd.grad(loss(got), leaves, allow_unused=True)
    return got, [np.zeros(a.shape, np.float32) if g is None else g.numpy()
                 for a, g in zip(leaves, grads)]


def test_deep_net_fused_matches_jax():
    """surreal.txt at two 24-layer nets (B.1.4's depth row), which the
    fused backend runs on K1-K4's twins, against anerf_tpu's XLA path on
    the same parameters and pinned samples: the maps at the render
    tests' bar (1e-3 x the reference map's max), and the gradients of a
    loss on the maps with respect to every parameter by the rule that
    holds nets past 8 layers (``test_torch_encmlp_shapes_bwd.py``'s
    ``_assert_f64_close``): within the backward bars of
    ``test_torch_fused_bwd.py`` (cosine > 0.9999, norm within 5e-3) or
    within twice the two evaluations' summed distances from the f64
    chain (the port's twins with their products in f64 from the
    encode's own f32 bands, ``chip_smoke._f64_twins(f32_encode=True)``),
    whichever is wider.  There the twins read 0.99998 or closer against
    the f64 chain, anerf_tpu's XLA path 0.99681 on the first layer's
    bias gradient."""
    sys.path.insert(0, os.path.dirname(CONFIGS))
    import chip_smoke
    path = os.path.join(CONFIGS, 'surreal.txt')
    over = dict(netdepth=24, netdepth_fine=24)
    R = 8
    j_cfg, t_cfg = j_load_config(path, **over), load_config(path, **over)
    _, bones, _, kps, skts, cyls = T.synthetic_pose(N_FRAMES)
    b = T.synthetic_batch(R, N_FRAMES, kps, skts, bones, cyls)
    j_rc = dataclasses.replace(j_build(j_cfg, n_framecodes=N_FRAMES),
                               mlp_backend='xla')
    t_rc = t_build(t_cfg, n_framecodes=N_FRAMES)
    assert t_rc.mlp_backend == 'fused' and FE.kernel_shape_ok(t_rc)
    assert FE.kernel_shape(*FE._statics(
        t_rc, t_rc.n_joints, 1, FE.DEFAULT_TILE, True)) == (
            7, 9, False, 24, 256, 16)
    j_params = j_init(jax.random.PRNGKey(0), j_rc, j_cfg)
    rng = np.random.RandomState(7)
    S, I = j_rc.N_samples, j_rc.N_importance
    fixed = {'coarse_u': rng.uniform(size=(R, S)).astype(np.float32),
             'fine_u': rng.uniform(size=(R, I)).astype(np.float32),
             'coarse_noise': rng.normal(size=(R, S)).astype(np.float32),
             'fine_noise': rng.normal(size=(R, S + I)).astype(np.float32)}
    j_est = j_embed_state(j_cfg, j_rc, 500)
    j_pose = {k: jnp.asarray(b[k]) for k in POSE_KEYS}

    def j_maps(prm):
        return jrc.render_rays(
            j_rc, prm, jnp.asarray(b['rays_o']), jnp.asarray(b['rays_d']),
            0.0, 1.0, j_pose, j_est, cam_idxs=jnp.asarray(b['cam_idxs']),
            fixed={k: jnp.asarray(v) for k, v in fixed.items()})

    def loss(out):
        return ((out['rgb_map'] ** 2).mean() + (out['rgb0'] ** 2).mean()
                + (out['acc_map'] ** 2).mean())
    ref = j_maps(j_params)
    g_ref = [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(
        jax.grad(lambda prm: loss(j_maps(prm)))(j_params))]
    tb = T.to_device(b, 'cpu')
    got, grads = _deep_port(t_rc, t_cfg, j_params, tb, fixed, loss)
    for k in MAPS:
        _close(ref[k], got[k].detach())
    with chip_smoke._f64_twins(FE, f32_encode=True):
        _, f64 = _deep_port(t_rc, t_cfg, j_params, tb, fixed, loss)
    assert len(g_ref) == len(grads) == len(f64)
    _assert_f64_close(g_ref, grads, f64, 'netdepth24')
