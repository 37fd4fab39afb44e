"""The in-kernel rigid transform (fuse_tform) of the fused kernels against
anerf_tpu on the CPU.

Under ``rc.fuse_tform`` (and no ray noise) K1-K4 take the sample depths
z (R, S) and each ray's affine rows [A; B] (R, 2, 3J) of ``tform_rows``
in place of the component-major points (n, 3J), and build each point as
``A + z B``; the backward's dp (n, 3J) is contracted into the depths'
and the rows' cotangents by ``_tform_pullback``.  Here:

* ``tform_rows`` against ``pallas_encmlp.tform_rows``, with per-ray
  skts and with one pose broadcast over the rays (the renderer's
  ``expand``): f32 einsum noise, within 1e-6 of the scale;
* ``_apply_tform`` against ``pallas_encmlp._apply_tform`` and the dense
  ``transform_batch_pts_cm`` of the same points: 1e-6 of the scale (the
  affine and the transform of ``o + z d`` reassociate the same sums);
* ``_tform_pullback`` against anerf_tpu's at S = 64 and a ragged 48:
  f32 sums over the samples in another order, within 1e-5 of the scale;
* the plain twins of K1/K2 under fuse_tform, through their autograd
  Functions (whose backwards are K3's and K4's twins and the pullback),
  against ``pallas_encmlp._fused`` / ``_fused_dual`` in interpret mode
  with the same rows and depths, viewfac on and off, with framecodes and
  without: raw rows within 1e-3 of each channel's scale on average and
  2e-2 at the worst point (tests/test_pallas_encmlp.py:53), and the
  depths', the rows', denc's, dcodes' and every weight's gradient at
  cosine > 0.9999 and norm ratio within 5e-3 (:236-237);
* ``render_rays`` with fuse_tform against anerf_tpu's fuse_tform render
  on the same pinned draws: maps within 1e-4 of their scale (anerf_tpu's
  bar between its two forms, tests/test_pallas_encmlp.py:84-104), and
  gradients to the params and to skts at cosine > 0.9999 and norm within
  5e-3 (:106-121; elementwise the bars of test_torch_render_grads.py);
  and against the port's own dense form, maps within 2e-4 of their scale.
  The two forms reassociate the transform's f32 sums (the points differ
  by ~1.8 ulp on average, in both packages alike), which flips a bf16
  rounding of the encode here and there: on this scene and these draws
  anerf_tpu's own two forms differ by 0.88e-4 of rgb_map's scale and the
  port's by 1.2e-4, so 1e-4 holds neither with room;
* the ray-noise gate: with ``ray_noise_std > 0`` fuse_tform renders
  bit-equal to its absence (:124-136);
* the plumbing: ``Config(fuse_tform=True)`` and ``--fuse_tform True``
  reach ``RayCastConfig.fuse_tform``; on the CPU the wrappers under
  fuse_tform take the twins and count no launch, and they refuse
  operands of the wrong form; ``kernel_cost`` counts the depths and rows
  in place of the points.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from test_torch_fused_bwd import _operands, assert_grad_close, scene  # noqa: F401
from test_torch_render_grads import _render_loss_j, _render_loss_t

from anerf_tpu.models import raycaster as jrc
from anerf_tpu.models.factory import embed_state as j_embed_state
from anerf_tpu.ops import pallas_encmlp as PE

from anerf_torch import testing_utils as T
from anerf_torch.models import raycaster as trc
from anerf_torch.models.factory import build_raycast_config
from anerf_torch.models.factory import embed_state as t_embed_state
from anerf_torch.ops import encoders as TX
from anerf_torch.ops import fused_encmlp as FE
from anerf_torch.utils.config import Config, config_from_cli

from test_torch_threads import one_torch_thread  # noqa: F401

J = 24
ROWS_TOL = 1e-6     # tform_rows, _apply_tform: f32 einsum noise
PULL_TOL = 1e-5     # _tform_pullback: f32 sums over S in another order
MAP_TOL = 1e-4      # rendered maps, fuse_tform against anerf_tpu's
FORMS_TOL = 2e-4    # rendered maps, fuse_tform against the dense form


def _close(ref, got, tol, name=''):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape, (name, ref.shape, got.shape)
    scale = np.abs(ref).max()
    assert scale > 0, name
    err = np.abs(ref - got).max() / scale
    assert err < tol, (name, err)


def _depths(R, S, seed=3):
    """Sorted depths (R, S) in [0.2, 1.5], each ray its own."""
    rng = np.random.RandomState(seed)
    return np.sort(rng.uniform(0.2, 1.5, (R, S)), -1).astype(np.float32)


def _rows(batch, skts=None):
    skts = batch['skts'] if skts is None else skts
    return np.asarray(PE.tform_rows(jnp.asarray(skts),
                                    jnp.asarray(batch['rays_o']),
                                    jnp.asarray(batch['rays_d'])))


@pytest.mark.parametrize('broadcast', [False, True])
def test_tform_rows_match_pallas_encmlp(scene, broadcast):
    """Per-ray skts, and one pose broadcast over every ray as the renderer
    passes it (``expand``, stride 0 over the rays)."""
    b = scene['batch']
    R = b['rays_o'].shape[0]
    skts = b['skts']
    skts_t = torch.as_tensor(skts)
    if broadcast:
        skts = np.broadcast_to(skts[:1], skts.shape).copy()
        skts_t = torch.as_tensor(skts[:1]).expand(R, J, 4, 4)
    got = FE.tform_rows(skts_t, torch.as_tensor(b['rays_o']),
                        torch.as_tensor(b['rays_d']))
    assert got.shape == (R, 2, 3 * J) and got.dtype == torch.float32
    ref = _rows(b, skts)
    _close(ref[:, 0], got[:, 0], ROWS_TOL, 'A')
    _close(ref[:, 1], got[:, 1], ROWS_TOL, 'B')


def test_apply_tform_is_the_transform(scene):
    """A + z B against anerf_tpu's in-kernel affine and against the
    dense transform of the points o + z d."""
    b = scene['batch']
    R, S = b['rays_o'].shape[0], 16
    z = _depths(R, S)
    tf = _rows(b)
    got = FE._apply_tform(torch.as_tensor(tf), torch.as_tensor(z))
    est = PE.EncStatic(J=J, kp_freqs=(1.,), view_nb=9, S=S, rpt=R,
                       has_codes=False, fuse_tform=True)
    ref = PE._apply_tform(est, jnp.asarray(tf[:, 0]), jnp.asarray(tf[:, 1]),
                          jnp.asarray(z))
    _close(ref, got, ROWS_TOL, 'against pallas_encmlp')
    pts = b['rays_o'][:, None] + b['rays_d'][:, None] * z[..., None]
    dense = TX.transform_batch_pts_cm(torch.as_tensor(pts),
                                      torch.as_tensor(b['skts']))
    _close(dense.reshape(R * S, 3 * J), got, ROWS_TOL, 'against dense')


@pytest.mark.parametrize('S', [64, 48])
def test_tform_pullback_matches_pallas_encmlp(S):
    rng = np.random.RandomState(S)
    R = 8
    tf = rng.normal(size=(R, 2, 3 * J)).astype(np.float32)
    z = _depths(R, S)
    dp = rng.normal(size=(R * S, 3 * J)).astype(np.float32)
    g_z_j, g_ab_j = PE._tform_pullback(jnp.asarray(tf), jnp.asarray(z),
                                       jnp.asarray(dp))
    g_z, g_ab = FE._tform_pullback(torch.as_tensor(tf), torch.as_tensor(z),
                                   torch.as_tensor(dp))
    assert g_z.shape == (R, S) and g_ab.shape == (R, 2, 3 * J)
    _close(g_z_j, g_z, PULL_TOL, 'g_z')
    _close(g_ab_j[:, 0], g_ab[:, 0], PULL_TOL, 'g_A')
    _close(g_ab_j[:, 1], g_ab[:, 1], PULL_TOL, 'g_B')


def _tf_operands(sc, S, codes, viewfac):
    """The fuse_tform operands for both packages: (jax, torch) tuples of
    (st, est, z, enc, codes list, cutoff, tau, flats, rows), the codes
    and flats as ``_operands`` makes them."""
    sc = dict(sc, j_rc=dataclasses.replace(sc['j_rc'], viewfac=viewfac),
              t_rc=dataclasses.replace(sc['t_rc'], viewfac=viewfac))
    jops, tops = _operands(sc, S, codes)
    b = sc['batch']
    R = b['rays_o'].shape[0]
    z, tf = _depths(R, S), _rows(b)
    cam = b['cam_idxs'] if codes else None
    tau = 21.9
    st_j, est_j, z_j, enc_j, cut_j, tau_j = PE._build_call(
        sc['j_rc'], None, jnp.asarray(sc['rays_t_norm']),
        sc['j_params']['cutoff_dist'], tau,
        None if cam is None else jnp.asarray(cam), True, None,
        tf_rows=jnp.asarray(tf), z_vals=jnp.asarray(z))
    st_t, est_t, z_t, enc_t, cut_t, tau_t = FE._build_call(
        sc['t_rc'], None, torch.as_tensor(sc['rays_t_norm']),
        sc['t_params']['cutoff_dist'], tau,
        None if cam is None else torch.as_tensor(cam), None,
        tf_rows=torch.as_tensor(tf), z_vals=torch.as_tensor(z))
    assert est_j.fuse_tform and est_t.fuse_tform
    assert est_t.viewfac == est_j.viewfac == (viewfac and S == 64)
    assert st_t == tops[0] and z_t.shape == (R, S)
    return ((st_j, est_j, z_j, enc_j, jops[4], cut_j, tau_j, jops[7],
             jnp.asarray(tf)),
            (st_t, est_t, z_t, enc_t, tops[4], cut_t, tau_t, tops[7],
             torch.as_tensor(tf)))


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


def _assert_raw_close(ref, got):
    ref, got = np.asarray(ref), got.detach().numpy()
    assert ref.shape == got.shape
    for c in range(ref.shape[0]):
        scale = np.abs(ref[c]).max()
        d = np.abs(ref[c] - got[c])
        assert d.mean() < 1e-3 * scale and d.max() < 2e-2 * scale, (
            c, d.mean() / scale, d.max() / scale)


@pytest.mark.parametrize('nnet,S,viewfac,codes', [
    (2, 64, True, True), (2, 64, False, False), (1, 16, False, True),
    (1, 64, True, False)])
def test_encmlp_fuse_tform_matches_pallas_interpret(scene, nnet, S, viewfac,
                                                     codes):
    """K2's (nnet 2) and K1's twins under fuse_tform, forward and backward
    (K4's / K3's twins and the pullback), against anerf_tpu's Pallas
    kernels in interpret mode under fuse_tform."""
    jops, tops = _tf_operands(scene, S, codes, viewfac)
    st_j, est_j, z_j, enc_j, c_j, cut_j, tau_j, f_j, tf_j = jops
    st_t, est_t, z_t, enc_t, c_t, cut_t, tau_t, f_t, tf_t = tops
    n = z_j.size
    g = np.random.RandomState(7).normal(size=(nnet, 4, n)).astype(np.float32)
    if nnet == 2:
        fn = lambda z, e, tf, cc, cf, fc, ff: PE._fused_dual(
            st_j, est_j, z, e, tf, cc, cf, cut_j, tau_j, fc, ff)
        raw_j, vjp = jax.vjp(fn, z_j, enc_j, tf_j, c_j[0], c_j[1], f_j[0],
                             f_j[1])
        dz, denc, dtf, dcc, dcf, dfc, dff = vjp((jnp.asarray(g[0]),
                                                 jnp.asarray(g[1])))
        ref = [dz, denc, dtf] + ([dcc, dcf] if codes else []) + dfc + dff
    else:
        fn = lambda z, e, tf, c, f: (PE._fused(st_j, est_j, z, e, tf, c,
                                               cut_j, tau_j, f),)
        raw_j, vjp = jax.vjp(fn, z_j, enc_j, tf_j, c_j[1], f_j[1])
        dz, denc, dtf, dc, df = vjp((jnp.asarray(g[0]),))
        ref = [dz, denc, dtf] + ([dc] if codes else []) + df

    z, enc, tf = _leaf(z_t), _leaf(enc_t), _leaf(tf_t)
    cs = [None if c is None else _leaf(c) for c in c_t]
    flats = [[_leaf(w) for w in f] for f in f_t]
    if nnet == 2:
        outs = FE.encmlp_dual_fwd(st_t, est_t, z, enc, cs[0], cs[1], cut_t,
                                  tau_t, flats[0], flats[1], tf=tf)
        ins = [z, enc, tf] + (cs if codes else []) + flats[0] + flats[1]
    else:
        outs = (FE.encmlp_fwd(st_t, est_t, z, enc, cs[1], cut_t, tau_t,
                              flats[1], tf=tf),)
        ins = [z, enc, tf] + ([cs[1]] if codes else []) + flats[1]
    for a, b in zip(raw_j, outs):
        _assert_raw_close(a, b)
    got = torch.autograd.grad(outs, ins, [torch.as_tensor(x) for x in g])
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert b.dtype == ins[i].dtype and b.shape == ins[i].shape, i
        assert_grad_close(np.asarray(a, np.float32), b.float().numpy(),
                          name=f'operand {i}', elementwise=False)


def _fixed(R=8, S=64, Si=16):
    rng = np.random.RandomState(5)
    return {'coarse_u': rng.uniform(size=(R, S)).astype(np.float32),
            'fine_u': np.sort(rng.uniform(size=(R, Si)), -1)
            .astype(np.float32),
            'coarse_noise': rng.normal(size=(R, S)).astype(np.float32),
            'fine_noise': rng.normal(size=(R, S + Si)).astype(np.float32)}


def _t_render(sc, fuse_tform, **over):
    """The port's fused ``render_rays`` maps and the gradients of
    ``_render_loss_t`` to (params leaves..., skts), draws pinned."""
    b = sc['batch']
    pose = {k: torch.as_tensor(b[k]) for k in ('kps', 'skts', 'bones',
                                                'cyls')}
    rc = dataclasses.replace(sc['t_rc'], mlp_backend='fused',
                             fuse_tform=fuse_tform, **over)
    params = jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32), requires_grad=True),
        jax.tree_util.tree_map(np.asarray, sc['j_params']))
    skts = torch.tensor(b['skts'], requires_grad=True)
    tb = T.to_device(b, 'cpu')
    fx = {k: torch.as_tensor(v) for k, v in _fixed().items()}
    est = t_embed_state(sc['cfg'], rc, 2000)
    with torch.no_grad():
        out = trc.render_rays(rc, params, tb['rays_o'], tb['rays_d'], 0.,
                              1., pose, est, cam_idxs=tb['cam_idxs'],
                              fixed=fx)
    loss = _render_loss_t(rc, params, tb, est, pose, skts, fx)
    leaves = jax.tree_util.tree_leaves(params) + [skts]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return ({k: v.numpy() for k, v in out.items()
             if k in ('rgb_map', 'acc_map', 'rgb0', 'acc0', 'disp_map')},
            grads)


def test_render_rays_fuse_tform_matches_dense(scene):
    """The port's two forms on the same draws: the maps within FORMS_TOL
    of their scale, and not bit-equal (the form engaged)."""
    maps_d, _ = _t_render(scene, False)
    maps_f, _ = _t_render(scene, True)
    assert any(not np.array_equal(maps_d[k], maps_f[k])
               for k in ('rgb_map', 'rgb0')), 'fuse_tform did not engage'
    for k, ref in maps_d.items():
        scale = np.abs(ref).max() + 1e-6
        assert np.abs(ref - maps_f[k]).max() < FORMS_TOL * scale, k


def test_render_rays_fuse_tform_matches_jax(scene):
    """The maps and the gradients to the params and skts of the fused
    render under fuse_tform against anerf_tpu's Pallas backend under
    fuse_tform, the same pinned draws (both on the dense views input, as
    the scene holds them)."""
    b = scene['batch']
    cfg = scene['cfg']
    j_rc = dataclasses.replace(scene['j_rc'], mlp_backend='pallas',
                               fuse_tform=True)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    pose = {k: jnp.asarray(b[k]) for k in ('kps', 'skts', 'bones', 'cyls')}
    fixed = {k: jnp.asarray(v) for k, v in _fixed().items()}
    j_est = j_embed_state(cfg, j_rc, 2000)
    out_j = jrc.render_rays(j_rc, scene['j_params'], jb['rays_o'],
                            jb['rays_d'], 0., 1., pose, j_est,
                            cam_idxs=jb['cam_idxs'], fixed=fixed)
    g_ref = jax.grad(lambda prm, sk: _render_loss_j(
        j_rc, prm, jb, j_est, pose, sk, fixed), argnums=(0, 1))(
            scene['j_params'], jnp.asarray(b['skts']))
    maps, grads = _t_render(scene, True)
    for k, got in maps.items():
        ref = np.asarray(out_j[k])
        scale = np.abs(ref).max() + 1e-6
        assert np.abs(ref - got).max() < MAP_TOL * scale, k
    leaves_j = jax.tree_util.tree_leaves(g_ref[0]) + [g_ref[1]]
    assert len(leaves_j) == len(grads)
    for i, (a, gt) in enumerate(zip(leaves_j, grads)):
        gt = torch.zeros(a.shape) if gt is None else gt
        assert_grad_close(np.asarray(a, np.float32), gt.numpy(),
                          name=f'leaf {i}', mean_tol=2e-3)
    assert np.abs(np.asarray(g_ref[1])).max() > 0   # skts got a gradient


def test_ray_noise_gate(scene):
    """Ray noise moves the points off their rays: fuse_tform then renders
    bit-equal to its absence, from the same generator; without the
    noise it engages."""
    b = T.to_device(scene['batch'], 'cpu')
    pose = {k: b[k] for k in ('kps', 'skts', 'bones', 'cyls')}
    params = scene['t_params']
    est = t_embed_state(scene['cfg'], scene['t_rc'], 2000)

    def render(**over):
        rc = dataclasses.replace(scene['t_rc'], mlp_backend='fused', **over)
        with torch.no_grad():
            return trc.render_rays(rc, params, b['rays_o'], b['rays_d'], 0.,
                                   1., pose, est, cam_idxs=b['cam_idxs'],
                                   generator=torch.Generator().manual_seed(0))
    a = render(ray_noise_std=0.01)
    c = render(ray_noise_std=0.01, fuse_tform=True)
    for k in ('rgb_map', 'acc_map', 'rgb0'):
        assert torch.equal(a[k], c[k]), k
    a, c = render(), render(fuse_tform=True)
    assert not torch.equal(a['rgb_map'], c['rgb_map'])


def test_config_reaches_raycaster():
    assert not Config().fuse_tform
    for cfg in (T.surreal_config(fuse_tform=True),
                config_from_cli(['--fuse_tform', 'True'])):
        assert cfg.fuse_tform
        rc = build_raycast_config(cfg, n_framecodes=4)
        assert rc.fuse_tform and rc.eval_variant().fuse_tform
    assert not build_raycast_config(T.surreal_config(),
                                    n_framecodes=4).fuse_tform


def test_tf_wrappers_take_twins_on_cpu(scene):
    _, tops = _tf_operands(scene, 64, True, True)
    st, est, z, enc, codes, cutoff, tau, flats, tf = tops
    FE.reset_launch_counts()
    one = FE.encmlp_fwd(st, est, z, enc, codes[1], cutoff, tau, flats[1],
                        tf=tf)
    two = FE.encmlp_dual_fwd(st, est, z, enc, *codes, cutoff, tau, *flats,
                             tf=tf)
    g = torch.ones((4, z.numel()))
    back = FE.encmlp_bwd(st, est, z, enc, codes[1], cutoff, tau, flats[1], g,
                         tf=tf)
    assert set(FE.launch_counts().values()) == {0}
    twin = FE.encmlp_fwd_plain(st, est, z, enc, codes[1], cutoff, tau,
                               flats[1], tf)
    assert torch.equal(one, twin) and torch.equal(two[1], twin)
    ref = FE.encmlp_bwd_plain(st, est, z, enc, codes[1], cutoff, tau,
                              flats[1], g, tf)
    assert back[0].shape == (z.numel(), 3 * J)
    assert torch.equal(back[0], ref[0]) and torch.equal(back[1], ref[1])
    dense = FE.encmlp_fwd_plain(st, dataclasses.replace(est, fuse_tform=False),
                                FE._apply_tform(tf, z), enc, codes[1],
                                cutoff, tau, flats[1])
    assert torch.equal(twin, dense)
    with pytest.raises(ValueError):     # the depths of another S
        FE.encmlp_fwd(st, est, z[:, :32].contiguous(), enc, codes[1], cutoff,
                      tau, flats[1], tf=tf)
    with pytest.raises(ValueError):     # no rows
        FE.encmlp_fwd(st, est, z, enc, codes[1], cutoff, tau, flats[1])


def test_kernel_cost_counts_depths_and_rows(scene):
    _, tops = _tf_operands(scene, 64, True, True)
    st, est = tops[:2]
    R, S, n = 2048, 64, 2048 * 64
    for backward in (False, True):
        d = FE.kernel_cost(st, dataclasses.replace(est, fuse_tform=False), n,
                           2, backward)
        f = FE.kernel_cost(st, est, n, 2, backward)
        assert f['bytes'] == d['bytes'] - n * 3 * J * 4 + R * (S + 6 * J) * 4
        assert f['bf16_flops'] == d['bf16_flops']
        assert f['f32_flops'] == d['f32_flops'] + (2 if backward else 1) \
            * 6 * n * J
