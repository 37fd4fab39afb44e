"""The backward of the fused encode+MLP kernels (K3, K4) against
anerf_tpu on the CPU.

* the plain twins of K3/K4, reached through the port's
  ``torch.autograd.Function`` around K1/K2 on CPU tensors, against
  ``jax.vjp`` of the Pallas custom_vjp (``_fused``/``_fused_dual``, run
  in interpret mode as tests/test_pallas_encmlp.py runs it, with
  viewfac off) on the same operands and the same raw cotangent: dp,
  denc, dcodes and the gradient of every ``flatten_params_cm`` operand;
* the same with viewfac on both sides (K4's and K3's twins at S=64
  without framecodes; cosine and norm ratio, the bars of
  test_torch_viewfac.py);
* the backward kernels' gradient layout (``_grad_layout``,
  ``_pack_bwd_weights``) against the flatten order.

``test_torch_render_grads.py`` holds the gradients of the whole fused
``render_rays`` to the same bars.

Bars.  Both sides run the same bf16 chain, so the gradients agree in
direction as anerf_tpu's two backward implementations agree with each
other (tests/test_pallas_encmlp.py:236-237): cosine > 0.9999 and norm
ratio within 5e-3.  Elementwise, a bf16 rounding flip of one cotangent
between layers (the f32 sums run in another order) moves single
elements by a bf16 ulp of that cotangent, so each leaf must agree
within 1e-3 x its max |value| on average and 5e-2 x at its worst
element (measured at most 8.2e-5 and 6.5e-3 at R=8).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anerf_tpu.models.factory import build_raycast_config as j_build
from anerf_tpu.models.factory import init_raycaster_params as j_init
from anerf_tpu.models.nerf_mlp import framecode_select as j_codes
from anerf_tpu.ops import encoders as JX
from anerf_tpu.ops import pallas_encmlp as PE

from anerf_torch import testing_utils as T
from anerf_torch.interop import params_from_numpy
from anerf_torch.models.factory import build_raycast_config as t_build
from anerf_torch.ops import fused_encmlp as FE
from anerf_torch.ops import fused_mlp as FM

from test_torch_threads import one_torch_thread  # noqa: F401

J = 24
COS_TOL = 1e-4
RATIO_TOL = 5e-3
MEAN_TOL = 1e-3
MAX_TOL = 5e-2


def assert_grad_close(ref, got, name='', cos_tol=COS_TOL,
                      ratio_tol=RATIO_TOL, elementwise=True,
                      mean_tol=MEAN_TOL):
    a = np.asarray(ref, np.float64).ravel()
    b = np.asarray(got, np.float64).ravel()
    assert a.shape == b.shape, (name, a.shape, b.shape)
    na = np.linalg.norm(a)
    if na < 1e-12:
        assert np.linalg.norm(b) < 1e-9, name
        return
    cos = a @ b / (na * np.linalg.norm(b) + 1e-30)
    assert cos > 1 - cos_tol, (name, cos)
    assert abs(np.linalg.norm(b) / na - 1) < ratio_tol, name
    if elementwise:
        d = np.abs(a - b) / np.abs(a).max()
        assert d.mean() < mean_tol and d.max() < MAX_TOL, (name, d.mean(),
                                                            d.max())


@pytest.fixture(scope='module')
def scene():
    cfg = T.surreal_config(N_rand=8, compute_dtype='bfloat16')
    _, bones, _, kps, skts, cyls = T.synthetic_pose(4)
    batch = T.synthetic_batch(8, 4, kps, skts, bones, cyls)
    j_rc = dataclasses.replace(j_build(cfg, n_framecodes=4), viewfac=False)
    j_params = j_init(jax.random.PRNGKey(0), j_rc, cfg)
    # both dense (the port runs viewfac where the gate picks it, as
    # anerf_tpu does; the factorized chain: test_bwd_twins_match_pallas_
    # vjp_viewfac and test_torch_viewfac.py)
    t_rc = dataclasses.replace(t_build(cfg, n_framecodes=4), viewfac=False)
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        j_params))
    rays_t = JX.transform_batch_rays(jnp.asarray(batch['rays_d'])[:, None],
                                     jnp.asarray(batch['skts']))
    rays_t_norm = np.asarray(JX.vec_norm(rays_t)[:, 0])
    return dict(cfg=cfg, batch=batch, j_rc=j_rc, j_params=j_params,
                t_rc=t_rc, t_params=t_params, rays_t_norm=rays_t_norm,
                kps=kps, skts=skts, bones=bones, cyls=cyls)


def _pts_cm(batch, S):
    z = np.linspace(0.2, 1.5, S, dtype=np.float32)
    pts = batch['rays_o'][:, None] + batch['rays_d'][:, None] * z[:, None]
    return np.asarray(JX.transform_batch_pts_cm(jnp.asarray(pts),
                                                jnp.asarray(batch['skts'])))


def _operands(scene, S, codes=True):
    """The same kernel operands for both packages: (jax, torch) tuples
    of (st, est, p, enc, codes list, cutoff, tau, flats)."""
    pts = _pts_cm(scene['batch'], S)
    cam = scene['batch']['cam_idxs'] if codes else None
    tau = 21.9
    st_j, est_j, p_j, enc_j, cut_j, tau_j = PE._build_call(
        scene['j_rc'], jnp.asarray(pts), jnp.asarray(scene['rays_t_norm']),
        scene['j_params']['cutoff_dist'], tau,
        None if cam is None else jnp.asarray(cam), True, None, cm=True)
    st_t, est_t, p_t, enc_t, cut_t, tau_t = FE._build_call(
        scene['t_rc'], torch.as_tensor(pts),
        torch.as_tensor(scene['rays_t_norm']),
        scene['t_params']['cutoff_dist'], tau,
        None if cam is None else torch.as_tensor(cam), None)
    nets = ('coarse', 'fine')
    jp, tp = scene['j_params'], scene['t_params']
    if codes:
        c_j = [j_codes(jp[k]['framecodes'], jnp.asarray(cam)).astype(
            jnp.float32) for k in nets]
        c_t = [FE._codes(tp[k], torch.as_tensor(cam)) for k in nets]
    else:
        R = p_j.shape[0] // S
        c_j = [jnp.zeros((R, 0))] * 2
        c_t = [None, None]
        strip = lambda p: dict(p, views_linear={
            'w': p['views_linear']['w'][:-scene['cfg'].framecode_size],
            'b': p['views_linear']['b']})
        jp = {k: strip(jp[k]) for k in nets}
        tp = {k: strip(tp[k]) for k in nets}
    f_j = [PE.flatten_params_cm(jp[k], st_j, J, est_j.view_nb) for k in nets]
    f_t = [FE.flatten_params_cm(tp[k], st_t, J, est_t.view_nb)
           for k in nets]
    return ((st_j, est_j, p_j, enc_j, c_j, cut_j, tau_j, f_j),
            (st_t, est_t, p_t, enc_t, c_t, cut_t, tau_t, f_t))


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


@pytest.mark.parametrize('S,nnet,codes', [(64, 2, True), (16, 1, True),
                                          (64, 2, False)])
def test_bwd_twins_match_pallas_vjp(scene, S, nnet, codes):
    """K4's twin at S=64 (the coarse samples), K3's at S=16 (the fine
    pass), and K4 without framecodes."""
    jops, tops = _operands(scene, S, codes)
    st_j, est_j, p_j, enc_j, c_j, cut_j, tau_j, f_j = jops
    st_t, est_t, p_t, enc_t, c_t, cut_t, tau_t, f_t = tops
    n = p_j.shape[0]
    g = np.random.RandomState(3).normal(size=(nnet, 4, n)).astype(np.float32)
    tf = jnp.zeros((1, 1), jnp.float32)
    if nnet == 2:
        fn = lambda p, e, cc, cf, fc, ff: PE._fused_dual(
            st_j, est_j, p, e, tf, cc, cf, cut_j, tau_j, fc, ff)
        _, vjp = jax.vjp(fn, p_j, enc_j, c_j[0], c_j[1], f_j[0], f_j[1])
        dp, denc, dcc, dcf, dfc, dff = vjp((jnp.asarray(g[0]),
                                            jnp.asarray(g[1])))
        ref = [dp, denc] + ([dcc, dcf] if codes else []) + dfc + dff
    else:
        fn = lambda p, e, c, f: PE._fused(st_j, est_j, p, e, tf, c, cut_j,
                                          tau_j, f)
        _, vjp = jax.vjp(fn, p_j, enc_j, c_j[1], f_j[1])
        dp, denc, dc, df = vjp(jnp.asarray(g[0]))
        ref = [dp, denc, dc] + df

    p, enc = _leaf(p_t), _leaf(enc_t)
    cs = [None if c is None else _leaf(c) for c in c_t]
    flats = [[_leaf(w) for w in f] for f in f_t]
    if nnet == 2:
        outs = FE.encmlp_dual_fwd(st_t, est_t, p, enc, cs[0], cs[1], cut_t,
                                  tau_t, flats[0], flats[1])
        ins = [p, enc] + (cs if codes else []) + flats[0] + flats[1]
    else:
        outs = (FE.encmlp_fwd(st_t, est_t, p, enc, cs[1], cut_t, tau_t,
                              flats[1]),)
        ins = [p, enc, cs[1]] + flats[1]
    got = torch.autograd.grad(outs, ins, [torch.as_tensor(x) for x in g])
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert b.dtype == ins[i].dtype, i     # bf16 weights, f32 biases
        assert_grad_close(np.asarray(a, np.float32), b.float().numpy(),
                          name=f'operand {i}')


@pytest.mark.parametrize('nnet', [2, 1])
def test_bwd_twins_match_pallas_vjp_viewfac(scene, nnet):
    """K4's and K3's twins with viewfac (the coarse samples, S=64, where
    the gate takes it) against the Pallas custom_vjps with viewfac, both
    without framecodes; the cases with them: test_torch_viewfac.py."""
    vf = dict(scene, j_rc=dataclasses.replace(scene['j_rc'], viewfac=True),
              t_rc=dataclasses.replace(scene['t_rc'], viewfac=True))
    jops, tops = _operands(vf, 64, codes=False)
    st_j, est_j, p_j, enc_j, c_j, cut_j, tau_j, f_j = jops
    st_t, est_t, p_t, enc_t, c_t, cut_t, tau_t, f_t = tops
    assert est_j.viewfac and est_t.viewfac
    n = p_j.shape[0]
    g = np.random.RandomState(8).normal(size=(nnet, 4, n)).astype(np.float32)
    tf = jnp.zeros((1, 1), jnp.float32)
    if nnet == 2:
        fn = lambda p, e, fc, ff: PE._fused_dual(
            st_j, est_j, p, e, tf, c_j[0], c_j[1], cut_j, tau_j, fc, ff)
        _, vjp = jax.vjp(fn, p_j, enc_j, f_j[0], f_j[1])
        dp, denc, dfc, dff = vjp((jnp.asarray(g[0]), jnp.asarray(g[1])))
        ref = [dp, denc] + dfc + dff
    else:
        fn = lambda p, e, f: PE._fused(st_j, est_j, p, e, tf, c_j[1], cut_j,
                                       tau_j, f)
        _, vjp = jax.vjp(fn, p_j, enc_j, f_j[1])
        dp, denc, df = vjp(jnp.asarray(g[0]))
        ref = [dp, denc] + df
    p, enc = _leaf(p_t), _leaf(enc_t)
    flats = [[_leaf(w) for w in f] for f in f_t]
    if nnet == 2:
        outs = FE.encmlp_dual_fwd(st_t, est_t, p, enc, None, None, cut_t,
                                  tau_t, flats[0], flats[1])
        ins = [p, enc] + flats[0] + flats[1]
    else:
        outs = (FE.encmlp_fwd(st_t, est_t, p, enc, None, cut_t, tau_t,
                              flats[1]),)
        ins = [p, enc] + flats[1]
    got = torch.autograd.grad(outs, ins, [torch.as_tensor(x) for x in g])
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert b.dtype == ins[i].dtype, i
        assert_grad_close(np.asarray(a, np.float32), b.float().numpy(),
                          name=f'operand {i}', elementwise=False)


def test_bwd_wrappers_take_twins_on_cpu(scene):
    _, tops = _operands(scene, 16)
    st, est, p, enc, cs, cut, tau, flats = tops
    g = torch.as_tensor(np.random.RandomState(4).normal(
        size=(2, 4, p.shape[0])).astype(np.float32))
    FE.reset_launch_counts()
    one = FE.encmlp_bwd(st, est, p, enc, cs[1], cut, tau, flats[1], g[1])
    two = FE.encmlp_dual_bwd(st, est, p, enc, cs[0], cs[1], cut, tau,
                             *flats, g[0], g[1])
    assert all(v == 0 for v in FE.launch_counts().values())
    twin = FE.encmlp_bwd_plain(st, est, p, enc, cs[1], cut, tau, flats[1],
                               g[1])
    assert torch.equal(one[0], twin[0]) and torch.equal(one[2], twin[2])
    assert all(torch.equal(a, b) for a, b in zip(one[3], twin[3]))
    # the dual's per-net pieces are the single-net ones; its dp/denc add
    # both nets' cotangents before one pullback
    assert torch.equal(two[3], one[2])
    assert all(torch.equal(a, b) for a, b in zip(two[5], one[3]))


def test_grad_layout_covers_flatten_order(scene):
    """The backward pack holds every weight of ``flatten_params_cm`` at
    its ``_grad_layout`` offset, untransposed, and the bias layout is
    the forward pack's."""
    _, tops = _operands(scene, 16)
    st, flat = tops[0], tops[7][1]
    wb = FE._pack_bwd_weights(flat, st)
    _, bbuf = FE._pack_kernel_weights(flat, st)
    layout = FM._grad_layout(st)
    assert len(layout) == len(flat)
    got = FE._unpack_grads(st, wb.float(), bbuf)
    for w, g in zip(flat, got):
        assert torch.equal(w.float(), g)
    # the views input rows past [xv | codes] are zero padding
    _, off, shape = layout[-4]
    end = off + shape[0] * shape[1]
    assert wb[end:end + 8 * st.half].abs().sum() == 0
