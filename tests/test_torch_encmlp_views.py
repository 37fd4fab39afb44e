"""K1-K4's twins, and K-vf1/K-vf2's, at the views inputs the fused
encode kernels take since ROADMAP B.1.3, against anerf_tpu's
``pallas_encmlp`` and ``pallas_mlp`` on the CPU.

The shapes, over the SURREAL recipe: eleven view PE rows
(``multires_views = 5``: K1/K2's trunk input leaves shared memory, and
K-vf1 takes its 33 columns a joint in 48-deep k-steps), the corner of
the gate, 21 view rows with framecodes of 128 (``multires_views = 10,
framecode_size = 128``: the views input leaves K1/K2's shared memory,
and the codes' k-slice spans five ring stages under viewfac), and
framecodes of 32 at the flagship's nine rows.  Each is built from the
same seed-made parameters in both packages (the JAX tree converted
with ``params_from_numpy``) at R=8 rays and full width, the dense views
input on both sides.

* the gate admits each shape on both sides, with the build key (kp
  bands, view rows, bone window, depth, width, framecode columns);
* K2's twin at S=64 and K1's at S=16 against the Pallas kernels in
  interpret mode (framecodes of 32 at S=16 alone), at
  ``test_torch_encmlp_shapes.py``'s bars: each raw channel within 1e-4
  x its scale on average and 1e-2 x at its worst point;
* K3's and K4's twins at S=16 against the Pallas custom_vjps on the
  same N(0, 1) raw cotangent, at ``test_torch_fused_bwd.py``'s bars
  (cosine > 0.9999, norm within 5e-3, elementwise within 1e-3 x a
  leaf's max |value| on average and 5e-2 x at its worst element);
* K-vf1's twin (M) and K-vf2's (dWvx, denc from K4's Gram matrices)
  at 11 and 21 view rows against ``pallas_mlp.viewfac_operand`` /
  ``_viewfac_dot`` / ``_viewfac_bwd``, at ``test_torch_viewfac.py``'s
  bars (M within 8e-3 of its scale with under 1e-3 of its values one
  bf16 step off; dWv and d_enc within 2e-3).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anerf_tpu.models.factory import build_raycast_config as j_build
from anerf_tpu.models.factory import init_raycaster_params as j_init
from anerf_tpu.ops import encoders as JX
from anerf_tpu.ops import pallas_encmlp as PE
from anerf_tpu.ops import pallas_mlp as PM

from anerf_torch import testing_utils as T
from anerf_torch.interop import params_from_numpy
from anerf_torch.models.factory import build_raycast_config as t_build
from anerf_torch.ops import fused_encmlp as FE

from test_torch_fused_bwd import _leaf, _operands, assert_grad_close
from test_torch_fused_encmlp import _assert_raw_close, _pts_cm
from test_torch_threads import one_torch_thread  # noqa: F401

J = 24
# name: (config overrides, the build key)
SHAPES = {
    'nb11': (dict(multires_views=5), (7, 11, False, 8, 256, 16)),
    'nb21_codes128': (dict(multires_views=10, framecode_size=128),
                      (7, 21, False, 8, 256, 128)),
    'codes32': (dict(framecode_size=32), (7, 9, False, 8, 256, 32)),
}
FWD_CASES = [('nb11', 64), ('nb11', 16), ('nb21_codes128', 64),
             ('nb21_codes128', 16), ('codes32', 16)]
# (shape, nets): K3's twin on the fine net, K4's on both, at S=16
BWD_CASES = [('nb11', 1), ('nb21_codes128', 1), ('nb21_codes128', 2),
             ('codes32', 1)]
_SCENES = {}


def views_scene(name):
    """The scene of shape ``name`` (built once a process): both
    packages' configs and parameters (JAX seed 0), the batch and the
    rays' joint-local directions."""
    if name not in _SCENES:
        cfg = T.surreal_config(N_rand=8, compute_dtype='bfloat16',
                               **SHAPES[name][0])
        _, bones, _, kps, skts, cyls = T.synthetic_pose(4)
        batch = T.synthetic_batch(8, 4, kps, skts, bones, cyls)
        j_rc = dataclasses.replace(j_build(cfg, n_framecodes=4),
                                   viewfac=False)
        j_params = j_init(jax.random.PRNGKey(0), j_rc, cfg)
        t_rc = dataclasses.replace(t_build(cfg, n_framecodes=4),
                                   viewfac=False)
        t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                            j_params))
        rays_t = JX.transform_batch_rays(
            jnp.asarray(batch['rays_d'])[:, None], jnp.asarray(batch['skts']))
        _SCENES[name] = dict(
            cfg=cfg, batch=batch, j_rc=j_rc, j_params=j_params, t_rc=t_rc,
            t_params=t_params, rays_t_norm=np.asarray(JX.vec_norm(rays_t)[:, 0]))
    return _SCENES[name]


@pytest.mark.parametrize('name', sorted(SHAPES))
def test_views_shape_is_admitted(name):
    """Both packages' fused encode takes the config; the port's gate
    admits it with the build that carries its views input, and
    anerf_tpu's statics agree with the port's."""
    s = views_scene(name)
    assert PE.supported_config(s['j_rc']) and FE.kernel_shape_ok(s['t_rc'])
    pts = _pts_cm(s['batch'], 16)
    st_j, est_j = PE._build_call(
        s['j_rc'], jnp.asarray(pts), jnp.asarray(s['rays_t_norm']),
        s['j_params']['cutoff_dist'], 20., jnp.asarray(
            s['batch']['cam_idxs']), True, None, cm=True)[:2]
    st_t, est_t = FE._build_call(
        s['t_rc'], torch.as_tensor(pts), torch.as_tensor(s['rays_t_norm']),
        s['t_params']['cutoff_dist'], 20.,
        torch.as_tensor(s['batch']['cam_idxs']), None)[:2]
    key = SHAPES[name][1]
    assert FE.kernel_shape(st_t, est_t) == key
    assert st_t.xv_pad == key[1] * 3 * J + key[5] + 8
    assert (st_t.depth, st_t.dparts, st_t.vparts) == \
        (st_j.depth, st_j.dparts, st_j.vparts)
    assert est_t.view_nb == est_j.view_nb == key[1]


def test_gate_takes_every_views_input_of_the_surreal_recipe():
    """``kernel_shape_ok`` holds for ``configs/surreal.txt`` at every
    ``multires_views`` of 0-10 and every ``framecode_size`` up to 128,
    each build keyed by its view rows and framecode columns; framecodes
    of 129 and 23 view rows are refused."""
    import os
    from anerf_torch.utils.config import load_config
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'configs', 'surreal.txt')
    for mv in range(11):
        for codes in (1, 8, 16, 17, 32, 48, 100, 127, 128):
            cfg = load_config(path, multires_views=mv, framecode_size=codes,
                              opt_framecode=True)
            rc = t_build(cfg, n_framecodes=4)
            assert FE.kernel_shape_ok(rc), (mv, codes)
            st, est = FE._statics(rc, rc.n_joints, 64, FE.DEFAULT_TILE, True)
            assert FE.kernel_shape(st, est)[1::4] == (
                1 + 2 * mv, max(16, -(-codes // 16) * 16))
    for over in (dict(multires_views=4, framecode_size=129),
                 dict(multires_views=11, framecode_size=16)):
        rc = t_build(load_config(path, opt_framecode=True, **over),
                     n_framecodes=4)
        assert not FE.kernel_shape_ok(rc), over


@pytest.mark.parametrize('name,S', FWD_CASES,
                         ids=[f'{n}-{S}' for n, S in FWD_CASES])
def test_views_fwd_twins_match_pallas_interpret(name, S):
    """K2's twin at S=64 (the coarse pass) and K1's at S=16 (the fine
    pass) against the Pallas kernels in interpret mode."""
    s = views_scene(name)
    pts = _pts_cm(s['batch'], S)
    cam = s['batch']['cam_idxs']
    tau = 21.9
    jargs = (jnp.asarray(pts), jnp.asarray(s['rays_t_norm']),
             s['j_params']['cutoff_dist'], tau, jnp.asarray(cam))
    targs = (torch.as_tensor(pts), torch.as_tensor(s['rays_t_norm']),
             s['t_params']['cutoff_dist'], tau, torch.as_tensor(cam))
    jp, tp = s['j_params'], s['t_params']
    if S == 64:
        ref = PE.nerf_encmlp_dual_pallas(jp['coarse'], jp['fine'], s['j_rc'],
                                         *jargs, interpret=True, cm=True)
        got = FE.nerf_encmlp_dual(tp['coarse'], tp['fine'], s['t_rc'],
                                  *targs)
    else:
        ref = (PE.nerf_encmlp_pallas(jp['fine'], s['j_rc'], *jargs,
                                     interpret=True, cm=True),)
        got = (FE.nerf_encmlp(tp['fine'], s['t_rc'], *targs),)
    assert ref[0] is not None   # anerf_tpu's kernel takes the shape
    for a, b in zip(ref, got):
        assert tuple(b.shape) == (4, 8, S)
        _assert_raw_close(a, b)


@pytest.mark.parametrize('name,nnet', BWD_CASES,
                         ids=[f'{n}-{k}' for n, k in BWD_CASES])
def test_views_bwd_twins_match_pallas_vjp(name, nnet):
    """K3's twin (the fine net) and K4's (both nets) at S=16 against the
    Pallas VJPs: dp, denc, dcodes and every weight gradient."""
    S = 16
    s = views_scene(name)
    jops, tops = _operands(s, S)
    st_j, est_j, p_j, enc_j, c_j, cut_j, tau_j, f_j = jops
    st_t, est_t, p_t, enc_t, c_t, cut_t, tau_t, f_t = tops
    assert FE.kernel_shape(st_t, est_t) == SHAPES[name][1]
    n = p_j.shape[0]
    g = np.random.RandomState(3).normal(size=(nnet, 4, n)).astype(np.float32)
    tf = jnp.zeros((1, 1), jnp.float32)
    if nnet == 2:
        fn = lambda p, e, cc, cf, fc, ff: PE._fused_dual(
            st_j, est_j, p, e, tf, cc, cf, cut_j, tau_j, fc, ff)
        _, vjp = jax.vjp(fn, p_j, enc_j, c_j[0], c_j[1], f_j[0], f_j[1])
        dp, denc, dcc, dcf, dfc, dff = vjp((jnp.asarray(g[0]),
                                            jnp.asarray(g[1])))
        ref = [dp, denc, dcc, dcf] + dfc + dff
    else:
        fn = lambda p, e, c, f: PE._fused(st_j, est_j, p, e, tf, c, cut_j,
                                          tau_j, f)
        _, vjp = jax.vjp(fn, p_j, enc_j, c_j[1], f_j[1])
        dp, denc, dc, df = vjp(jnp.asarray(g[0]))
        ref = [dp, denc, dc] + df
    p, enc = _leaf(p_t), _leaf(enc_t)
    cs = [_leaf(c) for c in c_t]
    flats = [[_leaf(w) for w in f] for f in f_t]
    if nnet == 2:
        outs = FE.encmlp_dual_fwd(st_t, est_t, p, enc, cs[0], cs[1], cut_t,
                                  tau_t, flats[0], flats[1])
        ins = [p, enc] + cs + flats[0] + flats[1]
    else:
        outs = (FE.encmlp_fwd(st_t, est_t, p, enc, cs[1], cut_t, tau_t,
                              flats[1]),)
        ins = [p, enc, cs[1]] + flats[1]
    got = torch.autograd.grad(outs, ins, [torch.as_tensor(x) for x in g])
    assert len(got) == len(ref)
    assert got[2].shape == cs[nnet % 2].shape  # dcodes at the codes' width
    for i, (a, b) in enumerate(zip(ref, got)):
        assert b.dtype == ins[i].dtype, i     # bf16 weights, f32 biases
        assert_grad_close(np.asarray(a, np.float32), b.float().numpy(),
                          name=f'{name} operand {i}')


def _vf_arrays(nb, S=64, R=8, seed=0, half=128):
    """Windows (n, J) in (0, 1), view rows (R, 72 nb), the views weight's
    view rows (72 nb, half) and a views cotangent (n, half), from
    numpy."""
    rng = np.random.RandomState(seed)
    nbj, n = nb * 3 * J, R * S
    w = rng.uniform(0, 1, (n, J)).astype(np.float32)
    enc = rng.uniform(-1, 1, (R, nbj)).astype(np.float32)
    wv = (rng.normal(size=(nbj, half)) / np.sqrt(nbj)).astype(np.float32)
    g = rng.normal(size=(n, half)).astype(np.float32)
    wv = np.asarray(jnp.asarray(wv).astype(jnp.bfloat16).astype(jnp.float32))
    return w, enc, wv, g


def _vf_est(nb, S=64):
    return FE.EncStatic(J=J, kp_freqs=tuple(2. ** k for k in range(7)),
                        view_nb=nb, S=S, rpt=512 // S, has_codes=True,
                        viewfac=True)


def _scaled_close(ref, got, tol, name):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape, (name, ref.shape, got.shape)
    err = np.abs(ref - got).max() / np.abs(ref).max()
    assert err < tol, (name, err)


@pytest.mark.parametrize('half', (128, 256))
@pytest.mark.parametrize('nb', (11, 21))
def test_vf_twins_match_pallas_mlp(nb, half):
    """K-vf1's twin is _viewfac_dot's M rounded to bf16 for each net, and
    K-vf2's twin on K4's Gram matrices gives _viewfac_bwd's dWv and
    d_enc, at 33 and 63 view columns a joint."""
    S = 64
    w, enc, wv, g = _vf_arrays(nb, S, half=half)
    R, est = enc.shape[0], _vf_est(nb, S)
    jfac = PM.viewfac_operand(jnp.asarray(w), jnp.asarray(enc), R, S)
    wvx = torch.stack([torch.as_tensor(wv), -torch.as_tensor(wv)]).to(
        torch.bfloat16)
    M = FE.vf_operand_plain(est, torch.as_tensor(enc), wvx)
    assert M.dtype == torch.bfloat16 and M.shape == (2, R, J, half)
    for net, sign in enumerate((1., -1.)):
        ref = PM._dot(jfac[2], (sign * jnp.asarray(wv)).astype(jnp.bfloat16))
        ref = np.asarray(ref.astype(jnp.bfloat16).astype(jnp.float32))
        got = M[net].float().numpy().reshape(R * J, half)
        assert np.mean(ref != got) < 1e-3
        _scaled_close(ref, got, 8e-3, f'M net {net}')
    wv_j = jnp.asarray(wv).astype(jnp.bfloat16)
    _, denc_j, dwv_j = PM._viewfac_bwd(jfac, wv_j, jnp.asarray(g))
    gw = FE.vf_gram_plain(est, torch.as_tensor(w), torch.as_tensor(g))
    dwv, denc = FE.vf_fold_plain(est, gw[None], torch.as_tensor(enc),
                                 wvx[:1])
    _scaled_close(dwv_j, dwv[0], 2e-3, 'dWv')
    _scaled_close(denc_j, denc, 2e-3, 'd_enc')
