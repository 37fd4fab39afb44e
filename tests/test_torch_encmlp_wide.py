"""K1-K4's twins, and K-vf1/K-vf2's, at the WIDE nets the fused encode
kernels take since ROADMAP B.1.4's first part (768-2048 wide, the views
layer half as wide), against anerf_tpu's ``pallas_encmlp`` and
``pallas_mlp`` on the CPU.

The nets, over the SURREAL recipe: two 8 x 768 nets (a 384-wide views
layer: three 128-column views blocks, no multiple of 256) and two 8 x
1024 nets (the 8 x 1024 flagship's).  Each is built from the same
seed-made parameters in both packages (the JAX tree converted with
``params_from_numpy``) at R=8 rays and full width, the dense views input
on both sides (viewfac off).

* the gate: ``configs/surreal.txt`` at widths 768, 1024, 1536 and 2048,
  1 and 8 layers, is admitted on both sides with its build key (kp
  bands, view rows, bone window, depth, width, framecode columns); at 16
  layers the port admits what the card's f64 check admitted
  (``fused_encmlp.kernel_depths``); 2304 wide, which anerf_tpu's
  gate takes, is refused by the port's (the kernels' headers stop at
  2048, as K5/K6's do);
* K1's twin at S=16 and K2's at S=64 against the Pallas kernels in
  interpret mode, each raw channel within 1e-2 x its scale at its worst
  point and, on average, within 1e-4 x (768) or WIDE_MEAN_TOL x (1024)
  of it;
* K3's and K4's twins at S=16 against the Pallas custom_vjps at 8 x 768
  on the same N(0, 1) raw cotangent, at ``test_torch_fused_bwd.py``'s
  bars (cosine > 0.9999, norm within 5e-3, elementwise within 1e-3 x a
  leaf's max |value| on average and 5e-2 x at its worst element);
* K-vf1's twin (M) and K-vf2's (dWvx, denc from K4's Gram matrices) at
  views layers of 384 and 1024 against ``pallas_mlp.viewfac_operand`` /
  ``_viewfac_dot`` / ``_viewfac_bwd``, at ``test_torch_viewfac.py``'s
  bars.

WIDE_MEAN_TOL: the mean bar past 768.  At 8 x 1024 (seed 0, R=8) the
twin and the Pallas kernel differ on the r channel by 1.11e-4 (S=16)
and 1.29e-4 (S=64) of its scale on average, past the 1e-4 of the
narrower nets, and this is summation-order noise, not a difference of
chain: three f32 evaluations of the same bf16 chain (the twin, the
Pallas kernel, and the twin with each product's sum split in two and
added the other way round) sit 2.1e-5 to 1.05e-4 from its evaluation in
f64 and 9.0e-5 to 1.29e-4 from each other (the reordered twin 9.0e-5
from the twin at S=64), where at 8 x 256 all of them sit within 2.2e-5
of each other.  Each bf16 re-cast between layers turns the f32 sums'
order into flips of whole bf16 steps, and a 1024-deep sum carries more
of them.  So the WIDE bar is 3e-4, about twice the widest distance
measured between two f32 evaluations.
"""
import dataclasses
import os

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
from anerf_torch.utils.config import load_config

from test_torch_encmlp_views import _scaled_close, _vf_arrays, _vf_est
from test_torch_fused_bwd import _leaf, _operands, assert_grad_close
from test_torch_fused_encmlp import _assert_raw_close, _pts_cm
from test_torch_threads import one_torch_thread  # noqa: F401

J = 24
WIDE_MEAN_TOL = 3e-4
SURREAL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'configs', 'surreal.txt')
_SCENES = {}


def wide_scene(width):
    """The scene of two 8 x ``width`` nets (built once a process): both
    packages' configs and parameters (JAX seed 0; the port's carried
    across by ``params_from_numpy``), the batch and the rays'
    joint-local directions."""
    if width not in _SCENES:
        cfg = T.surreal_config(N_rand=8, compute_dtype='bfloat16',
                               netwidth=width, netwidth_fine=width)
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
        _SCENES[width] = dict(
            cfg=cfg, batch=batch, j_rc=j_rc, j_params=j_params, t_rc=t_rc,
            t_params=t_params,
            rays_t_norm=np.asarray(JX.vec_norm(rays_t)[:, 0]))
    return _SCENES[width]


def test_params_carry_wide_trees():
    """``params_from_numpy`` carries a WIDE JAX tree leaf for leaf: every
    weight of the 8 x 768 nets (a 384-wide views layer) at its shape and
    bits."""
    s = wide_scene(768)
    j_leaves = jax.tree_util.tree_leaves(s['j_params'])
    t_leaves = jax.tree_util.tree_leaves(
        s['t_params'], is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(j_leaves) == len(t_leaves)
    for a, b in zip(j_leaves, t_leaves):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape
        assert np.array_equal(b.float().numpy(), a.astype(np.float32))
    assert tuple(s['t_params']['fine']['views_linear']['w'].shape) == \
        (768 + 648 + 16, 384)


@pytest.mark.parametrize('width', (768, 1024, 1536, 2048, 2304))
def test_gate_takes_wide_nets(width):
    """``configs/surreal.txt`` at ``netwidth`` 768-2048, 1 and 8 layers,
    is admitted by both packages' fused encode, the port's with the
    build of that width (views layer W / 2); at 16 layers the port
    admits it where ``kernel_depths`` does (the card's f64 check);
    2304 is refused by the port alone, naming ROADMAP B.1.4."""
    for depth in (1, 8, 16):
        cfg = load_config(SURREAL, netwidth=width, netwidth_fine=width,
                          netdepth=depth, netdepth_fine=depth)
        j_rc, t_rc = j_build(cfg, n_framecodes=4), t_build(cfg,
                                                           n_framecodes=4)
        assert PE.supported_config(j_rc) and FE.supported_config(t_rc)
        st, est = FE._statics(t_rc, t_rc.n_joints, 64, FE.DEFAULT_TILE,
                              True)
        assert (st.width, st.half) == (width, width // 2)
        admitted = width <= 2048 and (depth <= 8
                                      or depth in FE.kernel_depths(width))
        assert FE.kernel_shape_ok(t_rc) == admitted, (width, depth)
        if admitted:
            assert FE.kernel_shape(st, est) == (7, 9, False, depth, width,
                                                16)
        else:
            with pytest.raises(NotImplementedError,
                               match='ROADMAP.md B.1.4'):
                FE.kernel_shape(st, est)


FWD_CASES = [(768, 16), (768, 64), (1024, 16), (1024, 64)]


@pytest.mark.parametrize('width,S', FWD_CASES,
                         ids=[f'w{w}-{S}' for w, S in FWD_CASES])
def test_wide_fwd_twins_match_pallas_interpret(width, S):
    """K2's twin at S=64 (the coarse pass) and K1's at S=16 (the fine
    pass) against the Pallas kernels in interpret mode, at 8 x 768 and 8
    x 1024 (the mean bar WIDE_MEAN_TOL past 768: the module's note)."""
    s = wide_scene(width)
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
    assert ref[0] is not None   # anerf_tpu's kernel takes the net
    for a, b in zip(ref, got):
        assert tuple(b.shape) == (4, 8, S)
        _assert_raw_close(a, b, mean_tol=1e-4 if width <= 768
                          else WIDE_MEAN_TOL)


@pytest.mark.parametrize('nnet', (1, 2))
def test_wide_bwd_twins_match_pallas_vjp(nnet):
    """K3's twin (the fine net) and K4's (both nets) at S=16 against the
    Pallas VJPs at 8 x 768: dp, denc, dcodes and every weight
    gradient."""
    S = 16
    s = wide_scene(768)
    jops, tops = _operands(s, S)
    st_j, est_j, p_j, enc_j, c_j, cut_j, tau_j, f_j = jops
    st_t, est_t, p_t, enc_t, c_t, cut_t, tau_t, f_t = tops
    assert FE.kernel_shape(st_t, est_t) == (7, 9, False, 8, 768, 16)
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
    for i, (a, b) in enumerate(zip(ref, got)):
        assert b.dtype == ins[i].dtype, i     # bf16 weights, f32 biases
        assert_grad_close(np.asarray(a, np.float32), b.float().numpy(),
                          name=f'8x768 K{2 + nnet} operand {i}')


@pytest.mark.parametrize('half', (384, 1024))
def test_vf_twins_match_pallas_mlp_wide(half):
    """K-vf1's twin is _viewfac_dot's M rounded to bf16 for each net, and
    K-vf2's twin on K4's Gram matrices gives _viewfac_bwd's dWv and
    d_enc, at the views layers of 8 x 768 and 8 x 2048 nets (9 view
    rows)."""
    S, nb = 64, 9
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
    assert gw.shape == (R, J, half)
    dwv, denc = FE.vf_fold_plain(est, gw[None], torch.as_tensor(enc),
                                 wvx[:1])
    _scaled_close(dwv_j, dwv[0], 2e-3, 'dWv')
    _scaled_close(denc_j, denc, 2e-3, 'd_enc')
