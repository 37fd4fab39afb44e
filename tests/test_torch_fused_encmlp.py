"""The fused encode+MLP module of the port against anerf_tpu's
``pallas_encmlp`` on the CPU.

* ``view_pe_rows``, ``flatten_params_cm`` and the viewfac cost gate
  equal the JAX ones;
* the plain twins of K1/K2 match the JAX Pallas kernels run in
  interpret mode (as tests/test_pallas_encmlp.py runs them) at R=8 rays
  and full width 256;
* the kernels' packed weight layout, read with the offsets of
  csrc/encmlp_fwd.cu, reproduces the twins;
* the wrappers take the twins on CPU tensors and count no launch.

Tolerance for the twins against the Pallas kernels: both run the same
bf16-operand chain, and differ only where the f32 transcendentals or
summation order round differently and flip a bf16 rounding between
layers.  Such a flip touches a few points in a hundred (measured: <= 1.2%
of the points beyond 1e-4 x scale, the rest within 1e-6), so each raw
channel must agree within 1e-4 x its scale on average and 1e-2 x its
scale at the worst point (measured 1.5e-5 and 3.6e-3).
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

from anerf_torch import testing_utils as T
from anerf_torch.interop import params_from_numpy
from anerf_torch.models.factory import build_raycast_config as t_build
from anerf_torch.ops import fused_encmlp as FE

J = 24


@pytest.fixture(scope='module')
def scene():
    cfg = T.surreal_config(N_rand=8)
    _, bones, _, kps, skts, cyls = T.synthetic_pose(4)
    batch = T.synthetic_batch(8, 4, kps, skts, bones, cyls)
    # the JAX dense forward: its viewfac mode would engage at S=64
    j_rc = dataclasses.replace(j_build(cfg, n_framecodes=4), viewfac=False)
    j_params = j_init(jax.random.PRNGKey(0), j_rc, cfg)
    t_rc = t_build(cfg, n_framecodes=4)
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        j_params))
    rays_t = JX.transform_batch_rays(jnp.asarray(batch['rays_d'])[:, None],
                                     jnp.asarray(batch['skts']))
    rays_t_norm = np.asarray(JX.vec_norm(rays_t)[:, 0])
    return dict(cfg=cfg, batch=batch, j_rc=j_rc, j_params=j_params,
                t_rc=t_rc, t_params=t_params, rays_t_norm=rays_t_norm)


def _pts_cm(batch, S):
    z = np.linspace(0.2, 1.5, S, dtype=np.float32)
    pts = batch['rays_o'][:, None] + batch['rays_d'][:, None] * z[:, None]
    return np.asarray(JX.transform_batch_pts_cm(jnp.asarray(pts),
                                                jnp.asarray(batch['skts'])))


def _assert_raw_close(ref, got, mean_tol=1e-4, max_tol=1e-2):
    """Per raw channel: mean and max |d| over the channel's max |ref|."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    for c in range(ref.shape[0]):
        d = np.abs(ref[c] - got[c]) / (np.abs(ref[c]).max() + 1e-6)
        assert d.mean() < mean_tol and d.max() < max_tol, (c, d.mean(),
                                                          d.max())


def test_view_pe_rows_matches_jax(scene):
    x = scene['rays_t_norm']
    freqs = [1., 2., 4., 8.]
    ref = np.asarray(PE.view_pe_rows(jnp.asarray(x), freqs, J))
    got = FE.view_pe_rows(torch.as_tensor(x), freqs, J).numpy()
    # the same permutation of the same sin/cos rows (equal up to the
    # libraries' last-ulp sin/cos rounding)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-7)
    np.testing.assert_array_equal(got[:, :72], ref[:, :72])


def test_flatten_params_cm_matches_jax(scene):
    pts = _pts_cm(scene['batch'], 16)
    st_j = PE._build_call(scene['j_rc'], jnp.asarray(pts),
                          jnp.asarray(scene['rays_t_norm']),
                          scene['j_params']['cutoff_dist'], 20.,
                          jnp.asarray(scene['batch']['cam_idxs']), True, None,
                          cm=True)[0]
    st_t = FE._build_call(scene['t_rc'], torch.as_tensor(pts),
                          torch.as_tensor(scene['rays_t_norm']),
                          scene['t_params']['cutoff_dist'], 20.,
                          torch.as_tensor(scene['batch']['cam_idxs']),
                          None)[0]
    assert (st_t.dparts, st_t.vparts, st_t.tile) == \
        (st_j.dparts, st_j.vparts, st_j.tile)
    ref = PE.flatten_params_cm(scene['j_params']['fine'], st_j, J, 9)
    got = FE.flatten_params_cm(scene['t_params']['fine'], st_t, J, 9)
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert str(a.dtype) == str(b.dtype).replace('torch.', '')
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())


@pytest.mark.parametrize('S,tile', [(64, 512), (16, 512), (64, 1024),
                                    (64, None), (16, 1024), (32, 256)])
@pytest.mark.parametrize('viewfac', [True, False])
def test_viewfac_gate_matches_jax(scene, S, tile, viewfac):
    R = 32   # big enough that the tile-shrink loop keeps tile 1024
    pts = jnp.zeros((R, S, 3 * J))
    j_rc = dataclasses.replace(scene['j_rc'], viewfac=viewfac)
    t_rc = dataclasses.replace(scene['t_rc'], viewfac=viewfac)
    st_j, est_j = PE._build_call(j_rc, pts, jnp.zeros((R, 3 * J)),
                                 scene['j_params']['cutoff_dist'], 100.,
                                 None, True, tile, cm=True)[:2]
    st_t, est_t = FE._build_call(t_rc, torch.zeros((R, S, 3 * J)),
                                 torch.zeros((R, 3 * J)),
                                 scene['t_params']['cutoff_dist'], 100.,
                                 None, tile)[:2]
    assert (est_t.viewfac, est_t.rpt, st_t.tile) == \
        (est_j.viewfac, est_j.rpt, st_j.tile)


@pytest.mark.parametrize('S', [64, 16])
def test_plain_twins_match_pallas_interpret(scene, S):
    """K2's twin at S=64 (the coarse pass) and K1's at S=16 (the fine
    pass) against the Pallas kernels in interpret mode."""
    pts = _pts_cm(scene['batch'], S)
    cam = scene['batch']['cam_idxs']
    tau = 21.9
    jargs = (jnp.asarray(pts), jnp.asarray(scene['rays_t_norm']),
             scene['j_params']['cutoff_dist'], tau, jnp.asarray(cam))
    targs = (torch.as_tensor(pts), torch.as_tensor(scene['rays_t_norm']),
             scene['t_params']['cutoff_dist'], tau, torch.as_tensor(cam))
    jp, tp = scene['j_params'], scene['t_params']
    if S == 64:
        ref = PE.nerf_encmlp_dual_pallas(jp['coarse'], jp['fine'],
                                         scene['j_rc'], *jargs,
                                         interpret=True, cm=True)
        got = FE.nerf_encmlp_dual(tp['coarse'], tp['fine'], scene['t_rc'],
                                  *targs)
    else:
        ref = (PE.nerf_encmlp_pallas(jp['fine'], scene['j_rc'], *jargs,
                                     interpret=True, cm=True),)
        got = (FE.nerf_encmlp(tp['fine'], scene['t_rc'], *targs),)
    for a, b in zip(ref, got):
        assert tuple(b.shape) == (4, 8, S)
        _assert_raw_close(a, b)


# ---- the CUDA kernels' packed weight layout, read as the kernel does ----

# offsets of csrc/encmlp_fwd.cu (bf16 elements / f32 elements)
_W, _HV, _DX, _DXV, _DE = 256, 128, 432, 672, 648
_SZ_X, _SZ_H = _W * _DX, _W * _W


def _off_h(i):
    return _SZ_X + (i - 1) * _SZ_H + (_SZ_X if i > 5 else 0)


_OFF_SKIPX = _SZ_X + 5 * _SZ_H
_OFF_F = 2 * _SZ_X + 7 * _SZ_H
_OFF_VF = _OFF_F + _SZ_H
_OFF_VX = _OFF_VF + _HV * _W
_OFF_A = _OFF_VX + _HV * _DXV
_OFF_R = _OFF_A + _W
_WSZ = _OFF_R + 3 * _HV
_OB_F, _OB_V = 8 * _W, 9 * _W
_OB_A = _OB_V + _HV
_OB_R = _OB_A + 1


def _emulate_kernel(v, r, xv, codes_pt, wbuf, bbuf):
    """One net through the packed buffers with the kernel's offsets and
    operand layouts ([v|r] trunk input, [xv|codes|0] views input)."""
    b16 = lambda a: a.to(torch.bfloat16).float()
    wb = wbuf.float()
    mat = lambda off, n, k: wb[off:off + n * k].reshape(n, k)
    X = b16(torch.cat([v, r], -1))
    XV = b16(torch.cat([xv, codes_pt,
                        torch.zeros((v.shape[0], _DXV - _DE - 16))], -1))
    h = b16(torch.relu(X @ mat(0, _W, _DX).T + bbuf[:_W]))
    for i in range(1, 8):
        pre = h @ mat(_off_h(i), _W, _W).T
        if i == 5:
            pre = pre + X @ mat(_OFF_SKIPX, _W, _DX).T
        h = b16(torch.relu(pre + bbuf[i * _W:(i + 1) * _W]))
    alpha = h @ wb[_OFF_A:_OFF_A + _W] + bbuf[_OB_A]
    feat = b16(h @ mat(_OFF_F, _W, _W).T + bbuf[_OB_F:_OB_F + _W])
    hv = b16(torch.relu(feat @ mat(_OFF_VF, _HV, _W).T
                        + XV @ mat(_OFF_VX, _HV, _DXV).T
                        + bbuf[_OB_V:_OB_V + _HV]))
    rgb = hv @ mat(_OFF_R, 3, _HV).T + bbuf[_OB_R:_OB_R + 3]
    return torch.cat([rgb, alpha[:, None]], -1).T


def test_kernel_weight_pack_matches_twin(scene):
    pts = torch.as_tensor(_pts_cm(scene['batch'], 16))
    st, est, p, enc, cutoff, tau = FE._build_call(
        scene['t_rc'], pts, torch.as_tensor(scene['rays_t_norm']),
        scene['t_params']['cutoff_dist'], 21.9,
        torch.as_tensor(scene['batch']['cam_idxs']), None)
    FE._check_kernel_shape(st, est)
    codes = FE._codes(scene['t_params']['fine'],
                      torch.as_tensor(scene['batch']['cam_idxs']))
    flat = FE.flatten_params_cm(scene['t_params']['fine'], st, J, 9)
    wbuf, bbuf = FE._pack_kernel_weights(flat, st)
    assert wbuf.dtype == torch.bfloat16 and bbuf.dtype == torch.float32
    assert (wbuf.numel(), bbuf.numel()) == (_WSZ, _OB_R + 3)
    v, r, xv = FE._encode_plain(est, p, enc, cutoff, tau)
    ray = torch.arange(p.shape[0]) // est.S
    got = _emulate_kernel(v, r, xv, codes[ray], wbuf, bbuf)
    ref = FE.encmlp_fwd_plain(st, est, p, enc, codes, cutoff, tau, flat)
    # one [v|r] product in place of two summed ones: f32 order only
    _assert_raw_close(ref, got)


def test_wrappers_take_twins_on_cpu(scene):
    pts = torch.as_tensor(_pts_cm(scene['batch'], 16))
    cam = torch.as_tensor(scene['batch']['cam_idxs'])
    st, est, p, enc, cutoff, tau = FE._build_call(
        scene['t_rc'], pts, torch.as_tensor(scene['rays_t_norm']),
        scene['t_params']['cutoff_dist'], 21.9, cam, None)
    codes = [FE._codes(scene['t_params'][k], cam) for k in ('coarse', 'fine')]
    flats = [FE.flatten_params_cm(scene['t_params'][k], st, J, 9)
             for k in ('coarse', 'fine')]
    FE.reset_launch_counts()
    one = FE.encmlp_fwd(st, est, p, enc, codes[1], cutoff, tau, flats[1])
    two = FE.encmlp_dual_fwd(st, est, p, enc, codes[0], codes[1], cutoff, tau,
                             *flats)
    assert FE.launch_counts() == {'encmlp_fwd': 0, 'encmlp_dual_fwd': 0,
                                  'encmlp_bwd': 0, 'encmlp_dual_bwd': 0,
                                  'mlp_fwd': 0, 'mlp_bwd': 0}
    twin = FE.encmlp_fwd_plain(st, est, p, enc, codes[1], cutoff, tau,
                               flats[1])
    assert torch.equal(one, twin) and torch.equal(two[1], twin)
    with pytest.raises(TypeError):
        FE.encmlp_fwd(st, est, p.double(), enc, codes[1], cutoff, tau,
                      flats[1])
    with pytest.raises(ValueError):
        FE.encmlp_fwd(st, est, p[:, :70].contiguous(), enc, codes[1], cutoff,
                      tau, flats[1])


@pytest.mark.parametrize('change', [dict(width=512), dict(depth=6),
                                    dict(skips=(3,)), dict(vparts=(648, 8))])
def test_kernel_shape_gate(scene, change):
    """The CUDA kernels are compiled for the flagship shape only; any
    other static must be refused before a launch, never run wrong."""
    pts = torch.as_tensor(_pts_cm(scene['batch'], 16))
    st, est = FE._build_call(scene['t_rc'], pts,
                             torch.as_tensor(scene['rays_t_norm']),
                             scene['t_params']['cutoff_dist'], 21.9,
                             torch.as_tensor(scene['batch']['cam_idxs']),
                             None)[:2]
    FE._check_kernel_shape(st, est)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        FE._check_kernel_shape(dataclasses.replace(st, **change), est)
