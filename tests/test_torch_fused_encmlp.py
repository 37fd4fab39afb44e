"""The fused encode+MLP module of the port against anerf_tpu's
``pallas_encmlp`` on the CPU.

* ``view_pe_rows``, ``flatten_params_cm`` and the viewfac cost gate
  equal the JAX ones;
* the plain twins of K1/K2 match the JAX Pallas kernels run in
  interpret mode (as tests/test_pallas_encmlp.py runs them) at R=8 rays
  and full width 256;
* the kernels' packed weight layout, read with the offsets of
  csrc/encmlp_common.cuh at a build's shape (the flagship's, one view
  row, 6 layers, framecodes of 8), reproduces the twins;
* the shape gate admits the shapes the kernels are built for and
  refuses the rest;
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
from anerf_torch.models.factory import init_raycaster_params as t_init
from anerf_torch.ops import fused_encmlp as FE

from test_torch_threads import one_torch_thread  # noqa: F401

J = 24


@pytest.fixture(scope='module')
def scene():
    cfg = T.surreal_config(N_rand=8)
    _, bones, _, kps, skts, cyls = T.synthetic_pose(4)
    batch = T.synthetic_batch(8, 4, kps, skts, bones, cyls)
    # the JAX dense forward: its viewfac mode would engage at S=64
    j_rc = dataclasses.replace(j_build(cfg, n_framecodes=4), viewfac=False)
    j_params = j_init(jax.random.PRNGKey(0), j_rc, cfg)
    # the port's dense forward alike (its viewfac: test_torch_viewfac.py)
    t_rc = dataclasses.replace(t_build(cfg, n_framecodes=4), viewfac=False)
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

def _layout(dx, depth, dxv, W=256, HV=128, skip=4):
    """The offsets of csrc/encmlp_common.cuh at a build's shape (bf16
    elements / f32 elements): trunk width ``dx`` (DXP), ``depth`` layers,
    views input ``dxv`` (DXV = 72 NB + 24)."""
    has_skip = skip + 1 < depth
    sz_x, sz_h = W * dx, W * W
    L = dict(W=W, HV=HV, DX=dx, DXV=dxv, depth=depth, skip=skip,
             has_skip=has_skip)
    L['off_h'] = lambda i: (sz_x + (i - 1) * sz_h
                            + (sz_x if has_skip and i > skip + 1 else 0))
    L['OFF_SKIPX'] = sz_x + (skip + 1) * sz_h
    L['OFF_F'] = sz_x + (depth - 1) * sz_h + (sz_x if has_skip else 0)
    L['OFF_VF'] = L['OFF_F'] + sz_h
    L['OFF_VX'] = L['OFF_VF'] + HV * W
    L['OFF_A'] = L['OFF_VX'] + HV * dxv
    L['OFF_R'] = L['OFF_A'] + W
    L['WSZ'] = L['OFF_R'] + 3 * HV
    L['OB_F'] = depth * W
    L['OB_V'] = L['OB_F'] + W
    L['OB_A'] = L['OB_V'] + HV
    L['OB_R'] = L['OB_A'] + 1
    return L


def _emulate_kernel(L, v, r, xv, codes_pt, wbuf, bbuf):
    """One net through the packed buffers with the kernel's offsets and
    operand layouts ([v|r] trunk input, [xv|codes|0] views input, the
    codes zero-padded to 16 as ``_codes_operand`` pads them)."""
    b16 = lambda a: a.to(torch.bfloat16).float()
    W, HV, DX, DXV = L['W'], L['HV'], L['DX'], L['DXV']
    wb = wbuf.float()
    mat = lambda off, n, k: wb[off:off + n * k].reshape(n, k)
    X = b16(torch.cat([v, r], -1))
    codes16 = torch.nn.functional.pad(codes_pt, (0, 16 - codes_pt.shape[1]))
    XV = b16(torch.cat([xv, codes16,
                        torch.zeros((v.shape[0], DXV - xv.shape[1] - 16))],
                       -1))
    h = b16(torch.relu(X @ mat(0, W, DX).T + bbuf[:W]))
    for i in range(1, L['depth']):
        pre = h @ mat(L['off_h'](i), W, W).T
        if L['has_skip'] and i == L['skip'] + 1:
            pre = pre + X @ mat(L['OFF_SKIPX'], W, DX).T
        h = b16(torch.relu(pre + bbuf[i * W:(i + 1) * W]))
    alpha = h @ wb[L['OFF_A']:L['OFF_A'] + W] + bbuf[L['OB_A']]
    feat = b16(h @ mat(L['OFF_F'], W, W).T + bbuf[L['OB_F']:L['OB_F'] + W])
    hv = b16(torch.relu(feat @ mat(L['OFF_VF'], HV, W).T
                        + XV @ mat(L['OFF_VX'], HV, DXV).T
                        + bbuf[L['OB_V']:L['OB_V'] + HV]))
    rgb = hv @ mat(L['OFF_R'], 3, HV).T + bbuf[L['OB_R']:L['OB_R'] + 3]
    return torch.cat([rgb, alpha[:, None]], -1).T


def _port_variant(**over):
    """(rc, params) of the SURREAL recipe with ``over``, from the port's
    own initializer (seed 0), the dense views input."""
    cfg = T.surreal_config(N_rand=8, **over)
    rc = dataclasses.replace(t_build(cfg, n_framecodes=4), viewfac=False)
    return rc, t_init(torch.Generator().manual_seed(0), rc, cfg)


# the flagship; one view row (multires_views 0: surreal_single's); 6
# layers (the skip layer last but one); framecodes of 8, padded to 16;
# two 8 x 512 nets (a 256-wide views layer) and 16 layers of 256
PACK_SHAPES = {'flagship': {}, 'nb1': dict(multires_views=0),
               'depth6': dict(netdepth=6, netdepth_fine=6),
               'codes8': dict(framecode_size=8),
               'w512': dict(netwidth=512, netwidth_fine=512),
               'depth16': dict(netdepth=16, netdepth_fine=16)}


@pytest.mark.parametrize('variant', sorted(PACK_SHAPES))
def test_kernel_weight_pack_matches_twin(scene, variant):
    if variant == 'flagship':
        rc, params = scene['t_rc'], scene['t_params']
    else:
        rc, params = _port_variant(**PACK_SHAPES[variant])
    pts = torch.as_tensor(_pts_cm(scene['batch'], 16))
    st, est, p, enc, cutoff, tau = FE._build_call(
        rc, pts, torch.as_tensor(scene['rays_t_norm']),
        params['cutoff_dist'], 21.9,
        torch.as_tensor(scene['batch']['cam_idxs']), None)
    nf, nb, _, depth, width, _ = FE.kernel_shape(st, est)
    L = _layout((2 * nf + 1) * J + 3 * J, depth, nb * 3 * J + 24, W=width,
                HV=width // 2)
    codes = FE._codes(params['fine'],
                      torch.as_tensor(scene['batch']['cam_idxs']))
    flat = FE.flatten_params_cm(params['fine'], st, J, nb)
    wbuf, bbuf = FE._packs(st, [flat])
    assert wbuf.dtype == torch.bfloat16 and bbuf.dtype == torch.float32
    assert (wbuf.numel(), bbuf.numel()) == (L['WSZ'], L['OB_R'] + 3)
    v, r, xv = FE._encode_plain(est, p, enc, cutoff, tau)
    ray = torch.arange(p.shape[0]) // est.S
    got = _emulate_kernel(L, v, r, xv, codes[ray], wbuf, bbuf)
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
                                  'encmlp_fwd_tf': 0, 'encmlp_dual_fwd_tf': 0,
                                  'encmlp_bwd_tf': 0, 'encmlp_dual_bwd_tf': 0,
                                  'vf_operand': 0, 'vf_fold': 0,
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


# (change to the flagship's statics, admitted): 6 layers and framecodes
# of 8 are built for (ROADMAP B.1), so are 512-wide nets (with their
# 256-wide views layer), 9 and 16 layers and 10 kp bands (B.1.2), 11
# and 21 view rows and framecodes of 32 and 128 (B.1.3), and WIDE nets,
# 768 wide with a 384-wide views layer (B.1.4's first part), and 11 kp
# bands up to the cap F_MAX (B.1.4's kp-band row), and deep nets, 17-32
# layers at 256 wide, 17-24 at 512 and 9-16 WIDE (B.1.4's depth rows); a
# net 512 wide with a 128-wide views layer, another skip, 2304 wide (the
# headers' cap), one layer past each depth cap (33 at 256 wide, 25 at
# 512, 17 WIDE), 23 view rows and framecodes of 144 are not (B.1.4), nor
# is F_MAX + 1 kp bands (past which anerf_tpu's band recurrence no longer
# holds to the model: C.17)
KP10 = tuple(2. ** k for k in range(10))
KP_MAX = tuple(2. ** k for k in range(FE.F_MAX))
GATE_CASES = [(dict(width=512), False), (dict(depth=6), True),
              (dict(skips=(3,)), False), (dict(vparts=(648, 8)), True),
              (dict(depth=9), True), (dict(vparts=(648, 32)), True),
              (dict(width=512, half=256), True), (dict(depth=16), True),
              (dict(kp_freqs=KP10, dparts=(21 * J, 3 * J)), True),
              (dict(width=768, half=384), True),
              (dict(depth=FE.kernel_depths(256)[-1] + 1), False),
              (dict(width=2304, half=1152), False),
              (dict(kp_freqs=KP10 + (1024.,), dparts=(23 * J, 3 * J)),
               True),
              (dict(view_nb=11, vparts=(11 * 3 * J, 16)), True),
              (dict(width=512, half=256, vparts=(648, 32)), True),
              (dict(view_nb=21, vparts=(21 * 3 * J, 128)), True),
              (dict(vparts=(648, 144)), False),
              (dict(view_nb=23, vparts=(23 * 3 * J, 16)), False),
              (dict(kp_freqs=KP_MAX, dparts=((2 * FE.F_MAX + 1) * J,
                                             3 * J)), True),
              (dict(kp_freqs=KP_MAX + (2. ** FE.F_MAX,),
                    dparts=((2 * FE.F_MAX + 3) * J, 3 * J)), False),
              (dict(depth=17), True), (dict(depth=24), True),
              (dict(depth=FE.kernel_depths(256)[-1]), True),
              (dict(width=512, half=256, depth=24), True),
              (dict(width=512, half=256, depth=FE.kernel_depths(512)[-1]),
               True),
              (dict(width=512, half=256,
                    depth=FE.kernel_depths(512)[-1] + 1), False),
              (dict(width=1024, half=512, depth=9), True),
              (dict(width=1024, half=512, depth=16), True),
              (dict(width=1024, half=512,
                    depth=FE.kernel_depths(1024)[-1] + 1), False),
              (dict(width=2048, half=1024,
                    depth=FE.kernel_depths(2048)[-1]), True),
              (dict(width=2048, half=1024,
                    depth=FE.kernel_depths(2048)[-1] + 1), False)]


@pytest.mark.parametrize('change,admitted', GATE_CASES)
def test_kernel_shape_gate(scene, change, admitted):
    """The CUDA kernels are compiled per static shape for every shape
    of the gate (a multiple of 256 up to 2048 wide, 1-32 layers at 256
    wide, 1-24 at 512 and 1-16 wider, 1 to F_MAX kp bands, 1-21 view rows,
    codes of at most 128); any other
    static must be refused before
    a launch, never run wrong: a shape still to port names ROADMAP
    B.1.4, the kp bands past F_MAX the convention C.17.  A change to
    ``kp_freqs`` or ``view_nb`` changes the encode's statics, the rest
    the net's."""
    pts = torch.as_tensor(_pts_cm(scene['batch'], 16))
    st, est = FE._build_call(scene['t_rc'], pts,
                             torch.as_tensor(scene['rays_t_norm']),
                             scene['t_params']['cutoff_dist'], 21.9,
                             torch.as_tensor(scene['batch']['cam_idxs']),
                             None)[:2]
    assert FE.kernel_shape(st, est) == (7, 9, False, 8, 256, 16)
    enc_keys = {'kp_freqs', 'view_nb'}
    changed = dataclasses.replace(
        st, **{k: v for k, v in change.items() if k not in enc_keys})
    est_c = dataclasses.replace(
        est, **{k: v for k, v in change.items() if k in enc_keys})
    if admitted:
        assert FE.kernel_shape(changed, est_c) == (
            len(est_c.kp_freqs), est_c.view_nb, False, changed.depth,
            changed.width, FE.kernel_codes(changed.vparts[1]))
    else:
        cap = len(est_c.kp_freqs) > FE.F_MAX
        deep = changed.depth > FE.kernel_depths(changed.width)[-1]
        with pytest.raises(NotImplementedError, match=(
                'recurrence no longer holds.*C.17' if cap
                else 'per-tile sums are not held.*ROADMAP.md B.1.4'
                if deep else 'not ported yet.*ROADMAP.md B.1.4')):
            FE.kernel_shape(changed, est_c)
