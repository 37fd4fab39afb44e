"""The per-ray view factorization (viewfac) of the fused kernels against
anerf_tpu on the CPU.

viewfac is on by default, and the cost gate that the port copies from
``pallas_encmlp._build_call`` turns it on for the coarse pass (S = 64,
a 512-point TPU tile: K2/K4 on the flagship).  Every comparison here
asserts that ``est.viewfac`` holds on both sides, so none is vacuous.

* ``fused_mlp.viewfac_operand`` / ``_viewfac_dot`` / ``_viewfac_bwd``
  against ``pallas_mlp``'s on the same arrays: bf16 operands equal, f32
  results within 1e-5 of their scale (only f32 summation order
  differs);
* the plain twins of K-vf1 (``vf_operand_plain``: M) and of K-vf2
  (``vf_fold_plain`` of the Gram matrices ``vf_gram_plain``, K4's pass:
  dWvx and denc) against ``_viewfac_dot``'s M and ``_viewfac_bwd``'s dWv
  and d_enc, at S = 64 and at a ragged S = 48 whose rays straddle
  64-point tiles: M's values equal but for 1e-3 of them one bf16 step
  off (f32 sums in another order), within 8e-3 of M's scale; dWv and
  d_enc within 2e-3 of their scale (Gw's bf16 rounding after sums in
  another order);
* ``encmlp_dual_fwd`` and ``encmlp_fwd`` (K2's and K1's twins, through
  their autograd Functions, whose backwards are K4's and K3's twins)
  against the Pallas custom_vjps ``_fused_dual`` / ``_fused`` in
  interpret mode with viewfac on: raw rows within 1e-3 of each
  channel's scale on average and 2e-2 at the worst point
  (tests/test_pallas_encmlp.py:53), and dp, denc, dcodes and every
  weight gradient at cosine > 0.9999 and norm ratio within 5e-3
  (:236-237);
* the port's viewfac against its own dense form through the whole fused
  ``render_rays``, at anerf_tpu's bars between the two chains
  (tests/test_pallas_encmlp.py:57-80, 166-200): rgb within 2e-2 of its
  scale, acc and disparity within 1e-5; gradients at cosine > 0.998 and
  norm within 3%;
* the K-vf1 and K-vf2 wrappers taking their twins on CPU tensors and
  counting no launch;
* K-vf1's and K-vf2's work as ``vf_cost`` counts it (bf16 products on
  the tensor cores, so both are bound by their bytes at the train
  step's R = 2048), and K-vf2's plan (``vf_fold_plan``): every ray in
  exactly one slice, each partial's slices in order, the partial sums'
  bytes under half of Gw's.
"""
import os
import sys

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from test_torch_fused_bwd import (_leaf, _operands, assert_grad_close,  # noqa: F401
                                  scene)
from test_torch_render_grads import _render_loss_t

from anerf_tpu.ops import pallas_encmlp as PE
from anerf_tpu.ops import pallas_mlp as PM

from anerf_torch import testing_utils as T
from anerf_torch.models import raycaster as trc
from anerf_torch.models.factory import embed_state as t_embed_state
from anerf_torch.ops import fused_encmlp as FE
from anerf_torch.ops import fused_mlp as FM

from test_torch_threads import one_torch_thread  # noqa: F401

J, NBJ, HALF = 24, 648, 128
# the views layer's widths K-vf1/K-vf2 are built for: 128 (nets 256 wide)
# and 256 (512 wide)
HALVES = (128, 256)
F32_TOL = 1e-5


def _close(ref, got, tol=F32_TOL, name=''):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape, (name, ref.shape, got.shape)
    scale = np.abs(ref).max()
    assert scale > 0, name
    err = np.abs(ref - got).max() / scale
    assert err < tol, (name, err)


def _arrays(S, R=8, seed=0, half=HALF):
    """Windows (n, J) in (0, 1), view rows (R, 648), the views weight's
    view rows (648, half) and a views cotangent (n, half), from numpy."""
    rng = np.random.RandomState(seed)
    n = R * S
    w = rng.uniform(0, 1, (n, J)).astype(np.float32)
    enc = rng.uniform(-1, 1, (R, NBJ)).astype(np.float32)
    wv = (rng.normal(size=(NBJ, half)) / np.sqrt(NBJ)).astype(np.float32)
    g = rng.normal(size=(n, half)).astype(np.float32)
    wv = np.asarray(jnp.asarray(wv).astype(jnp.bfloat16).astype(jnp.float32))
    return w, enc, wv, g


def _jax_fac(w, enc, S):
    R = enc.shape[0]
    return PM.viewfac_operand(jnp.asarray(w), jnp.asarray(enc), R, S)


def _est(S):
    return FE.EncStatic(J=J, kp_freqs=tuple(2. ** k for k in range(7)),
                        view_nb=9, S=S, rpt=512 // S, has_codes=True,
                        viewfac=True)


@pytest.mark.parametrize('half', HALVES)
@pytest.mark.parametrize('S', [64, 48])
def test_viewfac_products_match_pallas_mlp(S, half):
    """The port's operand, its product and its backward against
    pallas_mlp's block-diagonal forms over the same rays."""
    w, enc, wv, g = _arrays(S, half=half)
    R, n = enc.shape[0], w.shape[0]
    jfac = _jax_fac(w, enc, S)
    tfac = FM.viewfac_operand(torch.as_tensor(w), torch.as_tensor(enc), S)
    # bf16 operands equal: xw[t, (r, j)] is w[t, j] on point t's ray, E
    # the view rows on their joint's block
    _, xw_j, E_j = jfac[:3]
    ray = np.arange(n) // S
    xw_j = np.asarray(xw_j.astype(jnp.float32)).reshape(n, R, J)
    assert np.array_equal(xw_j[np.arange(n), ray], tfac[1].numpy())
    assert np.count_nonzero(xw_j) == np.count_nonzero(tfac[1].numpy())
    E_j = np.asarray(E_j.astype(jnp.float32)).reshape(R, J, NBJ)
    cols = np.arange(NBJ)
    assert np.array_equal(E_j[:, cols % J, cols], tfac[2].numpy())

    wv_j = jnp.asarray(wv).astype(jnp.bfloat16)
    _close(PM._viewfac_dot(jfac, wv_j),
           FM._viewfac_dot(tfac, torch.as_tensor(wv)), name='xw @ M')
    dwin_j, denc_j, dwv_j = PM._viewfac_bwd(jfac, wv_j, jnp.asarray(g))
    dwin_t, denc_t, dwv_t = FM._viewfac_bwd(tfac, torch.as_tensor(wv),
                                            torch.as_tensor(g))
    _close(dwin_j, dwin_t, name='d_window')
    _close(denc_j, denc_t, name='d_enc')
    _close(dwv_j, dwv_t, name='dWv')


@pytest.mark.parametrize('half', HALVES)
def test_vf_operand_twin_matches_viewfac_dot(half):
    """K-vf1's twin is _viewfac_dot's M, rounded to bf16, for each net."""
    w, enc, wv, _ = _arrays(64, half=half)
    R = enc.shape[0]
    _, _, E_j = _jax_fac(w, enc, 64)[:3]
    wvx = torch.stack([torch.as_tensor(wv), -torch.as_tensor(wv)]).to(
        torch.bfloat16)
    M = FE.vf_operand_plain(_est(64), torch.as_tensor(enc), wvx)
    assert M.dtype == torch.bfloat16 and M.shape == (2, R, J, half)
    for net, sign in enumerate((1., -1.)):
        ref = PM._dot(E_j, (sign * jnp.asarray(wv)).astype(jnp.bfloat16))
        ref = np.asarray(ref.astype(jnp.bfloat16).astype(jnp.float32))
        got = M[net].float().numpy().reshape(R * J, half)
        # the f32 sums run in other orders: a bf16 rounding may flip
        assert np.mean(ref != got) < 1e-3
        _close(ref, got, tol=8e-3, name=f'M net {net}')


@pytest.mark.parametrize('half', HALVES)
@pytest.mark.parametrize('S', [64, 48])
def test_vf_fold_twin_matches_viewfac_bwd(S, half):
    """K-vf2's twin on the Gram matrices of K3/K4's pass gives
    _viewfac_bwd's dWv and d_enc (at S = 48 rays straddle the kernels'
    64-point tiles; the pass sums each ray whole)."""
    w, enc, wv, g = _arrays(S, seed=1, half=half)
    est = _est(S)
    wv_j = jnp.asarray(wv).astype(jnp.bfloat16)
    _, denc_j, dwv_j = PM._viewfac_bwd(_jax_fac(w, enc, S), wv_j,
                                       jnp.asarray(g))
    gw = FE.vf_gram_plain(est, torch.as_tensor(w), torch.as_tensor(g))
    assert gw.shape == (enc.shape[0], J, half) and gw.dtype == torch.bfloat16
    wvx = torch.as_tensor(wv)[None].to(torch.bfloat16)
    dwv, denc = FE.vf_fold_plain(est, gw[None], torch.as_tensor(enc), wvx)
    _close(dwv_j, dwv[0], tol=2e-3, name='dWv')
    _close(denc_j, denc, tol=2e-3, name='d_enc')


def test_vf_wrappers_take_twins_on_cpu():
    w, enc, wv, g = _arrays(64)
    est = _est(64)
    wvx = torch.as_tensor(wv)[None].to(torch.bfloat16)
    enc_t = torch.as_tensor(enc)
    gw = FE.vf_gram_plain(est, torch.as_tensor(w), torch.as_tensor(g))[None]
    FE.reset_launch_counts()
    M = FE.vf_operand(est, enc_t, wvx)
    dwv, denc = FE.vf_fold(est, gw, enc_t, wvx)
    counts = FE.launch_counts()
    assert counts['vf_operand'] == counts['vf_fold'] == 0
    assert torch.equal(M, FE.vf_operand_plain(est, enc_t, wvx))
    ref = FE.vf_fold_plain(est, gw, enc_t, wvx)
    assert torch.equal(dwv, ref[0]) and torch.equal(denc, ref[1])


@pytest.fixture(scope='module')
def vf_scene(scene):
    return dict(scene, j_rc=dataclasses.replace(scene['j_rc'], viewfac=True),
                t_rc=dataclasses.replace(scene['t_rc'], viewfac=True))


def _assert_raw_close(ref, got):
    ref, got = np.asarray(ref), got.detach().numpy()
    assert ref.shape == got.shape
    for c in range(ref.shape[0]):
        scale = np.abs(ref[c]).max()
        d = np.abs(ref[c] - got[c])
        assert d.mean() < 1e-3 * scale and d.max() < 2e-2 * scale, (
            c, d.mean() / scale, d.max() / scale)


@pytest.mark.parametrize('nnet,codes', [(2, True), (1, True)])
def test_encmlp_viewfac_matches_pallas_interpret(vf_scene, nnet, codes):
    """K2's (nnet 2) and K1's twins with viewfac, forward and backward,
    against anerf_tpu's Pallas kernels in interpret mode with viewfac."""
    S = 64
    jops, tops = _operands(vf_scene, S, codes)
    st_j, est_j, p_j, enc_j, c_j, cut_j, tau_j, f_j = jops
    st_t, est_t, p_t, enc_t, c_t, cut_t, tau_t, f_t = tops
    assert est_j.viewfac and est_t.viewfac
    n = p_j.shape[0]
    g = np.random.RandomState(7).normal(size=(nnet, 4, n)).astype(np.float32)
    tf = jnp.zeros((1, 1), jnp.float32)
    if nnet == 2:
        fn = lambda p, e, cc, cf, fc, ff: PE._fused_dual(
            st_j, est_j, p, e, tf, cc, cf, cut_j, tau_j, fc, ff)
        raw_j, vjp = jax.vjp(fn, p_j, enc_j, c_j[0], c_j[1], f_j[0], f_j[1])
        dp, denc, dcc, dcf, dfc, dff = vjp((jnp.asarray(g[0]),
                                            jnp.asarray(g[1])))
        ref = [dp, denc] + ([dcc, dcf] if codes else []) + dfc + dff
    else:
        fn = lambda p, e, c, f: (PE._fused(st_j, est_j, p, e, tf, c, cut_j,
                                           tau_j, f),)
        raw_j, vjp = jax.vjp(fn, p_j, enc_j, c_j[1], f_j[1])
        dp, denc, dc, df = vjp((jnp.asarray(g[0]),))
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
    for a, b in zip(raw_j, outs):
        _assert_raw_close(a, b)
    got = torch.autograd.grad(outs, ins, [torch.as_tensor(x) for x in g])
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert b.dtype == ins[i].dtype, i
        assert_grad_close(np.asarray(a, np.float32), b.float().numpy(),
                          name=f'operand {i}', elementwise=False)


def _render(scene, viewfac):
    """Maps and gradients (params, skts) of the fused ``render_rays`` with
    viewfac on or off, the draws pinned."""
    b = scene['batch']
    rng = np.random.RandomState(5)
    R, S, Si = 8, 64, 16
    fixed = {'coarse_u': rng.uniform(size=(R, S)).astype(np.float32),
             'fine_u': np.sort(rng.uniform(size=(R, Si)), -1)
             .astype(np.float32),
             'coarse_noise': rng.normal(size=(R, S)).astype(np.float32),
             'fine_noise': rng.normal(size=(R, S + Si)).astype(np.float32)}
    pose = {k: torch.as_tensor(b[k]) for k in ('kps', 'skts', 'bones',
                                                'cyls')}
    rc = dataclasses.replace(scene['t_rc'], mlp_backend='fused',
                             viewfac=viewfac)
    params = jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32), requires_grad=True),
        jax.tree_util.tree_map(np.asarray, scene['j_params']))
    skts = torch.tensor(b['skts'], requires_grad=True)
    tb = T.to_device(b, 'cpu')
    fx = {k: torch.as_tensor(v) for k, v in fixed.items()}
    est = t_embed_state(scene['cfg'], rc, 2000)
    out = trc.render_rays(rc, params, tb['rays_o'], tb['rays_d'], 0., 1.,
                          dict(pose, skts=skts), est,
                          cam_idxs=tb['cam_idxs'], fixed=fx)
    loss = _render_loss_t(rc, params, tb, est, pose, skts, fx)
    leaves = jax.tree_util.tree_leaves(params) + [skts]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return ({k: v.detach().numpy() for k, v in out.items()
             if k in ('rgb_map', 'acc_map', 'rgb0', 'acc0', 'disp_map')},
            grads)


def test_port_viewfac_matches_its_dense_form(vf_scene):
    """The port's two chains, at anerf_tpu's bars between its own."""
    _, tops = _operands(vf_scene, 64)
    assert tops[1].viewfac      # the coarse pass factorizes
    maps_d, grads_d = _render(vf_scene, False)
    maps_f, grads_f = _render(vf_scene, True)
    assert any(not np.array_equal(maps_d[k], maps_f[k])
               for k in ('rgb_map', 'rgb0')), 'viewfac did not engage'
    for k, ref in maps_d.items():
        scale = np.abs(ref).max() + 1e-6
        tol = 1e-5 if k in ('acc_map', 'acc0', 'disp_map') else 2e-2
        assert np.abs(ref - maps_f[k]).max() < tol * scale, k
    for i, (a, b) in enumerate(zip(grads_d, grads_f)):
        if a is None:
            assert b is None, i
            continue
        assert_grad_close(a.numpy(), b.numpy(), name=f'leaf {i}',
                          cos_tol=2e-3, ratio_tol=3e-2, elementwise=False)


def test_vf_cost_counts_tensor_core_products():
    """Both kernels' products take bf16 operands and f32 sums: bf16
    FLOPs, none on the CUDA cores; the bytes each input read once and
    each output written once.  At the train step's R = 2048 (two nets)
    each is bound by its bytes: 30.8 MB (9.2 us) and 36.8 MB (11.0 us)
    at the H100's 3.35 TB/s."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    est, R, nnet = _est(64), 2048, 2
    m = FE.vf_cost(est, R, nnet, HALF)
    f = FE.vf_cost(est, R, nnet, HALF, fold=True)
    assert m['f32_flops'] == f['f32_flops'] == 0.
    assert m['bf16_flops'] == 2. * nnet * R * J * 27 * HALF
    assert f['bf16_flops'] == 2 * m['bf16_flops']     # dWvx and denc
    enc, wvx, mw = R * NBJ * 4, nnet * NBJ * HALF * 2, nnet * R * J * HALF * 2
    assert m['bytes'] == enc + wvx + mw
    assert f['bytes'] == mw + enc + wvx + nnet * NBJ * HALF * 4 + R * NBJ * 4
    peaks = chip_smoke._peaks('NVIDIA H100 80GB HBM3')
    for cost, us in ((m, 9.2), (f, 11.0)):
        t_ops = cost['bf16_flops'] / peaks[0] + cost['f32_flops'] / peaks[1]
        t_bytes = cost['bytes'] / peaks[2]
        assert t_bytes > 5 * t_ops
        assert abs(1e6 * t_bytes - us) < 0.05


@pytest.mark.parametrize('R', [1, 15, 100, 215, 216, 257, 1727, 1999, 2047,
                               2048, 2049, 3001, 3072, 4100])
def test_vf_fold_plan_covers_the_rays_once(R):
    """K-vf2's plan: slices of 64 consecutive rays, the partial sums
    each over every P-th slice in order, every ray in exactly one slice
    of one partial; no partial without a slice; the partials' bytes
    written and read back under half the Gw bytes the fold reads (8
    partials at R = 2048: 5.3 MB each way against 25.2 MB)."""
    P, sl = FE.vf_fold_plan(R)
    assert sl == FE.VF_SLICE and 1 <= P <= FE.VF_PARTIALS
    nslice = -(-R // sl)
    assert P <= nslice
    seen = []
    for p in range(P):
        starts = [s * sl for s in range(p, nslice, P)]
        assert starts == sorted(starts) and starts
        seen += [np.arange(a, min(R, a + sl)) for a in starts]
    rays = np.sort(np.concatenate(seen))
    assert np.array_equal(rays, np.arange(R))
    nnet = 2
    gw_bytes = nnet * R * J * HALF * 2
    part_bytes = 0 if P == 1 else 2 * P * nnet * NBJ * HALF * 4
    assert part_bytes <= gw_bytes / 2
    if R >= 1728:
        assert P == FE.VF_PARTIALS
    if R == 2048:
        assert part_bytes == 2 * 5308416
