"""K3/K4's twins at the static shapes the fused encode kernels are built
for beyond the flagship's (ROADMAP B.1), against anerf_tpu's Pallas
custom_vjps on the CPU: the shapes, scenes and samples of
``test_torch_encmlp_shapes.py`` (one, five and seven view PE rows, four
kp bands with six layers, four layers, the windowed bone directions,
8 x 512, nine layers, eight kp bands, 16 x 512 at ten bands, eleven
kp bands and the cap F_MAX, 20 layers of 256), the
samples anerf_tpu tiles (K4 at S=64, K3 at S=16), the dense views input
on both sides.  This file holds the resident shapes' cases and those of
the kp bands past ten (both samples each),
``test_torch_encmlp_shapes_bwd_b12.py`` the other four shapes'.

The port's autograd Functions around K1/K2 reach the twins on CPU
tensors; ``jax.vjp`` of ``_fused_dual``/``_fused`` runs the Pallas
backward in interpret mode on the same operands and the same N(0, 1)
raw cotangent.  Every output (dp, denc, dcodes and the gradient of each
``flatten_params_cm`` operand) is held at the bars of
``test_torch_fused_bwd.py``: cosine > 0.9999 and norm within 5e-3 (the
bar anerf_tpu holds between its own two backward implementations,
tests/test_pallas_encmlp.py:236-237), and elementwise within 1e-3 x the
leaf's max |value| on average and 5e-2 x at its worst element.  The nets
512 wide are held at the first two alone, as test_torch_net_shapes.py
holds K6's twin at 512: each of their layers sums twice the terms, and
at S=16 (128 points) the two chains' layer-0 bias gradient of 8 x 512
differs by 1.7e-3 of its max on average, with cosine and norm within
their bars.  At the corner, 16 layers of 512 at ten kp bands, the two
f32 evaluations meet those bars no closer: the twin and the Pallas
kernel read cosines down to 0.99925 against each other on the later
layers' leaves.  There each output of the twin is held to the
Pallas kernel's within the flagship's bars or within F64_RATIO times
the sum of the two's distances from an f64 evaluation of the chain (the
twin's, every f32 input and product in f64, the bf16 roundings kept),
whichever is wider; the twin reads 0.99936 against the f64 chain on
those leaves, Pallas 0.99995, and the two sit at 0.55 of their bars.
So is the twin at 20 layers of 256 (K3's, S=16), whose cosines and
norms meet the flagship's bars but whose mean elementwise distance on
a late layer's weight gradient reads 1.16e-3 of its max.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anerf_tpu.ops import pallas_encmlp as PE

from anerf_torch.ops import fused_encmlp as FE
from anerf_torch.ops import fused_mlp as FM

from test_torch_encmlp_shapes import (B12_SHAPES, BAND_CASES, BAND_SHAPES,
                                      BWD_CASES, SHAPES, shape_scene)
from test_torch_fused_bwd import (COS_TOL, RATIO_TOL, _leaf, _operands,
                                  assert_grad_close)
from test_torch_threads import one_torch_thread  # noqa: F401

# the shapes whose bars come from the f64 chain, and the share of the two
# evaluations' distances from it that they may take from each other
F64_SHAPES = ('w512_depth16_nf10', 'depth20')
F64_RATIO = 2.


def _cos_ratio(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    na = np.linalg.norm(a)
    return a @ b / (na * np.linalg.norm(b) + 1e-30), np.linalg.norm(b) / na


def _assert_f64_close(refs, gots, f64s, name):
    """The twin's outputs ``gots`` against the Pallas outputs ``refs``,
    each within the flagship's bars or within F64_RATIO times the sum of
    the two evaluations' distances from the f64 chain ``f64s``,
    whichever is wider."""
    for i, (a, b, c) in enumerate(zip(refs, gots, f64s)):
        (ca, ra), (cb, rb) = _cos_ratio(c, a), _cos_ratio(c, b)
        assert_grad_close(
            a, b, name=f'{name} operand {i}', elementwise=False,
            cos_tol=max(COS_TOL, F64_RATIO * ((1 - ca) + (1 - cb))),
            ratio_tol=max(RATIO_TOL, F64_RATIO * (abs(ra - 1) + abs(rb - 1))))


def _f64_grads(st, est, p, enc, codes, cut, tau, flat, g):
    """K3's twin as the f64 chain: its f32 inputs in f64 (the encode
    too) and ``fused_mlp``'s products in f64 on the same bf16-rounded
    operands (scripts/check_k6_f64.py's, chip_smoke._f64_twins')."""
    from scripts.check_k6_f64 import _f64_products
    up = lambda x: x.detach().double()
    with _f64_products(FM), torch.no_grad():
        dp, denc, dc, grads = FE.encmlp_bwd_plain(
            st, est, up(p), up(enc), up(codes), cut.double(),
            torch.as_tensor(tau, dtype=torch.float64), flat, up(g))
    return [dp, denc, dc] + list(grads)


# the resident shapes; test_torch_encmlp_shapes_bwd_b12.py holds
# B12_SHAPES' cases through check_bwd_case
RESIDENT_CASES = [(n, S) for n, S in BWD_CASES
                  if n not in B12_SHAPES + BAND_SHAPES]


@pytest.mark.parametrize('name,S', RESIDENT_CASES,
                         ids=[f'{n}-{S}' for n, S in RESIDENT_CASES])
def test_bwd_twins_match_pallas_vjp(name, S):
    """K4's twin at S=64 (both nets on the coarse samples) and K3's at
    S=16 (the fine net on the importance samples)."""
    check_bwd_case(name, S)


@pytest.mark.parametrize('name,S', BAND_CASES,
                         ids=[f'{n}-{S}' for n, S in BAND_CASES])
def test_bwd_twins_match_pallas_vjp_kp_bands(name, S):
    """K4's and K3's twins at eleven kp bands and at the cap F_MAX,
    where each band doubles the recurrence's f32 rounding: the band
    pullback's terms (2^k cos, 2^k sin) reach 2^12 at F_MAX."""
    check_bwd_case(name, S)


def check_bwd_case(name, S):
    """The twins' gradients of shape ``name`` at S samples against the
    Pallas VJP (or, for F64_SHAPES, the f64 chain), as the module's
    docstring sets out."""
    s = shape_scene(name)
    nnet = 2 if S == 64 else 1
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
    for i, (a, b) in enumerate(zip(ref, got)):
        assert b.dtype == ins[i].dtype, i     # bf16 weights, f32 biases
    if name in F64_SHAPES:
        f64 = _f64_grads(st_t, est_t, p, enc, cs[1], cut_t, tau_t, flats[1],
                         torch.as_tensor(g[0]))
        _assert_f64_close([np.asarray(a, np.float32) for a in ref],
                          [b.float().numpy() for b in got],
                          [c.numpy() for c in f64], name)
        return
    for i, (a, b) in enumerate(zip(ref, got)):
        assert_grad_close(np.asarray(a, np.float32), b.float().numpy(),
                          name=f'{name} operand {i}',
                          elementwise=SHAPES[name][1][4] == 256)
