"""K3/K4's twins at the static shapes the fused encode kernels are built
for beyond the flagship's (ROADMAP B.1), against anerf_tpu's Pallas
custom_vjps on the CPU: the shapes and scenes of
``test_torch_encmlp_shapes.py`` (one, five and seven view PE rows, four
kp bands with six layers, four layers, the windowed bone directions), the
samples anerf_tpu tiles (K4 at S=64, K3 at S=16), the dense views input
on both sides.

The port's autograd Functions around K1/K2 reach the twins on CPU
tensors; ``jax.vjp`` of ``_fused_dual``/``_fused`` runs the Pallas
backward in interpret mode on the same operands and the same N(0, 1)
raw cotangent.  Every output (dp, denc, dcodes and the gradient of each
``flatten_params_cm`` operand) is held at the bars of
``test_torch_fused_bwd.py``: cosine > 0.9999 and norm within 5e-3 (the
bar anerf_tpu holds between its own two backward implementations,
tests/test_pallas_encmlp.py:236-237), and elementwise within 1e-3 x the
leaf's max |value| on average and 5e-2 x at its worst element.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anerf_tpu.ops import pallas_encmlp as PE

from anerf_torch.ops import fused_encmlp as FE

from test_torch_encmlp_shapes import SHAPES, shape_scene
from test_torch_fused_bwd import _leaf, _operands, assert_grad_close


@pytest.mark.parametrize('S', [64, 16])
@pytest.mark.parametrize('name', sorted(SHAPES))
def test_bwd_twins_match_pallas_vjp(name, S):
    """K4's twin at S=64 (both nets on the coarse samples) and K3's at
    S=16 (the fine net on the importance samples)."""
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
        assert_grad_close(np.asarray(a, np.float32), b.float().numpy(),
                          name=f'{name} operand {i}')
