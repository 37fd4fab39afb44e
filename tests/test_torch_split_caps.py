"""K5/K6 past their former caps (ROADMAP C.16), on the CPU.

anerf_tpu's ``pallas`` backend sends every ``use_viewdirs`` net to its
split-operand kernel (``anerf_tpu/models/raycaster.py:193``;
``pallas_mlp.supported`` checks ``use_viewdirs`` alone), and K1-K4 refuse
the shapes below, so on the card the split route (K5/K6) is their only
route.  K5/K6 used to raise past 64 layers, 2048 columns, depth x width
65,536, a trunk of 2048 columns and a views width of 1664; their
schedules now compute each segment from its index instead of building
tables that grew with the net, and they take every net and input width
up to the ceilings past which K6's workspace for the train step's
131,072 points outgrows the card (``fused_mlp.kernel_refusal``): 128
layers, 4096 wide, depth x width 262,144, trunk and views widths of
4096.  Here:

* the gate, asked without a launch: each shape past the old caps is
  admitted, and the first value past each ceiling is refused with its
  cap named;
* the library keys and nvcc defines of the new shapes, every earlier
  key unchanged;
* the schedules' coverage checks (``ring.cuh`` ``covers``: every weight
  block on its tensor map, pairwise disjoint, covering each pack) parsed
  at the ceilings with libclang, and caught failing on a copy of the
  sources whose schedule misses or repeats blocks;
* the twins against anerf_tpu's XLA path (``nerf_forward`` and
  ``jax.vjp``) at the cheapest shape of each axis, 32 points, at
  ``test_torch_net_shapes.py``'s bars (raw mean |d| < 1e-3 and worst <
  2e-2 of each channel's max; every cotangent and gradient at cosine >
  0.9999 and norm within 5e-3); 65 layers against anerf_tpu's chain in
  f64, which the twin evaluated in f64 equals and anerf_tpu's XLA path
  meets at fixed bars;
* the packs read back at a 2200-wide net's 2304-wide build and at a
  views width of 1792, as ``test_padded_pack_runs_as_the_net`` reads
  them: the operands, zeros in the padding, and the twin at the packed
  shape, its products in float64, within 1e-9 of the net's raw rows and
  at cosine 1 - 1e-12 of its gradients;
* the route: ``render_rays`` on the fused backend takes the split MLP
  (``nerf_mlp_fused``) with the gate admitting every call, and none of
  K1-K4, for ``surreal.txt`` at ``netwidth = 2304``, at 41 kp bands and
  at ``multires_views = 11`` with framecodes, and for the two-subject
  model at 23 view rows.
"""
import os
import re
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anerf_tpu.models import nerf_mlp as NM
from anerf_tpu.models.nerf_mlp import nerf_forward as j_forward

from anerf_torch import testing_utils as T
from anerf_torch.models import raycaster as trc
from anerf_torch.models.factory import build_raycast_config as t_build
from anerf_torch.models.factory import embed_state as t_embed_state
from anerf_torch.models.factory import init_raycaster_params as t_init
from anerf_torch.ops import cuda_build
from anerf_torch.ops import fused_encmlp as FE
from anerf_torch.ops import fused_mlp as FM
from anerf_torch.training.trainer import tree_leaves

from test_torch_csrc_parse import CSRC, _errors, _parse
from test_torch_csrc_parse import mock_include  # noqa: F401
from test_torch_fused_bwd import assert_grad_close
from test_torch_net_shapes import _assert_raw_close, _inputs, _net
from test_torch_threads import one_torch_thread  # noqa: F401

DPARTS, VPARTS = (360, 72), (648, 16)
N = 32
POSE_KEYS = ('kps', 'skts', 'bones', 'cyls')


def _st(depth, width, dparts=DPARTS, vparts=VPARTS):
    return FM.MLPStatic(depth, width, dparts, vparts, width // 2, (4,))


# the shapes past the former caps that the gate now admits: (depth, width,
# trunk parts, views parts); the ceilings among them
ADMITTED = {
    'w2304': (8, 2304, DPARTS, VPARTS),
    'w4096': (8, 4096, DPARTS, VPARTS),
    'd65': (65, 256, DPARTS, VPARTS),
    'd128': (128, 256, DPARTS, VPARTS),
    'd128w2048': (128, 2048, DPARTS, VPARTS),
    'd40w2048': (40, 2048, DPARTS, VPARTS),
    'd64w4096': (64, 4096, DPARTS, VPARTS),
    'w4000': (64, 4000, DPARTS, VPARTS),      # run at 4096
    'dx2064': (8, 256, (1992, 72), VPARTS),   # 41 reldist kp bands
    'dx4096': (8, 256, (4024, 72), VPARTS),
    'xv1792': (8, 256, DPARTS, (1656, 128)),  # 23 view rows, codes 128
    'ms_xv23': (8, 256, DPARTS, (1656, 1, 16)),
    'xv4096': (8, 256, DPARTS, (3960, 128)),
}
# the first value past each ceiling, and the cap its refusal names
REFUSED = {
    'width 4097': (_st(8, 4097), '4096 columns'),
    'depth 129': (_st(129, 256), 'at most 128 layers'),
    'depth 65 x 4096': (_st(65, 4096), 'width (rounded up to 256) 262144'),
    'depth 129 x 2048': (_st(129, 2048), 'at most 128 layers'),
    'trunk 4097': (_st(8, 256, (4025, 72)), 'at most 4096'),
    'views 4089': (_st(8, 256, DPARTS, (3961, 128)), 'views width of 4096'),
}


@pytest.mark.parametrize('name', list(ADMITTED))
def test_gate_admits_past_the_old_caps(name):
    depth, width, dparts, vparts = ADMITTED[name]
    st = _st(depth, width, dparts, vparts)
    assert FM.kernel_refusal(st) is None
    FM._check_kernel_shape(st)
    stk = FM.kernel_static(st)
    assert stk.width % 256 == 0 and stk.width <= 4096
    assert stk.depth * stk.width <= 262144


@pytest.mark.parametrize('name', list(REFUSED))
def test_gate_refuses_past_each_ceiling(name):
    """Refused before any build or launch, naming the cap and ROADMAP
    C.16; ``_check_kernel_shape`` raises the same words."""
    st, cap = REFUSED[name]
    why = FM.kernel_refusal(st)
    assert why is not None and cap in why and 'ROADMAP.md' in why
    with pytest.raises(NotImplementedError, match=re.escape(why)):
        FM._check_kernel_shape(st)


def test_library_keys_of_the_new_shapes():
    """A key and the nvcc defines per new (trunk width, depth, compiled
    width, views width); every earlier key and flag as it was."""
    key = cuda_build.lib_key
    flags = cuda_build._shape_flags
    net = lambda d, w: [f'-DANERF_DEPTH={d}', f'-DANERF_WIDTH={w}',
                        '-DANERF_SKIP=4']
    # earlier keys
    assert key('mlp_fwd') == ('mlp_fwd', 432)
    assert key('mlp_bwd', 1152) == ('mlp_bwd', 1152)
    assert key('mlp_fwd', 432, 8, 1024) == ('mlp_fwd', 432, 8, 1024)
    assert key('mlp_bwd', 432, 8, 256, xv=1664) == \
        ('mlp_bwd', 432, 8, 256, 1664)
    assert flags(('mlp_fwd', 432)) == ['-DANERF_DX=432']
    # the new ones
    cases = {
        'w2304': (('mlp_bwd', 432, 8, 2304),
                  ['-DANERF_DX=432', *net(8, 2304)]),
        'w4000': (('mlp_bwd', 432, 64, 4096),
                  ['-DANERF_DX=432', *net(64, 4096)]),
        'd128': (('mlp_bwd', 432, 128, 256),
                 ['-DANERF_DX=432', *net(128, 256)]),
        'dx2064': (('mlp_bwd', 2064), ['-DANERF_DX=2064']),
        'xv1792': (('mlp_bwd', 432, 8, 256, 1792),
                   ['-DANERF_DX=432', '-DANERF_DXV=1792']),
        'xv4096': (('mlp_bwd', 432, 8, 256, 4096),
                   ['-DANERF_DX=432', '-DANERF_DXV=4096']),
    }
    for name, (want, want_flags) in cases.items():
        depth, width, dparts, vparts = ADMITTED[name]
        st = _st(depth, width, dparts, vparts)
        got = key('mlp_bwd', st.dnet, st.depth, FM.kernel_static(st).width,
                  xv=st.xv_pad)
        assert got == want, name
        assert flags(got) == want_flags, name
    assert cuda_build._tag(('mlp_fwd', 432, 64, 4096)) == \
        'mlp_fwd_dx432_d64w4096'


# the ceilings' builds (-D defines) whose schedules the coverage checks
# walk: 64 x 4096 at the widest trunk and views inputs, 128 x 2048, and
# 128 layers with a 41-band trunk and 23 view rows
CEILINGS = [
    ['ANERF_DX=4096', 'ANERF_DXV=4096', 'ANERF_DEPTH=64', 'ANERF_WIDTH=4096'],
    ['ANERF_DX=432', 'ANERF_DEPTH=128', 'ANERF_WIDTH=2048'],
    ['ANERF_DX=2064', 'ANERF_DXV=1792', 'ANERF_DEPTH=128',
     'ANERF_WIDTH=256'],
]
# edits that break a schedule (source, text, replacement, the check that
# must catch it): the forward's segment count one short, the backward's
# trunk walk without the skip layer's chunks, and its chunks' ragged map
# at the first row
BROKEN = {
    'fwd-count': ('mlp_fwd_common.cuh',
                  'constexpr int NFSEG = (WIDE ? 2 * NVB : 2) + NBLK * 2 '
                  '+ NTRUNK;',
                  'constexpr int NFSEG = (WIDE ? 2 * NVB : 2) + NBLK * 2 '
                  '+ NTRUNK - 1;',
                  'mlp_fwd.cu', 'the forward schedule must cover'),
    'bwd-skip-chunks': ('mlp_bwd_common.cuh',
                        '      if (i >= a + NXC) i -= NXC;', '',
                        'mlp_bwd.cu', 'the backward must cover'),
    'bwd-tail-map': ('mlp_bwd_common.cuh',
                     ': MapSpec{1, 0, W, tail_rows(DXP)};',
                     ': MapSpec{1, 8, W, tail_rows(DXP)};',
                     'mlp_bwd.cu', 'must cover'),
}


@pytest.mark.parametrize('defines', CEILINGS,
                         ids=['64x4096', '128x2048', '128x256'])
@pytest.mark.parametrize('source', ['mlp_fwd.cu', 'mlp_bwd.cu'])
def test_schedules_cover_the_packs_at_the_ceilings(source, defines,
                                                   mock_include):
    """The coverage checks are static_asserts over the computed
    segments: they hold at the ceilings (libclang evaluates them as nvcc
    would)."""
    cindex, tu = _parse(os.path.join(CSRC, source), mock_include,
                        [*defines, 'ANERF_SKIP=4'])
    assert not _errors(cindex, tu), '\n'.join(_errors(cindex, tu))


@pytest.mark.parametrize('name', list(BROKEN))
def test_coverage_checks_catch_a_broken_schedule(name, mock_include,
                                                 tmp_path):
    """A copy of the sources with one schedule edit fails its coverage
    check at 128 x 2048: the check walks every segment, not a sample."""
    header, old, new, source, message = BROKEN[name]
    copy = tmp_path / 'csrc'
    shutil.copytree(CSRC, copy)
    text = (copy / header).read_text()
    assert text.count(old) == 1
    (copy / header).write_text(text.replace(old, new))
    cindex, tu = _parse(str(copy / source), mock_include,
                        ['ANERF_DX=1152', 'ANERF_DEPTH=128',
                         'ANERF_WIDTH=2048', 'ANERF_SKIP=4'])
    failed = [e for e in _errors(cindex, tu) if 'static assertion' in e]
    assert any(message in e for e in failed), failed


# the cheapest shape of each axis past the old caps: (depth, width,
# trunk parts, views parts)
TWINS = {'2x2304': (2, 2304, DPARTS, VPARTS),
         '65x256': (65, 256, DPARTS, VPARTS),
         'trunk2064': (2, 256, (1992, 72), VPARTS),
         'views1792': (2, 256, DPARTS, (1656, 128))}
# past this depth (chip_smoke.DEEP_NET_LAYERS) two f32 evaluations of the
# bf16 chain part by more than the flagship's bars, so a deep net is held
# to the chain's f64 evaluation (chip_smoke._check_bwd_f64's rule)
DEEP = 24
DEEP_F64_RATIO = 2.
# how far anerf_tpu's XLA path in f32 may sit from its chain in f64 at
# 65 x 256 on 32 points (raw mean and worst |d| of each channel's max;
# 1 - cosine of every cotangent and gradient): twice the readings on
# this file's inputs (alpha 1.44e-3 and 2.58e-2; 1 - cos 1.89e-3)
XLA_F64_BARS = (3e-3, 5e-2, 4e-3)
# the twin's f64 evaluation against the chain's: the same products and
# roundings, summed in another order (readings: raw 0; gradients within
# 1 - cos 1e-15, their norms within 1.7e-7, the f32 biases')
F64_COS, F64_NORM = 1e-9, 1e-6
_b16 = lambda a: a.astype(jnp.bfloat16).astype(jnp.float64)


@jax.custom_vjp
def _dot64(x, w):
    """anerf_tpu's ``_dense`` product in f64: bf16 operands summed in
    float64."""
    return jnp.dot(_b16(x), _b16(w), preferred_element_type=jnp.float64)


def _dot64_fwd(x, w):
    return _dot64(x, w), (x, w)


def _dot64_bwd(res, g):
    """The split kernel's rounding points (``pallas_encmlp._mlp_bwd_tile``):
    the product's cotangent rounded to bf16 before it feeds either
    product; the input's cotangent passed on unrounded."""
    x, w = res
    gb = _b16(g)
    return (jnp.dot(gb, _b16(w).T, preferred_element_type=jnp.float64),
            jnp.dot(_b16(x).T, gb, preferred_element_type=jnp.float64))


_dot64.defvjp(_dot64_fwd, _dot64_bwd)


def _chain64(j_params, j_cfg, xs, xvs, g, monkeypatch):
    """anerf_tpu's net (``nerf_forward``: its layers, skip, heads and
    views branch) and ``jax.vjp`` in float64, independent of the port:
    each ``_dense`` takes bf16-rounded operands summed in f64, with the
    split kernel's rounding points.  The gradients come back as the
    kernel returns them (``pallas_mlp.py:503``): the parts' cotangents
    and the weights' gradients in bf16, the biases' in f32."""
    with monkeypatch.context() as m, jax.enable_x64(True):
        m.setattr(NM, '_dense', lambda p, x, dt: _dot64(x, p['w']) + p['b'])
        c64 = lambda a: jnp.asarray(np.asarray(a, np.float64))

        def fn(p, xs, xvs, g):
            out, vjp = jax.vjp(lambda p, xs, xvs: j_forward(
                p, j_cfg, jnp.concatenate(xs, -1), xvs[0], codes=xvs[1]),
                p, xs, xvs)
            return out, vjp(g)
        out, (dp, dxs, dxvs) = jax.jit(fn)(
            jax.tree_util.tree_map(c64, j_params), [c64(x) for x in xs],
            [c64(x) for x in xvs], c64(g))
        grads = ([_b16(a) for a in list(dxs) + list(dxvs)]
                 + [_b16(a) if a.ndim == 2 else a.astype(jnp.float32)
                    for a in jax.tree_util.tree_leaves(dp)])
        return (np.asarray(out), [np.asarray(a, np.float64) for a in grads])


def _twin_run(t_params, t_cfg, xs, xvs, g):
    """The twins' raw rows and the gradients of every part and leaf."""
    txs = [torch.tensor(x, requires_grad=True) for x in xs]
    txvs = [torch.tensor(x, requires_grad=True) for x in xvs]
    leaves = tree_leaves(t_params)
    for t in leaves:
        t.requires_grad_(True)
    out = FM.nerf_mlp_fused(t_params, t_cfg, txs, txvs)
    got = torch.autograd.grad(out, txs + txvs + leaves,
                              torch.as_tensor(g, dtype=out.dtype))
    return (out.detach().double().numpy(),
            [x.detach().double().numpy() for x in got])


def _cos(a, b):
    a, b = a.ravel(), b.ravel()
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-300)


def _raw_dist(ref, got):
    """(mean, worst) |d| of each channel over the channel's max."""
    d = [np.abs(got[:, c] - ref[:, c]) / np.abs(ref[:, c]).max()
         for c in range(ref.shape[-1])]
    return np.array([x.mean() for x in d]), np.array([x.max() for x in d])


@pytest.mark.parametrize('name', list(TWINS))
def test_twins_match_anerf_tpu_xla(name, monkeypatch):
    """Forward and backward of the twins (``nerf_mlp_fused``: K5's and,
    through ``_FusedMLP``, K6's) against anerf_tpu, the gate admitting
    the shape: up to DEEP layers against anerf_tpu's XLA path at the
    flagship's bars.  Past DEEP layers (65 x 256) two f32 evaluations of
    the chain at 32 points (anerf_tpu's XLA path and the twin; anerf_tpu's
    Pallas kernel too) part by more than those bars, each on other
    outputs: a bf16 rounding or a ReLU mask flips with the f32 summation
    order, and at this depth few points carry each sum.  So there the
    twin is held to anerf_tpu's chain in f64 (``_chain64``:
    ``nerf_forward`` and ``jax.vjp``), as the card holds deep nets
    (``chip_smoke._check_bwd_f64``).  First its structure: evaluated in
    f64 (``fused_mlp._dot`` on the same bf16 operands in float64) the
    twin gives the chain to f64 rounding, so a wrong layer, skip, mask
    or head fails.  Then in f32: anerf_tpu's XLA path within the fixed
    ``XLA_F64_BARS`` of the chain, and the twin within the flagship's
    bars or twice XLA's distance, raw rows per channel and gradients
    alike."""
    depth, width, dparts, vparts = TWINS[name]
    assert FM.kernel_refusal(_st(depth, width, dparts, vparts)) is None
    j_params, t_params, j_cfg, t_cfg = _net(depth, width, dparts, vparts)
    xs, xvs = _inputs(depth, dparts, vparts, N)
    g = np.random.RandomState(width).normal(size=(N, 4)).astype(np.float32)

    def ref_fn(p, xs, xvs, g):
        fn = lambda p, xs, xvs: j_forward(
            p, j_cfg, jnp.concatenate(xs, -1), xvs[0], codes=xvs[1])
        out, vjp = jax.vjp(fn, p, xs, xvs)
        return out, vjp(g)
    ref, (dparams, dxs, dxvs) = jax.jit(ref_fn)(
        j_params, [jnp.asarray(x) for x in xs],
        [jnp.asarray(x) for x in xvs], jnp.asarray(g))
    ref = np.asarray(ref, np.float64)
    refs = [np.asarray(a, np.float64) for a in
            list(dxs) + list(dxvs) + jax.tree_util.tree_leaves(dparams)]
    out, got = _twin_run(t_params, t_cfg, xs, xvs, g)
    assert len(got) == len(refs)
    if depth <= DEEP:
        _assert_raw_close(ref, out, 1e-3, 2e-2)
        for i, (a, b) in enumerate(zip(refs, got)):
            assert_grad_close(a.astype(np.float32), b, name=f'operand {i}',
                              elementwise=False)
        return
    chain, chain_g = _chain64(j_params, j_cfg, xs, xvs, g, monkeypatch)
    with monkeypatch.context() as m:
        m.setattr(FM, '_dot', lambda a, w: (
            a.to(torch.bfloat16).double() @ w.to(torch.bfloat16).double()))
        out64, got64 = _twin_run(t_params, t_cfg, xs, xvs, g)
    assert out64.dtype == chain.dtype == np.float64
    _assert_raw_close(chain, out64, 1e-9, 1e-9)
    for i, (a, b) in enumerate(zip(chain_g, got64)):
        # deep layers' gradients vanish (1e-12 in norm at 65 x 256), so
        # no absolute floor: zeros where the chain's are zero, else the
        # cosine and the norm's ratio
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        assert (na == nb == 0) or (1 - _cos(a, b) <= F64_COS
                                   and abs(nb / na - 1) <= F64_NORM), \
            (i, na, nb)
    mean_xla, worst_xla = _raw_dist(chain, ref)
    mean_twin, worst_twin = _raw_dist(chain, out)
    xla = max(1 - _cos(a, b) for a, b in zip(chain_g, refs))
    twin = max(1 - _cos(a, b) for a, b in zip(chain_g, got))
    assert all(a <= b for a, b in zip(
        (mean_xla.max(), worst_xla.max(), xla), XLA_F64_BARS)), \
        (mean_xla, worst_xla, xla)
    bar = lambda flagship, d: np.maximum(flagship, DEEP_F64_RATIO * d)
    assert (worst_twin <= bar(2e-2, worst_xla)).all(), (worst_twin, worst_xla)
    assert (mean_twin <= bar(1e-3, mean_xla)).all(), (mean_twin, mean_xla)
    assert twin <= max(1e-4, DEEP_F64_RATIO * xla), (twin, xla)


# (net, its packs' shape): a 2200-wide net at its 2304-wide build, and
# views parts of 1784 columns at a views width of 1792
PACKS = {'2x2200@2304': ((2, 2200, DPARTS, VPARTS), (2304, 672)),
         'views1792': ((2, 256, DPARTS, (1656, 128)), (256, 1792))}


@pytest.mark.parametrize('name', list(PACKS))
def test_packs_read_back_at_the_build(name, monkeypatch):
    """The packs hold the net's operands and zeros at the build's shape;
    read back (the backward pack through ``_unpack_grads`` at the build)
    and run through the twins there, they give the net's raw rows and
    gradients, the padding's gradients zero and dropped.  Both twins run
    their products in float64 (``fused_mlp._dot`` on the same bf16
    operands): the padding adds exact zeros, so the two agree to f64
    rounding (1e-9 of the scale), where in f32 the longer sums' other
    order moves a bf16 rounding now and then (2200 to 2304 wide: 8.6e-6
    of the scale in mean)."""
    (depth, width, dparts, vparts), (built, xv_pad) = PACKS[name]
    st = _st(depth, width, dparts, vparts)
    stk = FM.kernel_static(st)
    assert (stk.width, stk.half, stk.xv_pad) == (built, built // 2, xv_pad)
    _, t_params, _, _ = _net(depth, width, dparts, vparts)
    flat = FM.flatten_params(t_params, st)
    wb = FM._pack_bwd_weights(flat, st)
    wbuf, bbuf = FM._pack_kernel_weights(flat, st)
    flat_k = FM._unpack_grads(stk, wb.float(), bbuf)
    for w, wk in zip(flat, flat_k):
        r, c = w.shape
        assert torch.equal(wk[:r, :c], w.float())
        rest = wk.clone()
        rest[:r, :c] = 0
        assert not rest.any()
    wbuf_k, bbuf_k = FM._pack_kernel_weights(flat_k, stk)
    assert torch.equal(wbuf, wbuf_k) and torch.equal(bbuf, bbuf_k)
    # the views layer's views-input block, (HV, xv_pad) before the heads'
    # vectors: zeros past the parts' columns
    heads = stk.width + 3 * stk.half
    wvx = wbuf[-heads - stk.half * xv_pad:-heads].view(stk.half, xv_pad)
    assert not wvx[:, sum(vparts):].any()
    assert torch.equal(wvx[:st.half, :sum(vparts)].float().t(),
                       torch.cat(flat[-len(vparts) - 3:-3]).float())

    monkeypatch.setattr(FM, '_dot', lambda a, w: (
        a.to(torch.bfloat16).double() @ w.to(torch.bfloat16).double()))
    xs, xvs = (list(map(torch.as_tensor, a))
               for a in _inputs(depth + 1, dparts, vparts, N))
    ref = FM.mlp_fwd_plain(st, xs, xvs, flat)
    got = FM.mlp_fwd_plain(stk, xs, xvs, flat_k)
    assert ref.dtype == got.dtype == torch.float64
    _assert_raw_close(ref.numpy(), got.numpy(), 1e-9, 1e-9)
    g = torch.as_tensor(np.random.RandomState(7).normal(size=(N, 4)),
                        dtype=torch.float32)
    gx, gxv, grads = FM._mlp_bwd_tile(st, xs, xvs, flat, g)
    gx_k, gxv_k, grads_k = FM._mlp_bwd_tile(stk, xs, xvs, flat_k, g)
    dw = torch.zeros(wb.numel(), dtype=torch.float64)
    db = torch.zeros(bbuf.numel(), dtype=torch.float64)
    for gr, (kind, off, shape) in zip(grads_k, FM._grad_layout(stk)):
        (dw if kind == 'w' else db)[off:off + gr.numel()] = gr.reshape(-1)
    dropped = FM._unpack_grads(st, dw, db)
    for gr, gk in zip(grads, grads_k):
        r, c = gr.shape
        rest = gk.clone()
        rest[:r, :c] = 0
        assert not rest.any()
    for i, (a, b) in enumerate(zip(gx + gxv + grads,
                                   gx_k + gxv_k + dropped)):
        assert_grad_close(a.numpy(), b.numpy(), name=f'operand {i}',
                          cos_tol=1e-12, ratio_tol=1e-9, elementwise=False)


# configs whose nets K1-K4 refuse, over surreal.txt: (subjects,
# overrides, the split MLP's (trunk parts, views parts) of each call)
ROUTES = {
    'netwidth2304': (1, dict(netwidth=2304, netwidth_fine=2304),
                     [((360, 72), (648, 16))] * 3),
    'kp_bands41': (1, dict(multires=41),
                   [((1992, 72), (648, 16))] * 3),
    'views11_codes': (1, dict(multires_views=11),
                      [((360, 72), (1656, 16))] * 3),
    'two_subjects_views11': (2, dict(multires_views=11),
                             [((360, 72), (1656, 1, 16))] * 3),
}
R = 4


@pytest.mark.parametrize('name', list(ROUTES))
def test_route_takes_the_split_mlp(name, monkeypatch):
    """``render_rays`` on the fused backend sends each of the three MLP
    calls of a render (both nets on the coarse samples, the fine net on
    the importance samples) to the split MLP, whose gate admits it; K1-K4
    never run.  Before C.16's repair the card raised at these calls."""
    ns, over, want = ROUTES[name]
    cfg = T.surreal_config(N_rand=R, **over)
    rc = t_build(cfg, n_framecodes=9, n_subjects=ns)
    assert rc.mlp_backend == 'fused' and not FE.kernel_shape_ok(rc)
    calls = []
    inner = FM.nerf_mlp_fused

    def spy(net_params, nerf_cfg, x_parts, xv_parts):
        st = FM.MLPStatic(
            nerf_cfg.depth, nerf_cfg.width,
            tuple(p.shape[-1] for p in x_parts),
            tuple(p.shape[-1] for p in xv_parts), nerf_cfg.width // 2,
            tuple(nerf_cfg.skips))
        assert FM.kernel_refusal(st) is None, FM.kernel_refusal(st)
        calls.append((st.dparts, st.vparts))
        return inner(net_params, nerf_cfg, x_parts, xv_parts)
    monkeypatch.setattr(FM, 'nerf_mlp_fused', spy)
    for k in ('encmlp_fwd', 'encmlp_dual_fwd', 'encmlp_bwd',
              'encmlp_dual_bwd'):
        monkeypatch.setattr(FE, k, None)
    _, bones, _, kps, skts, cyls = T.synthetic_pose(9, n_subjects=ns)
    b = T.synthetic_batch(R, 9, kps, skts, bones, cyls, seed=1)
    kw = {}
    if ns > 1:
        kw['subject_idxs'] = torch.as_tensor(
            T.subject_of_frame(9, ns)[b['kp_idx']])
    tb = T.to_device(b, 'cpu')
    params = t_init(torch.Generator().manual_seed(0), rc, cfg)
    with torch.inference_mode():
        out = trc.render_rays(rc, params, tb['rays_o'], tb['rays_d'], 0.0,
                              1.0, {k: tb[k] for k in POSE_KEYS},
                              t_embed_state(cfg, rc, 0),
                              cam_idxs=tb['cam_idxs'], **kw)
    assert calls == want
    assert torch.isfinite(out['rgb_map']).all()
