"""K5/K6 at every net shape that anerf_tpu's split-operand kernel runs:
any depth and width (ROADMAP C.9), up to the sizes past which K6's
workspace outgrows the card (128 layers, 4096 wide, depth x width
262,144; the shapes past the former caps, ROADMAP C.16, in
``test_torch_split_caps.py``).

The kernels are built per (trunk width, depth, width) and run a net at
its width rounded up to a multiple of 256, the packs padding every
hidden width with zeros (``fused_mlp.kernel_static``); past 512 the
activations live in device memory.  Here, on the CPU:

* the twins (``fused_mlp.nerf_mlp_fused``: K5's inside ``_FusedMLP``,
  whose backward is K6's) against anerf_tpu at each (depth, width) of
  ``SHAPES``: its Pallas kernel in interpret mode for ``PALLAS`` (1-2 s a
  call), its XLA path (``nerf_forward`` and ``jax.vjp``) for the rest.
  Bars: raw per channel mean |d| < 1e-3 and worst point < 2e-2 of the
  channel's max (tests/test_pallas_encmlp.py:53), every part cotangent
  and every weight and bias gradient at cosine > 0.9999 and norm ratio
  within 5e-3 (:236-237);
* the padded packs read back at the padded shape and the twin run on
  them: the same raw rows within 1e-6 of the scale and the same
  gradients at cosine > 0.999999 (only f32 summation order differs: the
  padding adds exact zeros), the padding's own gradients zero and
  dropped by ``_unpack_grads``;
* the gate admitting each shape, a library key per compiled shape with
  the flagship's unchanged, a 6 x 512 net's JAX parameter tree carried
  across with ``interop.params_from_numpy``, and the dW pass's plan (P
  slices of the point axis, the partials' size) pinned at the flagship,
  multi-subject and trunk-1152 shapes.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anerf_tpu.models.nerf_mlp import NeRFConfig as JNeRFConfig
from anerf_tpu.models.nerf_mlp import init_nerf_params as j_init
from anerf_tpu.models.nerf_mlp import nerf_forward as j_forward
from anerf_tpu.ops import pallas_mlp as PM

from anerf_torch.interop import params_from_numpy
from anerf_torch.models.nerf_mlp import NeRFConfig
from anerf_torch.ops import cuda_build
from anerf_torch.ops import fused_mlp as FM
from anerf_torch.training.trainer import tree_leaves

from test_torch_fused_bwd import assert_grad_close
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_threads import torch_threads_as_before  # noqa: F401

SHAPES = [(2, 64), (4, 128), (6, 256), (8, 200), (10, 256), (8, 384),
          (8, 512), (8, 1024), (6, 768), (32, 256)]
IDS = [f'{d}x{w}' for d, w in SHAPES]
PALLAS = {(4, 128), (8, 384)}
DPARTS, VPARTS = (360, 72), (648, 16)
N = 96


def _static(depth, width, dparts=DPARTS, vparts=VPARTS):
    return FM.MLPStatic(depth, width, dparts, vparts, width // 2, (4,))


@functools.lru_cache(maxsize=None)
def _j_net(depth, width, dparts, vparts):
    """anerf_tpu's config and parameters (numpy) of a net, drawn once
    for the file's tests."""
    kw = dict(depth=depth, width=width, input_ch=dparts[0],
              input_ch_bones=dparts[1], input_ch_views=vparts[0],
              use_framecode=True, framecode_ch=vparts[-1])
    j_cfg = JNeRFConfig(compute_dtype=jnp.bfloat16, **kw)
    params = j_init(jax.random.PRNGKey(depth * 1000 + width), j_cfg)
    params.pop('framecodes', None)      # the codes arrive as a part
    return j_cfg, kw, jax.tree_util.tree_map(np.asarray, params)


def _net(depth, width, dparts=DPARTS, vparts=VPARTS):
    """(JAX params, port params, JAX config, port config) of one net of
    ``depth`` x ``width`` on the parts, framecodes the last views part."""
    j_cfg, kw, params = _j_net(depth, width, tuple(dparts), tuple(vparts))
    return (jax.tree_util.tree_map(jnp.asarray, params),
            params_from_numpy(params), j_cfg, NeRFConfig(**kw))


def _inputs(seed, dparts=DPARTS, vparts=VPARTS, n=N):
    rng = np.random.RandomState(seed)
    xs = [rng.uniform(-1, 1, (n, d)).astype(np.float32) for d in dparts]
    xvs = [rng.uniform(-1, 1, (n, d)).astype(np.float32) for d in vparts]
    return xs, xvs


def _assert_raw_close(ref, got, mean_tol, max_tol):
    assert got.shape == ref.shape
    for c in range(ref.shape[-1]):
        scale = np.abs(ref[:, c]).max()
        d = np.abs(ref[:, c] - got[:, c])
        assert d.mean() <= mean_tol * scale and d.max() <= max_tol * scale, \
            (c, d.mean() / scale, d.max() / scale)


def _jax_fn(j_cfg, shape):
    """anerf_tpu's function of (params, xs, xvs): its Pallas kernel in
    interpret mode for ``PALLAS``, else its XLA path."""
    if shape in PALLAS:
        return lambda p, xs, xvs: PM.nerf_mlp_pallas(
            p, j_cfg, list(xs), list(xvs), interpret=True)
    return lambda p, xs, xvs: j_forward(
        p, j_cfg, jnp.concatenate(list(xs), -1), xvs[0], codes=xvs[1])


@pytest.mark.parametrize('depth,width', SHAPES, ids=IDS)
def test_twins_match_anerf_tpu(depth, width):
    """Forward and backward of the twins against anerf_tpu at the shape."""
    j_params, t_params, j_cfg, t_cfg = _net(depth, width)
    xs, xvs = _inputs(depth)
    g = np.random.RandomState(width).normal(size=(N, 4)).astype(np.float32)
    fn = _jax_fn(j_cfg, (depth, width))

    def fwd_bwd(p, xs, xvs, g):
        out, vjp = jax.vjp(fn, p, xs, xvs)
        return out, vjp(g)
    ref, (dparams, dxs, dxvs) = jax.jit(fwd_bwd)(
        j_params, [jnp.asarray(x) for x in xs],
        [jnp.asarray(x) for x in xvs], jnp.asarray(g))
    refs = list(dxs) + list(dxvs) + jax.tree_util.tree_leaves(dparams)

    txs = [torch.tensor(x, requires_grad=True) for x in xs]
    txvs = [torch.tensor(x, requires_grad=True) for x in xvs]
    leaves = tree_leaves(t_params)
    for t in leaves:
        t.requires_grad_(True)
    out = FM.nerf_mlp_fused(t_params, t_cfg, txs, txvs)
    _assert_raw_close(np.asarray(ref), out.detach().numpy(), 1e-3, 2e-2)
    got = torch.autograd.grad(out, txs + txvs + leaves, torch.as_tensor(g))
    assert len(got) == len(refs)
    for i, (a, b) in enumerate(zip(refs, got)):
        assert_grad_close(np.asarray(a, np.float32), b.numpy(),
                          name=f'operand {i}', elementwise=False)


def _to_layout(grads, stk):
    """Gradients of ``stk``'s ``flatten_params`` operands laid out as the
    kernels write them: (dw, db) f32 (``_grad_layout``)."""
    layout = FM._grad_layout(stk)
    n_w = max(off + s[0] * s[1] for k, off, s in layout if k == 'w')
    n_b = max(off + s[0] * s[1] for k, off, s in layout if k == 'b')
    dw, db = torch.zeros(n_w), torch.zeros(n_b)
    for gr, (kind, off, shape) in zip(grads, layout):
        (dw if kind == 'w' else db)[off:off + gr.numel()] = gr.reshape(-1)
    return dw, db


@pytest.mark.usefixtures('torch_threads_as_before')
@pytest.mark.parametrize('depth,width', SHAPES, ids=IDS)
def test_padded_pack_runs_as_the_net(depth, width):
    """The packs at the padded shape hold the net's weights and zeros;
    read back and run through the twins at that shape they give the
    net's raw rows and gradients, the padding's gradients are zero, and
    ``_unpack_grads`` drops them."""
    st = _static(depth, width)
    stk = FM.kernel_static(st)
    padded = max(256, -(-width // 256) * 256)   # the next multiple of 256
    assert (stk.depth, stk.width, stk.half) == (depth, padded, padded // 2)
    _, t_params, _, _ = _net(depth, width)
    flat = FM.flatten_params(t_params, st)
    wb = FM._pack_bwd_weights(flat, st)
    wbuf, bbuf = FM._pack_kernel_weights(flat, st)
    # the plain reader at the padded shape: the backward layout
    flat_k = FM._unpack_grads(stk, wb.float(), bbuf)
    for w, wk in zip(flat, flat_k):
        r, c = w.shape
        assert torch.equal(wk[:r, :c], w.float())
        rest = wk.clone()
        rest[:r, :c] = 0
        assert not rest.any()
    # the forward pack holds the same padded operands
    wbuf_k, bbuf_k = FM._pack_kernel_weights(flat_k, stk)
    assert torch.equal(wbuf, wbuf_k) and torch.equal(bbuf, bbuf_k)

    xs, xvs = (list(map(torch.as_tensor, a)) for a in _inputs(depth + 1))
    ref = FM.mlp_fwd_plain(st, xs, xvs, flat)
    got = FM.mlp_fwd_plain(stk, xs, xvs, flat_k)
    _assert_raw_close(ref.numpy(), got.numpy(), 1e-6, 1e-6)

    g = torch.as_tensor(np.random.RandomState(7).normal(size=(N, 4)),
                        dtype=torch.float32)
    gx, gxv, grads = FM._mlp_bwd_tile(st, xs, xvs, flat, g)
    gx_k, gxv_k, grads_k = FM._mlp_bwd_tile(stk, xs, xvs, flat_k, g)
    for gr, gk in zip(grads, grads_k):   # the padding's gradients
        r, c = gr.shape
        rest = gk.clone()
        rest[:r, :c] = 0
        assert not rest.any()
    dw, db = _to_layout(grads_k, stk)
    dropped = FM._unpack_grads(st, dw, db)
    assert [tuple(d.shape) for d in dropped] == [
        tuple(s) for s, _ in FM._weight_shapes(st)]
    for i, (a, b) in enumerate(zip(gx + gxv + grads,
                                   gx_k + gxv_k + dropped)):
        assert_grad_close(a.numpy(), b.numpy(), name=f'operand {i}',
                          cos_tol=1e-6, ratio_tol=1e-5, elementwise=False)


@pytest.mark.parametrize('depth,width', SHAPES, ids=IDS)
def test_gate_admits_the_shape(depth, width):
    """The kernels take the net at the multi-subject and the 'relpos'
    parts; the packs have the sizes of the build it runs on."""
    for dparts, vparts in ((DPARTS, (648, 1, 16)), ((1080, 72), (216, 16))):
        st = _static(depth, width, dparts, vparts)
        FM._check_kernel_shape(st)
        stk = FM.kernel_static(st)
        W, H, dxp = stk.width, stk.half, -(-sum(dparts) // 16) * 16
        skip = depth > 5
        wsz = ((2 if skip else 1) * W * dxp + (depth - 1 + 1) * W * W
               + H * W + H * 672 + W + 3 * H)
        flat = [torch.zeros(s, dtype=d) for s, d in FM._weight_shapes(st)]
        wbuf, bbuf = FM._pack_kernel_weights(flat, st)
        assert wbuf.numel() == FM._pack_bwd_weights(flat, st).numel() == wsz
        assert bbuf.numel() == depth * W + W + H + 1 + 3


def test_library_keys_per_compiled_shape():
    """One library key per (trunk width, depth, compiled width); the
    flagship's is the key it had, and nets padded to one width share
    its build."""
    assert cuda_build.lib_key('mlp_fwd') == ('mlp_fwd', 432)
    assert cuda_build.lib_key('mlp_bwd', 432, 8, 256) == ('mlp_bwd', 432)
    assert cuda_build.lib_key('fwd') == ('fwd', None)
    keys = {}
    for depth, width in SHAPES:
        stk = FM.kernel_static(_static(depth, width))
        keys.setdefault((stk.depth, stk.width), set()).add(
            cuda_build.lib_key('mlp_fwd', 432, stk.depth, stk.width))
    assert all(len(k) == 1 for k in keys.values())
    flat = [next(iter(k)) for k in keys.values()]
    assert len(set(flat)) == len(flat) == 9
    assert keys[8, 256] == {('mlp_fwd', 432)}
    assert keys[8, 512] == {('mlp_fwd', 432, 8, 512)}
    assert cuda_build._shape_flags(('mlp_fwd', 432, 6, 256)) == [
        '-DANERF_DX=432', '-DANERF_DEPTH=6', '-DANERF_WIDTH=256',
        '-DANERF_SKIP=4']
    assert cuda_build._shape_flags(('mlp_fwd', 432)) == ['-DANERF_DX=432']


def test_jax_tree_of_a_6x512_net_carries_across():
    """A 6 x 512 net's JAX parameter tree crosses with
    ``params_from_numpy`` leaf for leaf, flattens and packs at 6 x 512,
    and the twin runs it as anerf_tpu's XLA path does."""
    j_params, t_params, j_cfg, t_cfg = _net(6, 512)
    j_leaves = jax.tree_util.tree_leaves(j_params)
    t_leaves = tree_leaves(t_params)
    assert len(j_leaves) == len(t_leaves)
    for a, b in zip(j_leaves, t_leaves):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    st = _static(6, 512)
    flat = FM.flatten_params(t_params, st)
    assert [tuple(w.shape) for w in flat] == [
        tuple(s) for s, _ in FM._weight_shapes(st)]
    assert FM.kernel_static(st) is st
    xs, xvs = _inputs(5)
    ref = j_forward(j_params, j_cfg, jnp.concatenate(xs, -1), xvs[0],
                    codes=xvs[1])
    with torch.no_grad():
        got = FM.nerf_mlp_fused(t_params, t_cfg,
                                [torch.as_tensor(x) for x in xs],
                                [torch.as_tensor(x) for x in xvs])
    _assert_raw_close(np.asarray(ref), got.numpy(), 1e-3, 2e-2)


# the dW pass's plan: (parts, views, nets, n) -> (tiles, P, slice,
# gradient values a net): K4 and K3 at the flagship train step's shapes,
# K6 at the multi-subject step's and at the 'relpos' trunk of 1152
PLANS = {'flagship K4': ((360, 72), (648, 16), 2, 131072,
                         (118, 18, 7296, 864896)),
         'flagship K3': ((360, 72), (648, 16), 1, 32768,
                         (59, 16, 2048, 864896)),
         'multi-subject K6': ((360, 72), (648, 1, 16), 1, 131072,
                              (59, 36, 3648, 864896)),
         'trunk-1152 K6': ((1080, 72), (216, 16), 1, 131072,
                           (79, 27, 4864, 1233536))}


@pytest.mark.parametrize('name', sorted(PLANS))
def test_dw_plan_pinned(name):
    """P slices of the point axis fill the card's 132 SMs about 16 times
    over with the dW pass's tiles, unless that would cut slices shorter
    than 2048 points (K3's 32,768); every slice a multiple of the
    64-point tile, P the slices' count; the partials P copies of the
    nets' gradients, allocated at their size."""
    dparts, vparts, nnet, n, (tiles, P, slice_, n_dw) = PLANS[name]
    st = _static(8, 256, dparts, vparts)
    assert FM.dw_tiles(st, nnet) == tiles
    assert FM.dw_plan(st, n, nnet) == (P, slice_)
    assert slice_ % 64 == 0 and -(-n // slice_) == P
    assert tiles * P >= 16 * 132 or slice_ == 2048
    flat = [torch.zeros(s, dtype=d) for s, d in FM._weight_shapes(st)]
    assert FM._pack_bwd_weights(flat, st).numel() == n_dw
    part, P2, slice2 = FM.dw_partials(st, n, n_dw, nnet, 'cpu')
    assert (P2, slice2) == (P, slice_)
    assert part.numel() == P * nnet * n_dw
