"""The split-operand MLP kernels' plain twins (K5 forward, K6 backward)
against anerf_tpu's Pallas kernels on the CPU.

``fused_mlp.nerf_mlp_fused`` (K5's twin inside ``_FusedMLP``, whose
backward is K6's twin) against ``pallas_mlp.nerf_mlp_pallas`` in
interpret mode, at the full 8x256 width on n=200 points (the Pallas
side pads to a 128-point tile, the port runs the ragged count as it
is), for the multi-subject part widths (360, 72) / (649, 16) (anerf_tpu's
view encoding with the subject channel, an odd width), the port's
multi-subject split (360, 72) / (648, 1, 16) and the single-subject
(360, 72) / (648, 16); and for the trunks of the other kp encoders at
the SURREAL recipe's widths, each a width of its own K5/K6 build:
'querypts' (45, 72), 'relpos' (1080, 72) and 'cat' (1125, 72), with
'rayangle''s view encoding (216, 16) or the multi-subject split
(648, 1, 16).  Inputs come from a numpy seed; the weights are JAX's,
carried across with ``interop``.

Bars.  Both sides run the same bf16 chain and differ by f32 summation
order, and the bf16 re-cast flips that order causes now and then
between layers: forward per channel mean |d| < 1e-3 x the channel's
max |value| and worst point < 2e-2 x; backward (``jax.vjp`` of the same
function) cosine > 0.9999 and norm ratio within 5e-3 on every part
cotangent and every weight and bias gradient, anerf_tpu's bar between
its own two backward implementations (tests/test_pallas_encmlp.py:
236-237).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anerf_tpu.models.nerf_mlp import NeRFConfig as JNeRFConfig
from anerf_tpu.models.nerf_mlp import init_nerf_params as j_init
from anerf_tpu.ops import pallas_mlp as PM

from anerf_torch.interop import params_from_numpy
from anerf_torch.models.nerf_mlp import NeRFConfig
from anerf_torch.ops import fused_mlp as FM
from anerf_torch.training.trainer import tree_leaves

from test_torch_fused_bwd import assert_grad_close
from test_torch_threads import one_torch_thread  # noqa: F401

N = 200
PARTS = [((360, 72), (649, 16)), ((360, 72), (648, 1, 16)),
         ((360, 72), (648, 16)), ((45, 72), (216, 16)),
         ((1080, 72), (648, 1, 16)), ((1125, 72), (216, 16)),
         ((1125, 72), (648, 1, 16))]
IDS = ['multi-subject', 'subject-part', 'single-subject', 'querypts-rayangle',
       'relpos-subject-part', 'cat-rayangle', 'cat-subject-part']


def _net(vparts, dparts=(360, 72)):
    """(JAX params, port params, JAX config, port config) of one
    full-width net whose trunk takes ``dparts`` and views input
    ``vparts``."""
    multi = sum(vparts) == 665
    kw = dict(input_ch=dparts[0], input_ch_bones=dparts[1],
              input_ch_views=648 if multi else vparts[0],
              use_framecode=True, framecode_ch=vparts[-1],
              n_subjects=2 if multi else 1)
    j_cfg = JNeRFConfig(**kw)
    params = j_init(jax.random.PRNGKey(0), j_cfg)
    params.pop('framecodes', None)      # the codes arrive as a part
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    return params, t_params, j_cfg, NeRFConfig(**kw)


def _inputs(dparts, vparts, seed=0):
    rng = np.random.RandomState(seed)
    xs = [rng.uniform(-1, 1, (N, d)).astype(np.float32) for d in dparts]
    xvs = [rng.uniform(-1, 1, (N, d)).astype(np.float32) for d in vparts]
    return xs, xvs


@pytest.mark.parametrize('dparts,vparts', PARTS, ids=IDS)
def test_forward_twin_matches_pallas(dparts, vparts):
    j_params, t_params, j_cfg, t_cfg = _net(vparts, dparts)
    xs, xvs = _inputs(dparts, vparts)
    ref = np.asarray(PM.nerf_mlp_pallas(
        j_params, j_cfg, [jnp.asarray(x) for x in xs],
        [jnp.asarray(x) for x in xvs], interpret=True))
    with torch.no_grad():
        got = FM.nerf_mlp_fused(t_params, t_cfg,
                                [torch.as_tensor(x) for x in xs],
                                [torch.as_tensor(x) for x in xvs]).numpy()
    assert got.shape == ref.shape == (N, 4)
    for c in range(4):
        scale = np.abs(ref[:, c]).max()
        d = np.abs(ref[:, c] - got[:, c])
        assert d.mean() < 1e-3 * scale and d.max() < 2e-2 * scale, \
            (c, d.mean() / scale, d.max() / scale)


@pytest.mark.parametrize('dparts,vparts', PARTS, ids=IDS)
def test_backward_twin_matches_pallas_vjp(dparts, vparts):
    j_params, t_params, j_cfg, t_cfg = _net(vparts, dparts)
    xs, xvs = _inputs(dparts, vparts, seed=1)
    g = np.random.RandomState(2).normal(size=(N, 4)).astype(np.float32)

    def f(params, xs_, xvs_):
        return PM.nerf_mlp_pallas(params, j_cfg, list(xs_), list(xvs_),
                                  interpret=True)
    _, vjp = jax.vjp(f, j_params, [jnp.asarray(x) for x in xs],
                     [jnp.asarray(x) for x in xvs])
    dparams, dxs, dxvs = vjp(jnp.asarray(g))
    ref = list(dxs) + list(dxvs) + jax.tree_util.tree_leaves(dparams)

    txs = [torch.tensor(x, requires_grad=True) for x in xs]
    txvs = [torch.tensor(x, requires_grad=True) for x in xvs]
    leaves = tree_leaves(t_params)
    for t in leaves:
        t.requires_grad_(True)
    out = FM.nerf_mlp_fused(t_params, t_cfg, txs, txvs)
    got = torch.autograd.grad(out, txs + txvs + leaves, torch.as_tensor(g))
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert_grad_close(np.asarray(a, np.float32), b.numpy(),
                          name=f'operand {i}', elementwise=False)


def test_autograd_function_returns_operand_dtypes():
    """``_FusedMLP`` gives each operand its gradient in the operand's
    dtype (bf16 parts and weights, f32 biases), and the CPU wrappers
    take the twins and count no launch."""
    _, t_params, _, _ = _net((649, 16))
    st = FM.MLPStatic(depth=8, width=256, dparts=(360, 72),
                      vparts=(649, 16), half=128, skips=(4,))
    xs, xvs = _inputs(st.dparts, st.vparts)
    ops = [torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
           for x in xs + xvs]
    flat = [w.detach().requires_grad_(True)
            for w in FM.flatten_params(t_params, st)]
    FM.reset_launch_counts()
    out = FM._FusedMLP.apply(st, 2, 2, *ops, *flat)
    assert type(out.grad_fn).__name__ == '_FusedMLPBackward'
    grads = torch.autograd.grad(out.sum(), ops + flat)
    assert [g.dtype for g in grads] == [t.dtype for t in ops + flat]
    assert FM.launch_counts() == {'mlp_fwd': 0, 'mlp_bwd': 0}


@pytest.mark.parametrize('dparts,vparts', PARTS + [((432,), (648,))],
                         ids=IDS + ['one-part-no-codes'])
def test_split_weight_layouts_round_trip(dparts, vparts):
    """The packed layouts K5/K6 read hold every ``flatten_params``
    operand of any part split and trunk width: the backward pack
    unpacks to the weights, the rows past the trunk parts (up to the
    16-column k-step) and past the views parts are zero in both packs,
    and both packs have the size of the kernels built for the width."""
    _, t_params, _, _ = _net(
        (649, 16) if sum(vparts) == 665 else (vparts[0], 16),
        dparts if len(dparts) == 2 else (360, 72))
    if len(vparts) == 1:
        wv = t_params['views_linear']['w']
        t_params = dict(t_params, views_linear={
            'w': wv[:256 + 648], 'b': t_params['views_linear']['b']})
    st = FM.MLPStatic(depth=8, width=256, dparts=dparts, vparts=vparts,
                      half=128, skips=(4,))
    flat = FM.flatten_params(t_params, st)
    wb = FM._pack_bwd_weights(flat, st)
    wbuf, bbuf = FM._pack_kernel_weights(flat, st)
    got = FM._unpack_grads(st, wb.float(), bbuf)
    assert all(torch.equal(w.float(), g) for w, g in zip(flat, got))
    _, off, shape = FM._grad_layout(st)[-4]
    end = off + shape[0] * shape[1]
    pad = (FM._XV_PAD - sum(vparts)) * st.half
    assert wb[end:end + pad].abs().sum() == 0
    # the trunk input's zero rows (backward) and columns (forward) past
    # the parts, after layer 0's and the skip layer's x blocks
    dxp = -(-sum(dparts) // 16) * 16
    layout = FM._grad_layout(st)
    x_last = [len(dparts) - 1, 2 * len(dparts) + 9]  # flatten indices
    for i in x_last:
        _, off, shape = layout[i]
        end = off + shape[0] * shape[1]
        assert wb[end:end + (dxp - sum(dparts)) * 256].abs().sum() == 0
    for off in (0, 256 * dxp + 5 * 256 * 256):
        block = wbuf[off:off + 256 * dxp].view(256, dxp)
        assert block[:, sum(dparts):].abs().sum() == 0
        assert block[:, :sum(dparts)].abs().sum() > 0
    # the kernels' sizes (csrc: WGSZ = WSZ, BSZ) whatever the split:
    # 864,896 at a 432-wide trunk
    assert wb.numel() == wbuf.numel() == (
        2 * 256 * dxp + 8 * 256 * 256 + 128 * 256 + 128 * 672 + 256 + 384)
    assert bbuf.numel() == 8 * 256 + 256 + 128 + 1 + 3


def test_kernel_cost_and_shape_gate():
    """864,000 MACs a point at the multi-subject widths, 3x the FLOPs
    backward; any trunk width of 1-4096 columns and any net of 1-128
    layers up to 4096 wide (depth x width up to 262,144: 8 x 1024 and 8
    x 4096 among them) passes the gate, and shapes the kernels are not
    built for (a net wider than 4096, views inputs past 4088 columns (a
    views width past 4096), a trunk past 4096) raise naming
    ROADMAP.md."""
    st = FM.MLPStatic(8, 256, (360, 72), (649, 16), 128, (4,))
    fwd, bwd = FM.kernel_cost(st, 1000), FM.kernel_cost(st, 1000, True)
    assert fwd['bf16_flops'] == 2 * 864000 * 1000
    assert bwd['bf16_flops'] == 3 * fwd['bf16_flops']
    assert fwd['bytes'] > 1000 * (432 + 665) * 2 and bwd['bytes'] > \
        2 * fwd['bytes'] - 1000 * 16
    FM._check_kernel_shape(st)
    for dparts in ((1,), (45, 72), (360,), (1080, 72), (1125, 72), (2048,),
                   (1977, 72), (4096,)):
        FM._check_kernel_shape(
            FM.MLPStatic(8, 256, dparts, (649, 16), 128, (4,)))
    for good in (FM.MLPStatic(8, 128, (360, 72), (649, 16), 64, (4,)),
                 FM.MLPStatic(6, 256, (360, 72), (649, 16), 128, (4,)),
                 FM.MLPStatic(8, 1024, (360, 72), (649, 16), 512, (4,)),
                 FM.MLPStatic(8, 4096, (360, 72), (649, 16), 2048, (4,)),
                 FM.MLPStatic(8, 256, (360, 72), (1512, 1, 144), 128, (4,))):
        FM._check_kernel_shape(good)
    for bad in (FM.MLPStatic(8, 4352, (360, 72), (649, 16), 2176, (4,)),
                FM.MLPStatic(8, 256, (4025, 72), (649, 16), 128, (4,)),
                FM.MLPStatic(8, 256, (360, 72), (3944, 1, 144), 128, (4,))):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            FM._check_kernel_shape(bad)
