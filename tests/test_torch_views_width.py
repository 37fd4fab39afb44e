"""The split-operand kernels K5/K6 at views inputs wider than 672
columns (ROADMAP C.15), on the CPU.

Before C.15's repair K5/K6 took views parts summing to at most 672
columns: on the card the port raised at the first step of any model
whose views input is wider (``surreal.txt`` at ``multires_views = 5``,
``framecode_size = 32``, any multi-subject model at ``multires_views``
5 or more), which anerf_tpu's split kernel trains and renders.  Now a
build per views width takes them, up to 4096 columns since C.16
(``fused_mlp.views_pad``: 672 for any parts up to it, else the parts'
sum + 8 rounded up to 16).

* ``_check_kernel_shape`` admits views parts (648, 32), (792, 1, 16),
  (1512, 1, 128), the former ceiling (1656 columns, a views width of 1664)
  and the columns past it, up to the ceiling (4088 columns, a views
  width of 4096), and refuses the next column;
* the kernels' packs and gradient layout at those widths: the views
  weight zero-padded to the views width, the dW pass's tiles over it;
* one two-subject train step at ``multires_views = 5`` (views parts
  792, 1 and 16) against anerf_tpu's XLA path: the port's plain backend
  in f32 at ``test_torch_train.py``'s tolerances (losses within 1e-5,
  parameters 99.9% within 2e-6, Adam moments at cosine 1 - 1e-6 and
  norm within 1e-4), and its fused backend, whose every K5/K6 call
  passes their gate at a views width of 832 (it raised there before
  C.15), with losses within 1e-2 of XLA's in bf16 (the XLA path rounds
  to bf16 at other places than the kernels' chain, which
  ``test_torch_multisubject.py`` holds to the Pallas kernel).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anerf_tpu.models.factory import build_raycast_config as j_build
from anerf_tpu.skeleton import SMPLSkeleton as JSMPL
from anerf_tpu.training import pose_opt as JP
from anerf_tpu.training import trainer as JT

from anerf_torch import testing_utils as T
from anerf_torch.interop import train_state_from_jax
from anerf_torch.models.factory import build_raycast_config as t_build
from anerf_torch.ops import fused_mlp as FM
from anerf_torch.skeleton import SMPLSkeleton
from anerf_torch.training import pose_opt as P
from anerf_torch.training import trainer as TT

from test_torch_train import (N_FRAMES, R, _cfg, _compare_states,
                              _jax_numpy_state, _run, train_state_to_numpy)
from test_torch_threads import one_torch_thread  # noqa: F401

TRUNK = (360, 72)
# views parts: (the parts, the views width K5/K6 are built for)
ADMITTED = [((648, 16), 672), ((648, 1, 16), 672), ((648, 32), 688),
            ((792, 1, 16), 832), ((1512, 1, 128), 1664), ((1656,), 1664),
            ((1657,), 1680), ((1512, 1, 144), 1680), ((1656, 1, 16), 1696),
            ((4088,), 4096)]


def _st(vparts, depth=8, width=256):
    return FM.MLPStatic(depth, width, TRUNK, tuple(vparts), width // 2, (4,))


@pytest.mark.parametrize('vparts,xv_pad', ADMITTED,
                         ids=['+'.join(map(str, v)) for v, _ in ADMITTED])
def test_views_widths_are_admitted(vparts, xv_pad):
    """K5/K6's gate takes the parts, at the views width of their build:
    672 up to it (every build before C.15 keeps its width), past it the
    parts + 8 rounded up to 16, at nets 256, 512 and 1024 wide."""
    for width in (256, 512, 1024):
        st = _st(vparts, width=width)
        assert st.xv_pad == FM.views_pad(sum(vparts)) == xv_pad
        FM._check_kernel_shape(st)


def test_views_width_past_the_ceiling_is_refused():
    """One column past the ceiling raises, naming ROADMAP.md, before any
    launch; so does a fifth part."""
    for vparts in ((4089,), (3944, 1, 144), (648, 1, 16, 3424)):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            FM._check_kernel_shape(_st(vparts))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        FM._check_kernel_shape(_st((400, 400, 400, 400, 16)))


@pytest.mark.parametrize('vparts', [(648, 32), (792, 1, 16),
                                    (1512, 1, 128)])
def test_packs_at_views_width(vparts):
    """The forward pack holds the views weight zero-padded to the views
    width, the backward pack and the gradient layout the same rows, and
    the dW pass's tiles cover them."""
    st = _st(vparts)
    W, H, xv = st.width, st.half, st.xv_pad
    gen = torch.Generator().manual_seed(0)
    flat = [torch.randn(s, generator=gen).to(d)
            for s, d in FM._weight_shapes(st)]
    wbuf, bbuf = FM._pack_kernel_weights(flat, st)
    dxp = 432
    fwd_elems = (W * dxp + 7 * W * W + W * dxp + W * W + H * W + H * xv
                 + W + 3 * H)
    assert wbuf.numel() == fwd_elems and bbuf.numel() == 8 * W + W + H + 4
    # the views input's rows: the parts' weights, then zeros to xv
    off = W * dxp + 7 * W * W + W * dxp + W * W + H * W
    wvx = wbuf[off:off + H * xv].view(H, xv).float()
    k = len(flat) - 3 - len(vparts)
    ref = torch.cat([w.float() for w in flat[k:k + len(vparts)]]).t()
    assert torch.equal(wvx[:, :sum(vparts)], ref.to(torch.bfloat16).float())
    assert not wvx[:, sum(vparts):].any()
    layout = FM._grad_layout(st)
    wb = FM._pack_bwd_weights(flat, st)
    last = layout[k + len(vparts) - 1]
    assert last[1] + last[2][0] * H + (xv - sum(vparts)) * H == \
        layout[k + len(vparts) + 1][1]   # rgb's rows after the padding
    assert wb.numel() == layout[-2][1] + 3 * H
    assert FM.dw_tiles(st) == 59 + (-(-xv // 128) - -(-672 // 128))


def _two_subject_setups(backend_j, backend_t, compute_dtype):
    """``test_torch_multisubject._setups`` at ``multires_views = 5``."""
    rest, bones, _, kps, skts, cyls = T.synthetic_pose(N_FRAMES,
                                                       n_subjects=2)
    subj = T.subject_of_frame(N_FRAMES, 2)
    batch = T.synthetic_batch(R, N_FRAMES, kps, skts, bones, cyls, seed=2)
    batch['subject_idxs'] = subj[batch['kp_idx']]
    cfgs = [dataclasses.replace(_cfg(b, compute_dtype), multires_views=5)
            for b in (backend_j, backend_t)]
    j_setup = JT.TrainSetup(
        cfg=cfgs[0], rc=j_build(cfgs[0], n_framecodes=N_FRAMES,
                                n_subjects=2),
        skel=JSMPL, rest_pose=jnp.asarray(rest),
        anchors=JP.make_anchors(kps, bones),
        rest_pose_idxs=jnp.asarray(subj), near=0.0, far=1.0)
    j_state = JT.init_train_state(j_setup, jax.random.PRNGKey(0),
                                  init_kp3d=kps, init_bones=bones)
    t_setup = TT.TrainSetup(
        cfg=cfgs[1], rc=t_build(cfgs[1], n_framecodes=N_FRAMES,
                                n_subjects=2),
        skel=SMPLSkeleton, rest_pose=rest,
        anchors=P.make_anchors(kps, bones), rest_pose_idxs=subj, near=0.0,
        far=1.0, device='cpu')
    assert t_setup.rc.n_subjects == 2
    assert t_setup.rc.view_embed.out_dim == 792
    return (j_setup, j_state, {k: jnp.asarray(v) for k, v in batch.items()},
            t_setup, T.to_device(batch, 'cpu'))


def test_two_subject_step_at_11_view_rows_matches_xla():
    """One two-subject step at ``multires_views = 5`` on the plain
    backend against JAX's ``make_train_step`` on its XLA path, in f32."""
    j_setup, j_state, jb, t_setup, tb = _two_subject_setups(
        'xla', 'plain', 'float32')
    ts = train_state_from_jax(j_state)
    js, ts = _run(jax.jit(JT.make_train_step(j_setup)), j_state, jb,
                  TT.make_train_step(t_setup), ts, tb, 1, loss_rtol=1e-5)
    _compare_states(js, ts, pose_atol=1e-6, mom_cos=1e-6, mom_ratio=1e-4)


def test_two_subject_fused_step_at_11_view_rows(monkeypatch):
    """The same step on the fused backend: K5's twin three times and
    K6's three times, each through the kernels' gate at views parts 792
    + 1 + 16 (a views width of 832), losses within 1e-2 of the XLA
    path's in bf16."""
    j_setup, j_state, jb, t_setup, tb = _two_subject_setups(
        'xla', 'fused', 'bfloat16')
    seen = []
    for name in ('mlp_fwd', 'mlp_bwd'):
        inner = getattr(FM, name)

        def spy(st, *args, _name=name, _inner=inner):
            FM._check_kernel_shape(st)
            seen.append((_name, st.vparts, st.xv_pad))
            return _inner(st, *args)
        monkeypatch.setattr(FM, name, spy)
    ts = train_state_from_jax(j_state)
    _run(jax.jit(JT.make_train_step(j_setup)), j_state, jb,
         TT.make_train_step(t_setup), ts, tb, 1, loss_rtol=1e-2)
    assert sorted(seen) == [(n, (792, 1, 16), 832) for n in
                            ('mlp_bwd',) * 3 + ('mlp_fwd',) * 3]
