"""The encoder grammar of the port against anerf_tpu on the CPU.

Every encoder function the flagship recipe does not use (kp 'relpos',
'cat', 'querypts'; view 'rayangle', 'world'; bone 'axisang') and the
cutoff embedder's ``normalize`` branch, on the same numpy inputs; every
kp x bone x view combination of the factory, with cutoff windows on and
off, built and encoded by both packages (the combinations anerf_tpu
refuses must raise in the port too); and the joint distances the
cutoff windows read when the kp encoding is not a distance (ROADMAP.md
C.2).

Tolerance: everything here is f32 on both sides and differs by
summation order and transcendental rounding only, so 1e-5 x the
reference's max |value| (``test_torch_ops.py``'s bar).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anerf_tpu.models import raycaster as jrc
from anerf_tpu.models.factory import build_raycast_config as j_build
from anerf_tpu.models.factory import embed_state as j_embed_state
from anerf_tpu.ops import embedding as JE
from anerf_tpu.ops import encoders as JX

from anerf_torch import testing_utils as T
from anerf_torch.models import raycaster as trc
from anerf_torch.models.factory import build_raycast_config as t_build
from anerf_torch.models.factory import embed_state as t_embed_state
from anerf_torch.models.factory import init_raycaster_params as t_init
from anerf_torch.ops import embedding as TE
from anerf_torch.ops import encoders as TX

from test_torch_ops import _close
from test_torch_threads import one_torch_thread  # noqa: F401

t = torch.as_tensor
R, S = 6, 5
KP_TYPES = ('reldist', 'relpos', 'cat', 'querypts')
BONE_TYPES = ('reldir', 'axisang')
VIEW_TYPES = ('relray', 'rayangle', 'world')


def _scene():
    """(pts (R, S, 3), rays_d (R, 3), kps, skts, bones) of synthetic
    poses, with points around the body."""
    _, bones, _, kps, skts, _ = T.synthetic_pose(R, seed=5)
    rng = np.random.RandomState(6)
    pts = rng.uniform(-0.5, 0.5, (R, S, 3)).astype(np.float32)
    rays_d = rng.normal(size=(R, 3)).astype(np.float32)
    return pts, rays_d, kps, skts, bones


def _local(pts, rays_d, skts):
    pts_t = np.asarray(JX.transform_batch_pts(jnp.asarray(pts),
                                              jnp.asarray(skts)))
    rays_t = np.asarray(JX.transform_batch_rays(
        jnp.asarray(rays_d)[:, None], jnp.asarray(skts)))
    return pts_t, rays_t


@pytest.mark.parametrize('fn', ['rel_pos', 'rel_pos_world', 'kp_cat',
                                'identity_pts', 'ray_ang', 'identity_expand',
                                'identity_expand_rays'])
def test_encoder_matches_jax(fn):
    pts, rays_d, kps, skts, bones = _scene()
    pts_t, rays_t = _local(pts, rays_d, skts)
    name, args = fn, (pts, pts_t, kps)
    if fn == 'rel_pos_world':        # without local points: pts - kps
        name, args = 'rel_pos', (pts, None, kps)
    elif fn == 'ray_ang':
        args = (rays_t, pts_t)
    elif fn == 'identity_expand':
        args = (bones, pts_t)
    elif fn == 'identity_expand_rays':
        name, args = 'identity_expand', (rays_t, pts_t)
    ref = getattr(JX, name)(*[None if a is None else jnp.asarray(a)
                              for a in args])
    got = getattr(TX, name)(*[None if a is None else t(a) for a in args])
    _close(ref, got)


def _embed_case(case):
    """(EmbedConfig kwargs, inputs, dists, tau) of one normalize case."""
    pts, rays_d, kps, skts, bones = _scene()
    pts_t, rays_t = _local(pts, rays_d, skts)
    dists = np.linalg.norm(pts_t, axis=-1).astype(np.float32)
    rel = pts_t.reshape(R, S, 72)
    kw = dict(input_dims=72, num_freqs=3, cutoff=True, dist_inputs=True,
              normalize=True)
    if case == 'kp_cutoff_inputs':
        return dict(kw, cutoff_inputs=True), rel, dists, 30.
    if case == 'kp_raw_row_unwindowed':
        return kw, rel, dists, 30.
    if case == 'view_per_ray':       # per-ray x, per-sample windows
        x = np.asarray(JX.vec_norm(jnp.asarray(rays_t)))
        return dict(kw, num_freqs=4, cutoff_inputs=True), x, dists, 30.
    # tau large enough that far joints' windows vanish: their groups are
    # zeroed
    return dict(kw, cutoff_inputs=True), rel, dists, 400.


@pytest.mark.parametrize('case', ['kp_cutoff_inputs', 'kp_raw_row_unwindowed',
                                  'view_per_ray', 'vanishing_windows'])
def test_embed_normalize_matches_jax(case):
    kw, x, dists, tau = _embed_case(case)
    cutoff = np.full((24,), 0.3, np.float32)
    jc, tc = JE.EmbedConfig(**kw), TE.EmbedConfig(**kw)
    ref, w_ref = JE.embed(jnp.asarray(x), jc, dists=jnp.asarray(dists),
                          cutoff_dist=jnp.asarray(cutoff), tau=tau)
    got, w = TE.embed(t(x), tc, dists=t(dists), cutoff_dist=t(cutoff),
                      tau=torch.tensor(tau))
    assert got.shape == ref.shape == (R, S, jc.out_dim)
    _close(ref, got)
    _close(w_ref, w)
    if case == 'vanishing_windows':
        zeroed = np.asarray(w_ref)[..., 0, :] < 1e-6
        assert 0 < zeroed.sum() < zeroed.size


def _grammar_cfg(kp, bone, view, cutoff, **over):
    return T.surreal_config(kp_dist_type=kp, bone_type=bone, view_type=view,
                            use_cutoff=cutoff, netwidth=32, **over)


def _try(fn):
    """(result, None) or (None, the exception)."""
    try:
        return fn(), None
    except Exception as e:   # noqa: BLE001 - either package's own error
        return None, e


@pytest.mark.parametrize('cutoff', [True, False], ids=['cutoff', 'nocutoff'])
@pytest.mark.parametrize('view', VIEW_TYPES)
@pytest.mark.parametrize('bone', BONE_TYPES)
@pytest.mark.parametrize('kp', KP_TYPES)
def test_combination_builds_and_encodes_as_jax(kp, bone, view, cutoff):
    """The factory's embedder configurations, cutoff radii and net input
    widths equal anerf_tpu's; ``encode_inputs`` gives anerf_tpu's (v, r,
    d), or raises where anerf_tpu raises (kp 'cat' and 'querypts' with
    cutoff windows: their encodings do not have the windows' width)."""
    cfg = _grammar_cfg(kp, bone, view, cutoff)
    j_rc, t_rc = j_build(cfg, n_framecodes=4), t_build(cfg, n_framecodes=4)
    for k in ('kp_embed', 'bone_embed', 'view_embed'):
        assert (dataclasses.asdict(getattr(j_rc, k))
                == dataclasses.asdict(getattr(t_rc, k))), k
    for k in ('input_ch', 'input_ch_bones', 'input_ch_views'):
        assert getattr(j_rc.nerf, k) == getattr(t_rc.nerf, k), k
    params = t_init(torch.Generator().manual_seed(0), t_rc, cfg)
    assert tuple(params['cutoff_dist'].shape) == (24,)
    pts, rays_d, kps, skts, bones = _scene()
    pose = {'kps': kps, 'skts': skts, 'bones': bones}
    j_params = {'cutoff_dist': jnp.asarray(params['cutoff_dist'].numpy())}
    ref, j_err = _try(lambda: jrc.encode_inputs(
        j_rc, j_params, jnp.asarray(pts), jnp.zeros((R, 3)),
        jnp.asarray(rays_d), {k: jnp.asarray(v) for k, v in pose.items()},
        j_embed_state(cfg, j_rc, 500)))
    got, t_err = _try(lambda: trc.encode_inputs(
        t_rc, params, t(pts), torch.zeros((R, 3)), t(rays_d),
        {k: t(v) for k, v in pose.items()}, t_embed_state(cfg, t_rc, 500)))
    assert (j_err is None) == (t_err is None), (j_err, t_err)
    if j_err is not None:
        assert kp in ('cat', 'querypts') and cutoff
        return
    widths = (t_rc.nerf.input_ch, t_rc.nerf.input_ch_bones,
              t_rc.nerf.input_ch_views)
    for a, b, width in zip(ref, got, widths):
        assert b.shape == (R, S, width)
        _close(a, b)


@pytest.mark.parametrize('kp', ['relpos', 'cat', 'querypts', 'reldist'])
def test_joint_dists_of_every_kp_encoding(kp):
    """The distances the cutoff windows read: the kp encoding itself for
    'reldist', else |pts - kps| per joint, as anerf_tpu computes them
    (anerf_tpu/models/raycaster.py:134-137); and the kp windows of
    'relpos' with cutoff on, which the parent port computed from the
    encoding (ROADMAP.md C.2)."""
    pts, rays_d, kps, skts, _ = _scene()
    cfg = _grammar_cfg(kp, 'reldir', 'relray', True)
    t_rc = t_build(cfg, n_framecodes=4)
    pts_t, _ = _local(pts, rays_d, skts)
    fn, _, _ = TX.get_kp_input_fn(kp, 24)
    v = fn(t(pts), t(pts_t), t(kps))
    got = trc.joint_dists(t_rc, v, t(pts), t(kps))
    want = (np.linalg.norm(pts_t, axis=-1) if kp == 'reldist' else
            np.linalg.norm(pts[:, :, None] - kps[:, None], axis=-1))
    assert got.shape == (R, S, 24)
    _close(want, got)
    if kp != 'relpos':
        return
    j_rc = j_build(cfg, n_framecodes=4)
    cutoff = np.full((24,), 0.3, np.float32)
    _, w_ref = JE.embed(jnp.asarray(v.numpy()), j_rc.kp_embed,
                        dists=jnp.asarray(want.astype(np.float32)),
                        cutoff_dist=jnp.asarray(cutoff), tau=30.)
    _, w = TE.embed(v, t_rc.kp_embed, dists=got, cutoff_dist=t(cutoff),
                    tau=torch.tensor(30.))
    assert w.shape == (R, S, 1, 72)
    _close(w_ref, w)
