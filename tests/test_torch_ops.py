"""Port ops vs anerf_tpu ops on the CPU, in f32: rays and sampling,
encoders, the cutoff embedding, compositing and the NeRF MLP.

The same numpy inputs (from a seed) go to both packages.  Tolerances:
values that are moved or picked (ranks, gathers, permutations) must be
equal; f32 arithmetic gets 1e-5 relative to the reference's scale
(summation order and transcendental rounding differ between XLA and
PyTorch by a few ulp); bf16 chains 1e-3 x scale (a summation-order
difference can flip a bf16 rounding between layers).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anerf_tpu.models import nerf_mlp as JM
from anerf_tpu.ops import compositing as JC
from anerf_tpu.ops import embedding as JE
from anerf_tpu.ops import encoders as JX
from anerf_tpu.ops import rays as JR

from anerf_torch.interop import params_from_numpy
from anerf_torch.models import nerf_mlp as TM
from anerf_torch.ops import compositing as TC
from anerf_torch.ops import embedding as TE
from anerf_torch.ops import encoders as TX
from anerf_torch.ops import rays as TR
from anerf_torch import testing_utils as T

from test_torch_threads import one_torch_thread  # noqa: F401

t = torch.as_tensor


def _close(ref, got, tol=1e-5):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    scale = np.abs(ref).max() + 1e-12
    err = np.abs(ref - got).max() if ref.size else 0.
    assert err <= tol * scale, (err, scale)


def _near_far(R=16, seed=0):
    rng = np.random.RandomState(seed)
    near = rng.uniform(0.5, 1.0, (R, 1)).astype(np.float32)
    far = near + rng.uniform(0.2, 1.0, (R, 1)).astype(np.float32)
    return near, far


# --------------------------------------------------------------- rays ----

@pytest.mark.parametrize('lindisp', [False, True])
@pytest.mark.parametrize('perturb', [0., 1.])
def test_sample_from_lineseg(lindisp, perturb):
    near, far = _near_far()
    u = np.random.RandomState(1).uniform(size=(16, 24)).astype(np.float32)
    ref = JR.sample_from_lineseg(jnp.asarray(near), jnp.asarray(far), 24,
                                 perturb=perturb, lindisp=lindisp,
                                 u=jnp.asarray(u))
    got = TR.sample_from_lineseg(t(near), t(far), 24, perturb=perturb,
                                 lindisp=lindisp, u=t(u))
    _close(ref, got)


def _pdf_inputs(seed=0):
    rng = np.random.RandomState(seed)
    bins = np.sort(rng.uniform(0., 2., (16, 15)), -1).astype(np.float32)
    w = rng.uniform(0., 1., (16, 14)).astype(np.float32)
    w[0] = 0.                   # all-zero weights: the eps-flat pdf
    w[1, 3] = 50.               # one dominant bin
    return bins, w


@pytest.mark.parametrize('mode', ['det', 'given_u'])
def test_sample_pdf(mode):
    bins, w = _pdf_inputs()
    u = None
    if mode == 'given_u':
        u = np.random.RandomState(2).uniform(size=(16, 8)).astype(np.float32)
        u[2, :3] = [0., 1., 0.5]    # CDF endpoints and a midpoint
    ref = JR.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 8,
                        det=(mode == 'det'),
                        u=None if u is None else jnp.asarray(u))
    got = TR.sample_pdf(t(bins), t(w), 8, det=(mode == 'det'),
                        u=None if u is None else t(u))
    _close(ref, got)


@pytest.mark.parametrize('is_only', [False, True])
def test_isample_ranks_with_ties(is_only):
    near, far = _near_far()
    z = TR.sample_from_lineseg(t(near), t(far), 16).numpy()
    z[3] = z[3, 0]              # a degenerate ray: every depth ties
    rng = np.random.RandomState(3)
    w = rng.uniform(0., 1., (16, 16)).astype(np.float32)
    w[5] = 0.                   # flat weights: evenly spread samples
    u = rng.uniform(size=(16, 8)).astype(np.float32)
    u[7] = 0.5                  # identical uniforms: tied fine samples
    zs_ref, ranks_ref = JR.isample_ranks(jnp.asarray(z), jnp.asarray(w), 8,
                                         is_only=is_only, u=jnp.asarray(u))
    zs, ranks = TR.isample_ranks(t(z), t(w), 8, is_only=is_only, u=t(u))
    _close(zs_ref, zs)
    np.testing.assert_array_equal(np.asarray(ranks_ref), ranks.numpy())
    # ranks are a permutation, and the tie order is coarse-before-fine
    assert (np.sort(ranks.numpy(), -1) == np.arange(24)).all()
    cat = np.concatenate([z, zs.numpy()], -1)
    order = np.argsort(cat, -1, kind='stable')
    np.testing.assert_array_equal(np.argsort(order, -1), ranks.numpy())


@pytest.mark.parametrize('case', ['mixed', 'none_hit'])
def test_near_far_in_cylinder_grazing(case):
    rng = np.random.RandomState(4)
    R = 32
    rays_o = np.tile([[0., 0., 2.7]], (R, 1)).astype(np.float32)
    th = rng.uniform(-0.4, 0.4, (R, 2)).astype(np.float32)
    if case == 'none_hit':
        th[:, 0] += 2.0         # every ray passes far from the cylinder
    rays_d = np.stack([th[:, 0], th[:, 1], -np.ones(R, np.float32)], -1)
    cyl = np.tile([[0., 0., 0.3, -0.4, 0.3]], (R, 1)).astype(np.float32)
    ref = JR.get_near_far_in_cylinder(jnp.asarray(rays_o),
                                      jnp.asarray(rays_d), jnp.asarray(cyl),
                                      near=0.5, far=4.)
    got = TR.get_near_far_in_cylinder(t(rays_o), t(rays_d), t(cyl),
                                      near=0.5, far=4.)
    for a, b in zip(ref, got):
        _close(a, b)
    hit_ref = np.asarray(ref[0]) != np.asarray(ref[0])[0]
    if case == 'mixed':
        assert 0 < hit_ref.sum() < R  # some rays graze, some hit
    else:
        np.testing.assert_array_equal(got[0].numpy(), 0.5)
        np.testing.assert_array_equal(got[1].numpy(), 4.)


# ----------------------------------------------------------- encoders ----

def _pose(R=6, S=5):
    _, bones, _, kps, skts, cyls = T.synthetic_pose(R, seed=5)
    rng = np.random.RandomState(6)
    pts = rng.uniform(-0.5, 0.5, (R, S, 3)).astype(np.float32)
    rays_d = rng.normal(size=(R, 3)).astype(np.float32)
    return pts, rays_d, kps, skts, bones


@pytest.mark.parametrize('fn', ['transform_batch_pts',
                                'transform_batch_pts_cm', 'cm_transform_rows',
                                'transform_batch_rays', 'rel_dist',
                                'vec_norm'])
def test_encoders(fn):
    pts, rays_d, kps, skts, _ = _pose()
    J = lambda *a: getattr(JX, fn)(*[None if x is None else jnp.asarray(x)
                                     for x in a])
    P = lambda *a: getattr(TX, fn)(*[None if x is None else t(x) for x in a])
    if fn in ('transform_batch_pts', 'transform_batch_pts_cm'):
        args = (pts, skts)
    elif fn == 'cm_transform_rows':
        args = (skts,)
    elif fn == 'transform_batch_rays':
        args = (rays_d[:, None], skts)
    elif fn == 'rel_dist':
        args = (pts, np.asarray(JX.transform_batch_pts(jnp.asarray(pts),
                                                       jnp.asarray(skts))),
                kps)
    else:
        args = (np.asarray(JX.transform_batch_pts(jnp.asarray(pts),
                                                  jnp.asarray(skts))),)
    ref, got = J(*args), P(*args)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(ref, got):
        _close(a, b)


def test_cm_rows_order_is_shared():
    """transform_batch_pts_cm is the joint-major transform with the
    channel order c*J+j that the fused kernels' weight permutation
    assumes."""
    pts, _, _, skts, _ = _pose()
    jm = TX.transform_batch_pts(t(pts), t(skts))          # (R, S, J, 3)
    cm = TX.transform_batch_pts_cm(t(pts), t(skts))       # (R, S, 3J)
    _close(jm.transpose(-1, -2).reshape(cm.shape), cm)


# ---------------------------------------------------------- embedding ----

@pytest.mark.parametrize('which', ['kp', 'bone_plain', 'view_cutoff',
                                   'view_window_freqs_only', 'kp_no_input'])
def test_embed(which):
    pts, rays_d, kps, skts, _ = _pose()
    pts_t = np.asarray(JX.transform_batch_pts(jnp.asarray(pts),
                                              jnp.asarray(skts)))
    rays_t = np.asarray(JX.transform_batch_rays(jnp.asarray(rays_d)[:, None],
                                                jnp.asarray(skts)))
    dists = np.linalg.norm(pts_t, axis=-1).astype(np.float32)
    cutoff = np.full((24,), 0.3, np.float32)
    kw = {}
    if which == 'kp':
        cfg, x = dict(input_dims=24, num_freqs=7, cutoff=True,
                      cutoff_inputs=True), dists
    elif which == 'kp_no_input':
        cfg, x = dict(input_dims=24, num_freqs=3, cutoff=True,
                      include_input=False), dists
    elif which == 'bone_plain':
        cfg = dict(input_dims=72, num_freqs=2)
        x = np.asarray(JX.vec_norm(jnp.asarray(pts_t)))
    else:
        cfg = dict(input_dims=72, num_freqs=4, cutoff=True, dist_inputs=True,
                   cutoff_inputs=(which == 'view_cutoff'))
        x = np.asarray(JX.vec_norm(jnp.asarray(rays_t)))   # per-ray
    jc, tc = JE.EmbedConfig(**cfg), TE.EmbedConfig(**cfg)
    assert jc.out_dim == tc.out_dim
    ref, w_ref = JE.embed(jnp.asarray(x), jc, dists=jnp.asarray(dists),
                          cutoff_dist=jnp.asarray(cutoff), tau=30.0, **kw)
    got, w = TE.embed(t(x), tc, dists=t(dists), cutoff_dist=t(cutoff),
                      tau=torch.tensor(30.0), **kw)
    _close(ref, got)
    if w_ref is not None:
        _close(w_ref, w)


def test_tau_schedule():
    cfg = dict(input_dims=24, num_freqs=7, cutoff=True)
    for step in (0, 1234, 10 ** 6):
        _close(JE.tau_schedule(JE.EmbedConfig(**cfg), step, 250, 10.),
               TE.tau_schedule(TE.EmbedConfig(**cfg), step, 250, 10.))


# -------------------------------------------------------- compositing ----

def _raw(R=10, K=24, seed=7):
    rng = np.random.RandomState(seed)
    raw = rng.normal(size=(R, K, 4)).astype(np.float32)
    z = np.sort(rng.uniform(0.5, 2., (R, K)), -1).astype(np.float32)
    z[2] = 1.                   # a zero-length ray: acc 0 -> disp 0
    rays_d = rng.normal(size=(R, 3)).astype(np.float32)
    noise = rng.normal(size=(R, K)).astype(np.float32)
    return raw, z, rays_d, noise


@pytest.mark.parametrize('density', ['relu', 'softplus'])
@pytest.mark.parametrize('rows', [False, True])
def test_raw2outputs(rows, density):
    raw, z, rays_d, noise = _raw()
    ja, ta = JC.get_density_fn(density), TC.get_density_fn(density)
    if rows:
        jr = JC.raw2outputs_rows(*[jnp.asarray(raw[..., c]) for c in
                                   (3, 0, 1, 2)], jnp.asarray(z),
                                 jnp.asarray(rays_d),
                                 noise=jnp.asarray(noise), act_fn=ja,
                                 density_scale=2.)
        tr = TC.raw2outputs_rows(*[t(raw[..., c]) for c in (3, 0, 1, 2)],
                                 t(z), t(rays_d), noise=t(noise), act_fn=ta,
                                 density_scale=2.)
    else:
        jr = JC.raw2outputs(jnp.asarray(raw), jnp.asarray(z),
                            jnp.asarray(rays_d), noise=jnp.asarray(noise),
                            act_fn=ja, density_scale=2.)
        tr = TC.raw2outputs(t(raw), t(z), t(rays_d), noise=t(noise),
                            act_fn=ta, density_scale=2.)
    for k in jr:
        _close(jr[k], tr[k])


@pytest.mark.parametrize('rows', [False, True])
def test_raw2outputs_merged(rows):
    """Merged compositing through ranks (port) vs the one-hot rank
    permutation (JAX), on an unsorted concatenation with ties."""
    raw, _, rays_d, noise = _raw(K=24)
    rng = np.random.RandomState(8)
    zc = np.sort(rng.uniform(0.5, 2., (10, 16)), -1).astype(np.float32)
    zf = np.sort(rng.uniform(0.5, 2., (10, 8)), -1).astype(np.float32)
    zf[:, 0] = zc[:, 3]         # fine samples tying coarse ones
    zs, ranks = TR.isample_ranks(t(zc), t(np.ones((10, 16), np.float32)), 8,
                                 u=t(rng.uniform(size=(10, 8))
                                     .astype(np.float32)))
    z_cat = np.concatenate([zc, zs.numpy()], -1)
    P = jax.nn.one_hot(jnp.asarray(ranks.numpy()), 24, dtype=jnp.float32)
    if rows:
        jr = JC.raw2outputs_merged_rows(
            *[jnp.asarray(raw[..., c]) for c in (3, 0, 1, 2)],
            jnp.asarray(z_cat), P, jnp.asarray(rays_d),
            noise=jnp.asarray(noise))
        tr = TC.raw2outputs_merged_rows(
            *[t(raw[..., c]) for c in (3, 0, 1, 2)], t(z_cat), ranks,
            t(rays_d), noise=t(noise))
    else:
        jr = JC.raw2outputs_merged(jnp.asarray(raw), jnp.asarray(z_cat), P,
                                   jnp.asarray(rays_d),
                                   noise=jnp.asarray(noise))
        tr = TC.raw2outputs_merged(t(raw), t(z_cat), ranks, t(rays_d),
                                   noise=t(noise))
    for k in jr:
        _close(jr[k], tr[k])


# ---------------------------------------------------------------- MLP ----

def _nerf(compute_dtype, use_framecode=True):
    jcfg = JM.NeRFConfig(depth=6, width=32, input_ch=45, input_ch_bones=9,
                         input_ch_views=27, use_framecode=use_framecode,
                         framecode_ch=4, n_framecodes=5,
                         compute_dtype=(jnp.bfloat16 if compute_dtype == 'bf16'
                                        else jnp.float32))
    tcfg = TM.NeRFConfig(depth=6, width=32, input_ch=45, input_ch_bones=9,
                         input_ch_views=27, use_framecode=use_framecode,
                         framecode_ch=4, n_framecodes=5,
                         compute_dtype=(torch.bfloat16 if compute_dtype ==
                                        'bf16' else torch.float32))
    jp = JM.init_nerf_params(jax.random.PRNGKey(3), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize('cams', ['index', 'mean', 'lerp'])
@pytest.mark.parametrize('compute_dtype', ['f32', 'bf16'])
def test_nerf_forward(compute_dtype, cams):
    jcfg, tcfg, jp, tp = _nerf(compute_dtype)
    rng = np.random.RandomState(9)
    x = rng.normal(size=(7, 3, 54)).astype(np.float32)
    xv = rng.normal(size=(7, 3, 27)).astype(np.float32)
    if cams == 'lerp':
        idx = np.stack([rng.randint(0, 5, 7), rng.randint(0, 5, 7),
                        rng.uniform(size=7)], -1).astype(np.float32)
    else:
        idx = (rng.randint(0, 5, 7) if cams == 'index'
               else np.full(7, -1)).astype(np.int32)
    cj = JM.framecode_select(jp['framecodes'], jnp.asarray(idx))
    ct = TM.framecode_select(tp['framecodes'], t(idx))
    _close(cj, ct)
    ref = JM.nerf_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(xv),
                          codes=jnp.broadcast_to(cj[:, None], (7, 3, 4)))
    got = TM.nerf_forward(tp, tcfg, t(x), t(xv),
                          codes=ct[:, None].expand(7, 3, 4))
    _close(ref, got, 1e-5 if compute_dtype == 'f32' else 1e-3)


def test_init_nerf_params_layout():
    """The port's init draws the same tree shapes as anerf_tpu's, with
    U(+-1/sqrt(fan_in)) weights and N(0, 1) codes."""
    jcfg, tcfg, jp, _ = _nerf('f32')
    tp = TM.init_nerf_params(torch.Generator().manual_seed(0), tcfg)
    js = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    ts = jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
    assert js == ts
    for lin in tp['pts_linears']:
        bound = 1. / np.sqrt(lin['w'].shape[0])
        assert lin['w'].abs().max() <= bound and lin['b'].abs().max() <= bound
    assert 0.5 < tp['framecodes'].std() < 1.5


def test_interop_roundtrip():
    """A JAX parameter tree survives numpy -> torch -> numpy with its
    nested layout: lists stay lists, None stays None."""
    from anerf_torch.interop import params_to_numpy
    _, _, jp, _ = _nerf('f32')
    tree = {'coarse': jp, 'fine': None,
            'cutoff_dist': np.full((24,), 0.5, np.float32)}
    back = params_to_numpy(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree)))
    assert back['fine'] is None
    assert isinstance(back['coarse']['pts_linears'], list)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
