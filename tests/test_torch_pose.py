"""Rotations, forward kinematics, the pose bank and the losses of the
port against anerf_tpu on the CPU: values and VJPs (``jax.vjp`` against
``torch.autograd.grad`` with the same numpy cotangent), in f32.

Tolerance: both sides evaluate the same f32 formulas, so they differ by
the libraries' rounding of sin/cos/sqrt and of summation order: values
within 1e-5 relative (2e-5 through the 8-level FK chain, whose products
compound the rounding), gradients within 1e-4 relative of the largest
element (the VJPs sum many such terms).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anerf_tpu.ops import fk as JF
from anerf_tpu.ops import rotations as JR
from anerf_tpu.skeleton import SMPLSkeleton as JSMPL
from anerf_tpu.training import losses as JL
from anerf_tpu.training import pose_opt as JP

from anerf_torch import testing_utils as T
from anerf_torch.ops import fk as TF
from anerf_torch.ops import rotations as TR
from anerf_torch.skeleton import SMPLSkeleton
from anerf_torch.training import losses as TL
from anerf_torch.training import pose_opt as TP

from test_torch_threads import one_torch_thread  # noqa: F401


def _check(jfn, tfn, args, val_rtol=1e-5, grad_rtol=1e-4, seed=0):
    """Values and VJPs of ``jfn`` (jax) and ``tfn`` (torch) on the same
    numpy ``args``; every output gets a random numpy cotangent."""
    jouts, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    touts = tfn(*leaves)
    jl = jax.tree_util.tree_leaves(jouts)
    tl = touts if isinstance(touts, (tuple, list)) else [touts]
    assert len(jl) == len(tl)
    rng = np.random.RandomState(seed)
    cts = []
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(b.detach().numpy(), a, rtol=0,
                                   atol=val_rtol * scale)
        cts.append(rng.normal(size=a.shape).astype(np.float32))
    jg = vjp(jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jouts), [jnp.asarray(c) for c in cts]))
    if any(t.requires_grad for t in tl):
        tg = torch.autograd.grad(tl, leaves, [torch.as_tensor(c) for c in cts],
                                 allow_unused=True)
    else:       # a statistic of detached values: no gradient on either side
        tg = [None] * len(leaves)
    for a, b in zip(jg, tg):
        a = np.asarray(a)
        b = np.zeros_like(a) if b is None else b.numpy()
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=grad_rtol * (np.abs(a).max() + 1e-12))


def _axisang(n, scale, seed=0):
    return np.random.RandomState(seed).normal(
        scale=scale, size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize('scale', [0.5, 2.0, 1e-5, 0.0])
def test_axisang_to_rot(scale):
    """Rodrigues at ordinary angles, and the small-angle series (theta^2
    below 1e-8) including theta = 0 exactly, where the other branch's
    gradient would be NaN without its guard."""
    x = _axisang(16, scale)
    _check(JR.axisang_to_rot, TR.axisang_to_rot, [x])
    xt = torch.tensor(x, requires_grad=True)
    g, = torch.autograd.grad(TR.axisang_to_rot(xt).sum(), [xt])
    assert torch.isfinite(g).all()


def test_rot6d_and_skew():
    x = np.random.RandomState(1).normal(size=(10, 6)).astype(np.float32)
    _check(JR.rot6d_to_rotmat, TR.rot6d_to_rotmat, [x])
    r = np.random.RandomState(2).normal(size=(5, 3, 3)).astype(np.float32)
    _check(JR.rot_to_rot6d, TR.rot_to_rot6d, [r])
    v = np.random.RandomState(3).normal(size=(7, 3)).astype(np.float32)
    _check(JR.skew, TR.skew, [v])
    for w in (3, 6):
        b = np.random.RandomState(4).normal(size=(4, w)).astype(np.float32)
        _check(JR.bones_to_rot, TR.bones_to_rot, [b])


@pytest.mark.parametrize('width', [3, 6])
def test_fk(width):
    """kps, skts, l2ws and rots of the full chain, axis-angle and 6D."""
    rest, bones, pelvis, _, _, _ = T.synthetic_pose(3)
    if width == 6:
        bones = np.asarray(JR.rot_to_rot6d(JR.axisang_to_rot(
            jnp.asarray(bones))))
    _check(lambda b, p: JF.fk(b, p, jnp.asarray(rest), JSMPL),
           lambda b, p: TF.fk(b, p, torch.as_tensor(rest), SMPLSkeleton),
           [bones, pelvis], val_rtol=2e-5)


def test_rigid_inverse_and_hom():
    rest, bones, pelvis, _, _, _ = T.synthetic_pose(2)
    l2ws = np.asarray(JF.fk(jnp.asarray(bones), jnp.asarray(pelvis),
                            jnp.asarray(rest))[2])
    _check(JF.rigid_inverse, TF.rigid_inverse, [l2ws])
    rot, tr = l2ws[..., :3, :3], l2ws[..., :3, 3]
    _check(JF.mat_to_hom, TF.mat_to_hom, [rot, tr])


def test_pose_fk_gathers_the_bank():
    rest, bones, pelvis, kps, _, _ = T.synthetic_pose(4)
    idxs = np.array([3, 0, 0, 2])
    jbank = JP.init_pose_params(kps, bones)
    tbank = TP.init_pose_params(kps, bones)
    np.testing.assert_array_equal(tbank['pelvis'].numpy(),
                                  np.asarray(jbank['pelvis']))

    def jfn(pel, bon):
        return JP.pose_fk({'pelvis': pel, 'bones': bon}, jnp.asarray(idxs),
                          jnp.asarray(rest), JSMPL)

    def tfn(pel, bon):
        return TP.pose_fk({'pelvis': pel, 'bones': bon},
                          torch.as_tensor(idxs), torch.as_tensor(rest),
                          SMPLSkeleton)
    _check(jfn, tfn, [np.asarray(jbank['pelvis']),
                      np.asarray(jbank['bones'])], val_rtol=2e-5)
    r6 = TP.init_pose_params(kps, bones, use_rot6d=True)['bones']
    np.testing.assert_allclose(
        r6.numpy(), np.asarray(JP.init_pose_params(kps, bones,
                                                   use_rot6d=True)['bones']),
        rtol=0, atol=1e-6)


def test_pose_bank_owns_its_memory():
    """The bank is updated in place: on the CPU it must not share memory
    with the caller's arrays or with anchors made from them (which would
    then move with the bank, as JAX's immutable arrays never do)."""
    _, bones, _, kps, _, _ = T.synthetic_pose(4)
    kps0, bones0 = kps.copy(), bones.copy()
    bank = TP.init_pose_params(kps, bones)
    anchors = TP.make_anchors(kps, bones)
    for t in bank.values():
        t.add_(1.)
    np.testing.assert_array_equal(kps, kps0)
    np.testing.assert_array_equal(bones, bones0)
    np.testing.assert_array_equal(anchors['bones'].numpy(), bones0)
    np.testing.assert_array_equal(anchors['kps'].numpy(), kps0)


def test_gather_bones_with_kp_map():
    """Multiview banks: per-view root bones, shared non-root bones
    through ``kp_map`` (reference pose_opt.py:290-295,318-332)."""
    _, bones, _, kps, _, _ = T.synthetic_pose(4)
    kp_map, uidxs = np.array([0, 0, 1, 1]), np.array([0, 2])
    idxs = np.array([3, 1, 2])
    jb = JP.init_pose_params(kps, bones, kp_map=kp_map, kp_uidxs=uidxs)
    tb = TP.init_pose_params(kps, bones, kp_map=kp_map, kp_uidxs=uidxs)
    assert sorted(jb) == sorted(tb)
    _check(lambda r, b: JP.gather_bones({'root_bones': r, 'bones': b},
                                        jnp.asarray(idxs),
                                        jnp.asarray(kp_map)),
           lambda r, b: TP.gather_bones({'root_bones': r, 'bones': b},
                                        torch.as_tensor(idxs),
                                        torch.as_tensor(kp_map)),
           [np.asarray(jb['root_bones']), np.asarray(jb['bones'])])


@pytest.mark.parametrize('rot6d', [False, True])
def test_kp_reg_and_temporal_losses(rot6d):
    rest, bones, pelvis, kps, _, _ = T.synthetic_pose(4)
    ja, ta = JP.make_anchors(kps, bones), TP.make_anchors(kps, bones)
    rng = np.random.RandomState(5)
    idx = np.array([0, 3, 1, 1, 2])
    pred = (bones[idx] + rng.normal(scale=0.05, size=bones[idx].shape)
            ).astype(np.float32)
    rots = np.asarray(JR.axisang_to_rot(jnp.asarray(pred)))
    for per_ray in (False, True):
        _check(lambda b, r: JP.kp_reg_loss(b, r, ja, jnp.asarray(idx), 1e-3,
                                           0.1, rot6d, per_ray),
               lambda b, r: TP.kp_reg_loss(b, r, ta, torch.as_tensor(idx),
                                           1e-3, 0.1, rot6d, per_ray),
               [pred, rots])
    k = kps[idx]
    others = [(pred + rng.normal(scale=0.02, size=pred.shape)).astype(
        np.float32) for _ in range(2)]
    ks = [(k + rng.normal(scale=0.01, size=k.shape)).astype(np.float32)
          for _ in range(2)]
    valid = np.array([1, 0, 1, 1, 1], np.float32)
    _check(lambda b, kk, pb, pk, nb, nk, v: JP.temporal_loss(
               b, kk, pb, pk, nb, nk, v, 0.05),
           lambda b, kk, pb, pk, nb, nk, v: TP.temporal_loss(
               b, kk, pb, pk, nb, nk, v, 0.05),
           [pred, k, others[0], ks[0], others[1], ks[1], valid])
    _check(lambda kk: JP.mpjpc_stat(kk, ja, jnp.asarray(idx), 0.001),
           lambda kk: TP.mpjpc_stat(kk, ta, torch.as_tensor(idx), 0.001),
           [(k + 0.01).astype(np.float32)])


@pytest.mark.parametrize('name', ['MSE', 'L1', 'Huber'])
@pytest.mark.parametrize('yuv', [False, True])
def test_photometric_losses(name, yuv):
    rng = np.random.RandomState(6)
    x = rng.uniform(size=(32, 3)).astype(np.float32)
    y = rng.uniform(size=(32, 3)).astype(np.float32)
    jf, tf = JL.get_loss_fn(name, 0.1, yuv), TL.get_loss_fn(name, 0.1, yuv)
    for red in ('mean', 'sum', 'none'):
        _check(lambda a, b: jf(a, b, reduction=red),
               lambda a, b: tf(a, b, reduction=red), [x, y])
    _check(JL.img2psnr, TL.img2psnr, [x, y])


@pytest.mark.parametrize('name', ['BCE', 'L1', 'MSE'])
def test_reg_losses(name):
    """The 'off' reduction (pixels off the foreground) and the BCE guard
    at fully opaque rays (acc == 1), where 1 - x + eps would take
    log(0)."""
    rng = np.random.RandomState(7)
    x = rng.uniform(size=(40,)).astype(np.float32)
    x[:3] = 1.0
    y = (rng.uniform(size=(40,)) > 0.5).astype(np.float32)
    jf, tf = JL.get_reg_fn(name), TL.get_reg_fn(name)
    for red in ('off', 'mean', 'sum'):
        _check(lambda a, b: jf(a, b, reduction=red),
               lambda a, b: tf(a, b, reduction=red), [x, y])
    assert TL.get_reg_fn(None) is None
    assert torch.isfinite(TL.acc2bce(torch.ones(4), torch.zeros(4)))
