"""K1/K2's twins at the static shapes the fused encode kernels are built
for beyond the flagship's (ROADMAP B.1), against anerf_tpu's
``pallas_encmlp`` on the CPU.

The shapes: one view PE row (``multires_views = 0``, surreal_single's),
five and seven; four kp bands with six layers; four layers (no skip
layer); the windowed bone directions (``--cutoff_bones``); and those
whose trunk input does not stay in a block's shared memory in some of
K1-K4 (ROADMAP B.1.2): two 8 x 512 nets, nine layers, eight kp bands,
and the corner of the gate, 16 layers of 512 at ten kp bands; and the
kp bands past ten (ROADMAP B.1.4's kp-band row): eleven, and the cap
``fused_encmlp.F_MAX`` (13), past which anerf_tpu's band recurrence no
longer holds to the model (C.17); and a net deeper than 16 layers
(B.1.4's depth row), 20 layers of 256.  Each is
built from the same seed-made parameters in both packages (the JAX tree
converted with ``params_from_numpy``), at R=8 rays and full width, with
the viewfac form off on both sides (its chain:
``test_torch_viewfac.py``; K-vf1/K-vf2 at seven rows and at the 256-wide
views layer on the card).  The samples per ray are ones anerf_tpu's
kernels tile (16 and 64): at surreal_single's 96 its ``_build_call``
returns None and it runs its split kernels, which
``test_torch_surreal_single.py`` compares against.  The resident shapes
and 8 x 512 run at both (K2 at 64, K1 at 16); nine layers, eight bands,
the corner and 20 layers at one each (``SAMPLES``), to keep the
interpret mode's seconds in check.

* the gate admits each shape on both sides, with the build key the
  port's libraries are keyed by;
* K2's twin at S=64 and K1's at S=16 against the Pallas kernels in
  interpret mode.  Bars: those of ``test_torch_fused_encmlp.py``, each
  raw channel within 1e-4 x its scale on average and 1e-2 x at its
  worst point: both run the same bf16-operand chain, which differs only
  where f32 rounding flips a bf16 rounding between layers.

The backwards (K3/K4) at the same shapes: ``test_torch_encmlp_shapes_
bwd.py``.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anerf_tpu.models.factory import build_raycast_config as j_build
from anerf_tpu.models.factory import init_raycaster_params as j_init
from anerf_tpu.ops import encoders as JX
from anerf_tpu.ops import pallas_encmlp as PE

from anerf_torch import testing_utils as T
from anerf_torch.interop import params_from_numpy
from anerf_torch.models.factory import build_raycast_config as t_build
from anerf_torch.ops import fused_encmlp as FE

from test_torch_fused_encmlp import _assert_raw_close, _pts_cm
from test_torch_threads import one_torch_thread  # noqa: F401

# name: (config overrides, the build key (kp bands, view rows, bone
# window, depth, width, framecode columns))
SHAPES = {
    'nb1': (dict(multires_views=0), (7, 1, False, 8, 256, 16)),
    'nb5': (dict(multires_views=2), (7, 5, False, 8, 256, 16)),
    'nb7': (dict(multires_views=3), (7, 7, False, 8, 256, 16)),
    'nf4_depth6': (dict(multires=4, netdepth=6, netdepth_fine=6),
                   (4, 9, False, 6, 256, 16)),
    'depth4': (dict(netdepth=4, netdepth_fine=4), (7, 9, False, 4, 256, 16)),
    'cutoff_bones': (dict(cutoff_bones=True), (7, 9, True, 8, 256, 16)),
    'w512': (dict(netwidth=512, netwidth_fine=512),
             (7, 9, False, 8, 512, 16)),
    'depth9': (dict(netdepth=9, netdepth_fine=9), (7, 9, False, 9, 256, 16)),
    'nf8': (dict(multires=8), (8, 9, False, 8, 256, 16)),
    'w512_depth16_nf10': (dict(netwidth=512, netwidth_fine=512,
                               netdepth=16, netdepth_fine=16, multires=10),
                          (10, 9, False, 16, 512, 16)),
    'nf11': (dict(multires=11), (11, 9, False, 8, 256, 16)),
    f'nf{FE.F_MAX}': (dict(multires=FE.F_MAX),
                      (FE.F_MAX, 9, False, 8, 256, 16)),
    'depth20': (dict(netdepth=20, netdepth_fine=20),
                (7, 9, False, 20, 256, 16)),
}
# the samples each shape's twins are held at: K2 (and K4) at 64, K1
# (and K3) at 16
SAMPLES = {name: (64, 16) for name in SHAPES}
SAMPLES.update(depth9=(16,), nf8=(64,), w512_depth16_nf10=(16,),
               depth20=(16,))
CASES = [(name, S) for name in sorted(SHAPES) for S in SAMPLES[name]]
# the backwards' cases: 8 x 512 and eight kp bands at S=16 (K3's twin;
# K4's two nets at S=64 take 12-20 s each in interpret mode alone, 55 s
# in the suite), the rest as the forwards'
BWD_CASES = [c for c in CASES if c != ('w512', 64)]
BWD_CASES[BWD_CASES.index(('nf8', 64))] = ('nf8', 16)
# the shapes whose trunk input leaves shared memory in some of K1-K4
# (ROADMAP B.1.2), whose backward cases test_torch_encmlp_shapes_bwd_b12.py
# holds apart (one file of them all would run past a minute alone)
B12_SHAPES = ('w512', 'depth9', 'nf8', 'w512_depth16_nf10')
# the kp bands past ten, whose backward cases (K3's twin at S=16, K4's
# at S=64) test_torch_encmlp_shapes_bwd.py holds in a test of their own
BAND_SHAPES = ('nf11', f'nf{FE.F_MAX}')
BAND_CASES = [(name, S) for name in BAND_SHAPES for S in (64, 16)]
_SCENES = {}


def shape_scene(name, seed=0, rays=8):
    """The scene of shape ``name`` (built once a process): both
    packages' configs and parameters (JAX seed ``seed``), the batch of
    ``rays`` rays and poses (numpy seed ``seed``) and the rays'
    joint-local directions."""
    key = (name, seed, rays)
    if key not in _SCENES:
        cfg = T.surreal_config(N_rand=rays, compute_dtype='bfloat16',
                               **SHAPES[name][0])
        _, bones, _, kps, skts, cyls = T.synthetic_pose(4, seed=seed)
        batch = T.synthetic_batch(rays, 4, kps, skts, bones, cyls, seed=seed)
        j_rc = dataclasses.replace(j_build(cfg, n_framecodes=4),
                                   viewfac=False)
        j_params = j_init(jax.random.PRNGKey(seed), j_rc, cfg)
        t_rc = dataclasses.replace(t_build(cfg, n_framecodes=4),
                                   viewfac=False)
        t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                            j_params))
        rays_t = JX.transform_batch_rays(
            jnp.asarray(batch['rays_d'])[:, None], jnp.asarray(batch['skts']))
        _SCENES[key] = dict(
            cfg=cfg, batch=batch, j_rc=j_rc, j_params=j_params, t_rc=t_rc,
            t_params=t_params, rays_t_norm=np.asarray(JX.vec_norm(rays_t)[:, 0]))
    return _SCENES[key]


@pytest.mark.parametrize('name', sorted(SHAPES))
def test_shape_is_admitted(name):
    """Both packages' fused encode takes the config; the port's gate
    admits it with the build that carries its shape, and anerf_tpu's
    statics agree with the port's."""
    s = shape_scene(name)
    assert PE.supported_config(s['j_rc']) and FE.kernel_shape_ok(s['t_rc'])
    pts = _pts_cm(s['batch'], 16)
    st_j, est_j = PE._build_call(
        s['j_rc'], jnp.asarray(pts), jnp.asarray(s['rays_t_norm']),
        s['j_params']['cutoff_dist'], 20., None, True, None, cm=True)[:2]
    st_t, est_t = FE._build_call(
        s['t_rc'], torch.as_tensor(pts), torch.as_tensor(s['rays_t_norm']),
        s['t_params']['cutoff_dist'], 20., None, None)[:2]
    assert FE.kernel_shape(st_t, est_t) == SHAPES[name][1]
    assert (st_t.depth, st_t.dparts, st_t.vparts) == \
        (st_j.depth, st_j.dparts, st_j.vparts)
    assert (est_t.view_nb, est_t.kp_freqs, est_t.bone_windowed) == \
        (est_j.view_nb, tuple(est_j.kp_freqs), est_j.bone_windowed)


@pytest.mark.parametrize('name,S', CASES, ids=[f'{n}-{S}' for n, S in CASES])
def test_fwd_twins_match_pallas_interpret(name, S):
    """K2's twin at S=64 (the coarse pass) and K1's at S=16 (the fine
    pass) against the Pallas kernels in interpret mode."""
    s = shape_scene(name)
    pts = _pts_cm(s['batch'], S)
    cam = s['batch']['cam_idxs']
    tau = 21.9
    jargs = (jnp.asarray(pts), jnp.asarray(s['rays_t_norm']),
             s['j_params']['cutoff_dist'], tau, jnp.asarray(cam))
    targs = (torch.as_tensor(pts), torch.as_tensor(s['rays_t_norm']),
             s['t_params']['cutoff_dist'], tau, torch.as_tensor(cam))
    jp, tp = s['j_params'], s['t_params']
    if S == 64:
        ref = PE.nerf_encmlp_dual_pallas(jp['coarse'], jp['fine'], s['j_rc'],
                                         *jargs, interpret=True, cm=True)
        got = FE.nerf_encmlp_dual(tp['coarse'], tp['fine'], s['t_rc'],
                                  *targs)
    else:
        ref = (PE.nerf_encmlp_pallas(jp['fine'], s['j_rc'], *jargs,
                                     interpret=True, cm=True),)
        got = (FE.nerf_encmlp(tp['fine'], s['t_rc'], *targs),)
    assert ref[0] is not None   # anerf_tpu's kernel takes the shape
    for a, b in zip(ref, got):
        assert tuple(b.shape) == (4, 8, S)
        _assert_raw_close(a, b)
