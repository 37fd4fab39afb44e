"""``configs/surreal_single.txt`` on the port's fused route (K1/K3 at one
view PE row: one net on the 96 coarse and the 48 importance samples)
against anerf_tpu's own route for that config, on the CPU.

anerf_tpu does not fuse this config at its shipped sample counts: its
tile loop (``pallas_encmlp._build_call``) finds no tile that S = 96 or
48 divides and returns None, so its 'pallas' backend runs the split
kernels (``pallas_mlp``, here in interpret mode).  The port's kernels
mask their ragged edge and take every (R, S), so the port fuses it;
the function computed is the same.  The port's viewfac gate, priced at
the 128-point tile the loop ends at, takes the view factorization for
the coarse pass (S = 96) and not for the fine one (S = 48).

* the route: K1 twice a render (the twins on the CPU), viewfac on the
  coarse pass only;
* one render chunk at the eval variant against anerf_tpu's on the same
  parameters: the maps within 1e-3 x the reference map's max
  (``test_torch_render.py``'s bar);

One train step on that route against anerf_tpu's:
``test_torch_surreal_single_train.py``.
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

from anerf_tpu.models import raycaster as jrc
from anerf_tpu.models.factory import build_raycast_config as j_build
from anerf_tpu.models.factory import embed_state as j_embed_state
from anerf_tpu.models.factory import init_raycaster_params as j_init

from anerf_torch import testing_utils as T
from anerf_torch.interop import params_from_numpy
from anerf_torch.models import raycaster as trc
from anerf_torch.models.factory import build_raycast_config as t_build
from anerf_torch.models.factory import embed_state as t_embed_state
from anerf_torch.models.factory import init_raycaster_params as t_init
from anerf_torch.ops import fused_encmlp as FE
from anerf_torch.utils.config import parse_config_txt

from test_torch_render import MAPS, _close
from test_torch_threads import one_torch_thread  # noqa: F401

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'configs', 'surreal_single.txt')
N_FRAMES = 4
POSE_KEYS = ('kps', 'skts', 'bones', 'cyls')


def _cfg(backend, n_rays, **over):
    """surreal_single's settings over the SURREAL test recipe (which adds
    framecodes), bf16, ``backend`` as the MLP backend."""
    shipped = parse_config_txt(CONFIG)
    shipped.pop('N_rand')
    return T.surreal_config(**dict(shipped, N_rand=n_rays,
                                   mlp_backend=backend,
                                   compute_dtype='bfloat16', **over))


def test_route_is_k1_with_viewfac_on_the_coarse_pass(monkeypatch):
    """K1 on both passes at the one-row build, viewfac where the gate
    takes it (the coarse pass)."""
    cfg = _cfg('auto', 8)
    rc = t_build(cfg, n_framecodes=N_FRAMES)
    assert rc.mlp_backend == 'fused' and rc.single_net
    assert FE.kernel_shape_ok(rc)
    seen = []
    inner = FE.encmlp_fwd

    def spy(st, est, *a, **k):
        seen.append((est.S, est.viewfac, FE.kernel_shape(st, est)))
        return inner(st, est, *a, **k)
    monkeypatch.setattr(FE, 'encmlp_fwd', spy)
    _, bones, _, kps, skts, cyls = T.synthetic_pose(N_FRAMES)
    b = T.to_device(T.synthetic_batch(8, N_FRAMES, kps, skts, bones, cyls),
                    'cpu')
    params = t_init(torch.Generator().manual_seed(0), rc, cfg)
    with torch.inference_mode():
        trc.render_rays(rc.eval_variant(), params, b['rays_o'], b['rays_d'],
                        0., 1., {k: b[k] for k in POSE_KEYS},
                        t_embed_state(cfg, rc, 0), cam_idxs=b['cam_idxs'])
    one_row = (7, 1, False, 8, 256, 16)
    assert seen == [(96, True, one_row), (48, False, one_row)]


def test_render_chunk_matches_anerf_tpu_route():
    """One chunk at the eval variant: the port's K1 twins against
    anerf_tpu's split Pallas kernels (interpret mode)."""
    n = 12
    cfg = _cfg('pallas', n)
    _, bones, _, kps, skts, cyls = T.synthetic_pose(N_FRAMES)
    b = T.synthetic_batch(n, N_FRAMES, kps, skts, bones, cyls)
    j_rc = j_build(cfg, n_framecodes=N_FRAMES).eval_variant()
    t_rc = dataclasses.replace(t_build(cfg, n_framecodes=N_FRAMES),
                               mlp_backend='fused').eval_variant()
    j_params = j_init(jax.random.PRNGKey(0), j_rc, cfg)
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        j_params))
    ref = jrc.render_rays(
        j_rc, j_params, jnp.asarray(b['rays_o']), jnp.asarray(b['rays_d']),
        0., 1., {k: jnp.asarray(b[k]) for k in POSE_KEYS},
        j_embed_state(cfg, j_rc, 10000), cam_idxs=jnp.asarray(b['cam_idxs']))
    tb = T.to_device(b, 'cpu')
    with torch.inference_mode():
        got = trc.render_rays(
            t_rc, t_params, tb['rays_o'], tb['rays_d'], 0., 1.,
            {k: tb[k] for k in POSE_KEYS}, t_embed_state(cfg, t_rc, 10000),
            cam_idxs=tb['cam_idxs'])
    assert np.asarray(ref['acc_map']).max() > 0.5   # the rays hit
    for k in MAPS:
        _close(ref[k], got[k])
