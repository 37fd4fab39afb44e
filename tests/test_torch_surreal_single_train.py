"""One train step of ``configs/surreal_single.txt`` on the port's fused
route (K1/K3 twins at one view PE row through their autograd Functions,
viewfac on the coarse pass where the gate takes it) against anerf_tpu's
``make_train_step`` on its own route for that config: its 'pallas'
backend, whose fused kernel returns None at S = 96 and 48, so that the
split kernels (``pallas_mlp``, interpret mode) run
(``test_torch_surreal_single.py`` has the route and a render chunk).

R = 8 rays, no draws (perturb 0, no density noise), the pose optimizer
firing, from the same state and batch.  Bars: those of
``test_torch_train_fused.py`` (both sides run the bf16 chain): losses
within 1e-4 relative, Adam's moments at cosine > 1 - 5e-4 and norm
within 2e-2, the parameter update at cosine > 0.99, the pose bank
within 1e-6.
"""
import jax
import jax.numpy as jnp

from anerf_tpu.models.factory import build_raycast_config as j_build
from anerf_tpu.skeleton import SMPLSkeleton as JSMPL
from anerf_tpu.training import pose_opt as JP
from anerf_tpu.training import trainer as JT

from anerf_torch import testing_utils as T
from anerf_torch.interop import train_state_from_jax
from anerf_torch.models.factory import build_raycast_config as t_build
from anerf_torch.ops import fused_encmlp as FE
from anerf_torch.skeleton import SMPLSkeleton
from anerf_torch.training import pose_opt as P
from anerf_torch.training import trainer as TT

from test_torch_surreal_single import N_FRAMES, _cfg
from test_torch_train import (_compare_states, _jax_numpy_state, _run,
                              train_state_to_numpy)
from test_torch_threads import one_torch_thread  # noqa: F401


def test_train_step_matches_anerf_tpu_route():
    """One step on the port's fused route against anerf_tpu's
    ``make_train_step`` on its 'pallas' backend (the split kernels at
    S = 96) from the same state and batch."""
    R = 8
    over = dict(perturb=0., raw_noise_std=0., opt_pose=True,
                opt_pose_step=2, opt_pose_coef=0.1, opt_pose_lrate=5e-3)
    cfg_j, cfg_t = _cfg('pallas', R, **over), _cfg('auto', R, **over)
    rest, bones, _, kps, skts, cyls = T.synthetic_pose(N_FRAMES)
    batch = T.synthetic_batch(R, N_FRAMES, kps, skts, bones, cyls)
    j_setup = JT.TrainSetup(
        cfg=cfg_j, rc=j_build(cfg_j, n_framecodes=N_FRAMES), skel=JSMPL,
        rest_pose=jnp.asarray(rest), anchors=JP.make_anchors(kps, bones),
        near=0.0, far=1.0)
    j_state = JT.init_train_state(j_setup, jax.random.PRNGKey(0),
                                  init_kp3d=kps, init_bones=bones)
    t_setup = TT.TrainSetup(
        cfg=cfg_t, rc=t_build(cfg_t, n_framecodes=N_FRAMES),
        skel=SMPLSkeleton, rest_pose=rest, anchors=P.make_anchors(kps, bones),
        near=0.0, far=1.0, device='cpu')
    assert t_setup.rc.mlp_backend == 'fused'
    assert FE.kernel_shape_ok(t_setup.rc)
    ts = train_state_from_jax(j_state)
    before = (_jax_numpy_state(j_state), train_state_to_numpy(ts))
    js, ts = _run(jax.jit(JT.make_train_step(j_setup)), j_state,
                  {k: jnp.asarray(v) for k, v in batch.items()},
                  TT.make_train_step(t_setup), ts, T.to_device(batch, 'cpu'),
                  1, loss_rtol=1e-4)
    _compare_states(js, ts, pose_atol=1e-6, mom_cos=5e-4, mom_ratio=2e-2,
                    upd_from=before, upd_cos=1e-2)
