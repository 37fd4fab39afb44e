"""One train step of the port's fused backend (the K1-K4 twins through
their autograd Functions) against anerf_tpu's ``make_train_step`` with
the Pallas kernels in interpret mode, on the CPU; the setup and the
comparisons are those of ``test_torch_train.py``.

Tolerances.  Both sides run the bf16 chain, where a rounding flip of a
density moves the compositing weights of a ray, and at R=8 a few rays
carry each gradient: losses within 1e-4 relative (measured 1e-7),
moments cosine > 1 - 5e-4 and norm within 2e-2 (measured 1 - 1.1e-4 and
8.0e-3; anerf_tpu's own fused-vs-XLA gradient bar is 0.98 and 0.1,
tests/test_pallas_encmlp.py:257-258), and the step-one parameter update,
about +-lr per element, in direction: cosine > 0.99, since one flipped
sign among the 256 entries of a bias moves it by 2/256 (measured
1 - 1.1e-3).
"""
import jax

from test_torch_train import (_compare_states, _jax_numpy_state, _run,
                              _setups, train_state_to_numpy)

from anerf_tpu.training import trainer as JT

from anerf_torch.interop import train_state_from_jax
from anerf_torch.training import trainer as TT

from test_torch_threads import one_torch_thread  # noqa: F401


def test_step_fused_twins_match_pallas_interpret():
    """One step on the fused backend (K1-K4 twins through the autograd
    Functions) against JAX's Pallas kernels in interpret mode."""
    j_setup, j_state, jb, t_setup, tb = _setups('pallas', 'fused',
                                                'bfloat16')
    assert t_setup.rc.mlp_backend == 'fused'
    ts = train_state_from_jax(j_state)
    before = (_jax_numpy_state(j_state), train_state_to_numpy(ts))
    js, ts = _run(jax.jit(JT.make_train_step(j_setup)), j_state, jb,
                  TT.make_train_step(t_setup), ts, tb, 1, loss_rtol=1e-4)
    _compare_states(js, ts, pose_atol=1e-6, mom_cos=5e-4, mom_ratio=2e-2,
                    upd_from=before, upd_cos=1e-2)
