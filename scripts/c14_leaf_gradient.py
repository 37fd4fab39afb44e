"""The gradient of the one-element leaf that misses the Adam moment-norm
bar at ``tests/test_torch_parallel.py``'s tiny config (ROADMAP C.14),
read in f32 from the port and from anerf_tpu, and in f64 from the port.

    JAX_PLATFORMS=cpu python scripts/c14_leaf_gradient.py

The config and batch are ``tests/test_trainer.py``'s
(``tiny_config(opt_pose=True, opt_pose_step=1, opt_pose_coef=0.1,
perturb=0, raw_noise_std=0)``, 16 rays).  For every parameter leaf it
prints the first-step gradient's relative difference between the two
packages (anerf_tpu's gradient read from its first Adam moment, mu =
(1 - b1) g); for the worst one-element leaf, the gradient in f64 (the
port with every tensor in float64: ``Tensor.float`` kept in f64 and the
dense layers computed in f64), the sum of the magnitudes of the
per-point terms that make it (the cotangents of that bias's outputs),
and each f32 gradient's distance from the f64 one.  On the CPU.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, 'tests')]

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import _torch_parallel_worker as W  # noqa: E402
from anerf_torch.interop import train_state_from_jax  # noqa: E402
from anerf_torch.models import nerf_mlp as NM  # noqa: E402
from anerf_torch.skeleton import SMPL_REST_POSE  # noqa: E402
from anerf_torch.training import trainer as TT  # noqa: E402
from anerf_tpu.training import trainer as JT  # noqa: E402
from test_torch_parallel import TRAIN, _numpy_batch, _port_kwargs  # noqa
from test_trainer import make_setup_and_batch, tiny_config  # noqa: E402


def main():
    jcfg = tiny_config(**TRAIN)
    setup, batch, (kps, bones) = make_setup_and_batch(jcfg)
    j_state = JT.init_train_state(setup, jax.random.PRNGKey(0),
                                  init_kp3d=kps, init_bones=bones)
    start = W.to_numpy(train_state_from_jax(j_state))
    spec = dict(cfg=_port_kwargs(jcfg), n_frames=3,
                rest=SMPL_REST_POSE * 0.0022, kps=np.asarray(kps),
                bones=np.asarray(bones), near=0.1, far=6.0)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(j_state['params'])]
    js, _ = jax.jit(JT.make_train_step(setup))(j_state, batch,
                                              jax.random.PRNGKey(0))
    b1 = np.float32(1) - np.float32(0.9)
    g_jax = [np.asarray(m, np.float64).ravel() / b1 for m in
             jax.tree_util.tree_leaves(js['opt_state'][0].mu)]

    terms, target = [], {}

    def port_grads(f64):
        """The port's first-step NeRF gradients; ``terms`` collects the
        cotangents of the outputs of the dense layer whose bias is the
        ``target`` leaf."""
        terms.clear()
        state = W.to_torch(start)
        tb = W.to_torch(_numpy_batch(batch))
        if f64:
            cast = lambda t: t.double() if torch.is_tensor(t) and \
                t.is_floating_point() else t
            state = {k: TT.tree_map(cast, v) if isinstance(v, (dict, list))
                     else v for k, v in state.items()}
            tb = {k: cast(v) for k, v in tb.items()}
        if target:
            net, layer = target['path']
            target['bias'] = state['params'][net][layer]['b']
        _, g, _ = TT.loss_and_grads(W._setup(spec), state, tb)
        return [x.detach().double().numpy().ravel() for x in g]

    def hooked(dense):
        def run(p, x, dtype):
            y = dense(p, x, dtype)
            if target and p['b'] is target['bias'] and y.requires_grad:
                y.register_hook(lambda c: terms.append(
                    c.detach().double().numpy().ravel()))
            return y
        return run

    g32 = port_grads(False)
    rel = lambda a, b: np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
    print('first-step gradient, port f32 against anerf_tpu f32 (relative):')
    for n, a, b in zip(names, g32, g_jax):
        print(f'  {n} ({a.size}): {rel(a, b):.2e}')
    i = max((i for i, g in enumerate(g32) if g.size == 1),
            key=lambda i: rel(g32[i], g_jax[i]))
    name = names[i]
    target['path'] = tuple(name.strip("[]'").split("']['"))[:2]

    real_dense, real_float = NM._dense, torch.Tensor.float
    NM._dense = hooked(real_dense)
    try:
        g32 = port_grads(False)
        t32 = np.concatenate(terms)
        # f64: every tensor in float64 (``Tensor.float`` kept in f64, the
        # dense layers' products in f64)
        torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
        torch.set_default_dtype(torch.float64)
        NM._dense = hooked(lambda p, x, dtype: x.double() @ p['w'].double()
                           + p['b'].double())
        g64 = port_grads(True)
        t64 = np.concatenate(terms)
    finally:
        torch.Tensor.float, NM._dense = real_float, real_dense
        torch.set_default_dtype(torch.float32)
    a32, a64, aj = g32[i][0], g64[i][0], g_jax[i][0]
    mag = np.abs(t64).sum()
    print(f'{name}: the sum of {t64.size} per-point terms')
    print(f'  f64 port       {a64:.9e} (the terms sum to {t64.sum():.9e})')
    print(f'  f32 port       {a32:.9e}  ({abs(a32 - a64) / abs(a64):.2e} '
          f'from f64)')
    print(f'  f32 anerf_tpu  {aj:.9e}  ({abs(aj - a64) / abs(a64):.2e} '
          f'from f64)')
    print(f'  port against anerf_tpu: {abs(a32 - aj) / abs(aj):.2e}')
    print(f'  sum of |terms| {mag:.3e}: |gradient| / sum |terms| '
          f'{abs(a64) / mag:.2e}; the f32 terms\' summed error against f64 '
          f'{np.abs(t32 - t64).sum():.3e} '
          f'(= {np.abs(t32 - t64).sum() / abs(a64):.2e} of the gradient)')


if __name__ == '__main__':
    main()
