"""Boundaries of the port: ``anerf_torch``, ``chip_smoke.py`` and the
multi-process tests' rank module import nothing of JAX or anerf_tpu
(the machine with the GPU has no JAX) and import imageio, cv2, h5py,
msgpack, smplx, deepdish and transformers (which that machine lacks
too) only inside functions; the offline modules define every public
name of anerf_tpu's; and the renderer never falls back to the CPU on
its own.

The import check walks the sources' syntax trees: this environment
preloads jax at interpreter start, so ``sys.modules`` cannot show it.
"""
import ast
import dataclasses
import os

import pytest
import torch

from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'anerf_tpu')


def _sources():
    # the ranks of the multi-process tests run this module alone
    out = [os.path.join(ROOT, 'chip_smoke.py'),
           os.path.join(ROOT, 'tests', '_torch_parallel_worker.py')]
    for d, _, files in os.walk(os.path.join(ROOT, 'anerf_torch')):
        out += [os.path.join(d, f) for f in files if f.endswith('.py')]
    return sorted(out)


def _imported(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''


@pytest.mark.parametrize('path', _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported(path)
           if m.split('.')[0] in FORBIDDEN]
    assert not bad, f'{path} imports {bad}'


# absent from the card's machine: imported inside the functions that
# need them, never when a module of the port is imported
FUNCTION_ONLY = ('imageio', 'cv2', 'h5py', 'msgpack', 'smplx', 'deepdish',
                 'transformers')


def _module_level_imports(path):
    """Modules imported by statements that run at import time: the
    module's body, through ``if``/``try``/``with`` blocks but not into
    function or class bodies."""
    body = list(ast.parse(open(path).read(), filename=path).body)
    while body:
        node = body.pop()
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''
        elif not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
            for field in ('body', 'orelse', 'finalbody', 'handlers'):
                body += getattr(node, field, [])


@pytest.mark.parametrize('path', _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_card_absent_packages_inside_functions(path):
    bad = [m for m in _module_level_imports(path)
           if m.split('.')[0] in FUNCTION_ONLY]
    assert not bad, f'{path} imports {bad} at module level'


def _public_names(path):
    """The top-level public names a module defines: its functions,
    classes and assigned constants."""
    names = set()
    for node in ast.parse(open(path).read(), filename=path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in (node.targets if isinstance(node, ast.Assign)
                      else [node.target]):
                names.update(n.id for n in ast.walk(t)
                             if isinstance(n, ast.Name))
    return {n for n in names if not n.startswith('_')}


@pytest.mark.parametrize('module', ['data/preprocess.py', 'data/spin.py',
                                    'data/mask_extract.py',
                                    'eval/metrics.py'])
def test_offline_modules_define_anerf_tpu_names(module):
    """Every public top-level name of anerf_tpu's offline modules has
    its counterpart in the port's module of the same path."""
    ref = _public_names(os.path.join(ROOT, 'anerf_tpu', module))
    got = _public_names(os.path.join(ROOT, 'anerf_torch', module))
    assert ref and not ref - got, sorted(ref - got)


def test_renderer_without_device_needs_cuda(monkeypatch):
    from anerf_torch.render.renderer import ImageRenderer, resolve_device
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match='CUDA'):
        ImageRenderer(None, {}, {})
    assert resolve_device('cpu') == torch.device('cpu')


def test_split_mlp_wrappers_refuse_other_devices():
    """Off the CPU the split-MLP wrappers (K5, K6) launch their kernel
    or raise: a tensor on another device never reaches the plain twin."""
    from anerf_torch import testing_utils as T
    from anerf_torch.models.factory import (build_raycast_config,
                                            init_raycaster_params)
    from anerf_torch.ops import fused_mlp as FM
    cfg = T.surreal_config()
    rc = build_raycast_config(cfg, n_framecodes=2, n_subjects=2)
    params = init_raycaster_params(torch.Generator().manual_seed(0), rc, cfg)
    st = FM.MLPStatic(depth=8, width=256, dparts=(360, 72),
                      vparts=(649, 16), half=128, skips=(4,))
    meta = lambda c: torch.zeros((5, c), dtype=torch.bfloat16, device='meta')
    xs, xvs = [meta(360), meta(72)], [meta(649), meta(16)]
    flat = [w.to('meta') for w in FM.flatten_params(params['coarse'], st)]
    with pytest.raises(ValueError, match='device'):
        FM.mlp_fwd(st, xs, xvs, flat)
    with pytest.raises(ValueError, match='device'):
        FM.mlp_bwd(st, xs, xvs, flat,
                   torch.zeros((5, 4), device='meta'))


def test_multisubject_train_setup_builds_on_cpu():
    """A two-subject TrainSetup on the CPU: the rest poses and each
    frame's subject move to the device, and FK takes each frame's own
    rest pose."""
    from anerf_torch import testing_utils as T
    from anerf_torch.models.factory import build_raycast_config
    from anerf_torch.skeleton import SMPLSkeleton
    from anerf_torch.training.trainer import TrainSetup
    cfg = T.surreal_config(N_rand=4)
    rest = T.synthetic_pose(5, n_subjects=2)[0]
    subj = T.subject_of_frame(5, 2)
    setup = TrainSetup(cfg=cfg, rc=build_raycast_config(cfg, n_framecodes=5,
                                                        n_subjects=2),
                       skel=SMPLSkeleton, rest_pose=rest,
                       rest_pose_idxs=subj, device='cpu')
    assert setup.rest_pose.shape == (2, 24, 3)
    assert setup.rest_pose_idxs.dtype == torch.long
    assert setup.rest_pose_idxs.device.type == 'cpu'
    rows = setup.frame_rest_pose(torch.arange(5))
    assert torch.equal(rows, torch.as_tensor(rest)[subj])
    assert not torch.equal(rows[0], rows[-1])
    # a copy with another backend (as the fused-vs-plain checks make it)
    # takes the tensors it already holds
    other = dataclasses.replace(setup, rc=dataclasses.replace(
        setup.rc, mlp_backend='plain'))
    assert torch.equal(other.rest_pose_idxs, setup.rest_pose_idxs)


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def test_trainer_without_device_needs_cuda(monkeypatch):
    """The train step, like the renderer, runs on the GPU unless the
    caller asks for the CPU; with no device and no GPU it raises."""
    from anerf_torch import testing_utils as T
    from anerf_torch.models.factory import build_raycast_config
    from anerf_torch.skeleton import SMPLSkeleton
    from anerf_torch.training.trainer import TrainSetup
    from anerf_torch.utils.device import resolve_device
    _no_cuda(monkeypatch)
    cfg = T.surreal_config(N_rand=4)
    rc = build_raycast_config(cfg, n_framecodes=2)
    rest = T.synthetic_pose(2)[0]
    with pytest.raises(RuntimeError, match='CUDA'):
        TrainSetup(cfg=cfg, rc=rc, skel=SMPLSkeleton, rest_pose=rest)
    with pytest.raises(RuntimeError, match='CUDA'):
        T.build_flagship(4, 2)
    setup = TrainSetup(cfg=cfg, rc=rc, skel=SMPLSkeleton, rest_pose=rest,
                       device='cpu')
    assert setup.device == resolve_device('cpu')
    assert setup.rest_pose.device.type == 'cpu'


def _tiny_config(**over):
    from anerf_torch.utils.config import load_config
    return load_config(os.path.join(ROOT, 'configs', 'synthetic_tiny.txt'),
                       **over)


def test_train_entry_without_device_needs_cuda(monkeypatch):
    """``run_train.train`` runs on the GPU unless asked for the CPU."""
    from anerf_torch.run_train import train
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match='CUDA'):
        train(_tiny_config())


def _kernel_operands(S, R=2, device='cpu'):
    from anerf_torch import testing_utils as T
    from anerf_torch.models.factory import (build_raycast_config,
                                            init_raycaster_params)
    from anerf_torch.ops import fused_encmlp as FE
    cfg = T.surreal_config(N_rand=R)
    rc = build_raycast_config(cfg, n_framecodes=2)
    params = init_raycaster_params(torch.Generator().manual_seed(0), rc, cfg)
    g = torch.Generator().manual_seed(1)
    pts = torch.randn((R, S, 72), generator=g) * 0.3
    cam = torch.zeros((R,), dtype=torch.long)
    st, est, p, enc, cut, tau = FE._build_call(
        rc, pts, torch.randn((R, 72), generator=g), params['cutoff_dist'],
        20., cam, None)
    codes = [FE._codes(params[k], cam) for k in ('coarse', 'fine')]
    flats = [FE.flatten_params_cm(params[k], st, 24, est.view_nb)
             for k in ('coarse', 'fine')]
    to = lambda t: t.detach().to(device).requires_grad_(t.is_floating_point())
    return (st, est, to(p), to(enc), [to(c) for c in codes], cut.to(device),
            tau.to(device), [[to(w) for w in f] for f in flats])


def test_fused_outputs_carry_the_backward_kernels():
    """On CPU tensors that require grad, K1's and K2's outputs hang off
    the autograd Functions whose backward is K3 / K4 (their twins here):
    the gradient reaches the weights on every device."""
    from anerf_torch.ops import fused_encmlp as FE
    st, est, p, enc, codes, cut, tau, flats = _kernel_operands(16)
    one = FE.encmlp_fwd(st, est, p, enc, codes[1], cut, tau, flats[1])
    assert type(one.grad_fn).__name__ == '_EncMLPBackward'
    two = FE.encmlp_dual_fwd(st, est, p, enc, codes[0], codes[1], cut, tau,
                             *flats)
    assert all(type(o.grad_fn).__name__ == '_EncMLPDualBackward'
               for o in two)
    FE.reset_launch_counts()
    grads = torch.autograd.grad(two[0].sum() + two[1].sum() + one.sum(),
                                [p, codes[0]] + flats[0] + flats[1])
    assert all(g is not None and torch.isfinite(g.float()).all()
               for g in grads)
    assert all(v == 0 for v in FE.launch_counts().values())


def test_fused_wrappers_refuse_other_devices():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    another device never reaches the plain twin."""
    from anerf_torch.ops import fused_encmlp as FE
    st, est, p, enc, codes, cut, tau, flats = _kernel_operands(16,
                                                               device='meta')
    with pytest.raises(ValueError, match='device'):
        FE.encmlp_fwd(st, est, p, enc, codes[1], cut, tau, flats[1])
    with pytest.raises(ValueError, match='device'):
        FE.encmlp_dual_bwd(st, est, p, enc, codes[0], codes[1], cut, tau,
                           *flats, torch.zeros_like(p[:4].T),
                           torch.zeros_like(p[:4].T))


def test_cached_device_tensors_survive_inference_mode():
    """The per-device constants the encoders cache (PE bands, the
    component-major permutation) are built outside inference mode: a
    renderer's first call, under ``torch.inference_mode``, must leave
    tensors that a train step's autograd may save."""
    from anerf_torch.ops import embedding as E
    from anerf_torch.ops import fused_encmlp as FE
    E._band_tensor.cache_clear()
    FE._perm_tensors.cache_clear()
    cfg = E.EmbedConfig(input_dims=24, num_freqs=7, cutoff=True,
                        cutoff_inputs=True)
    emb = lambda d: E.embed(d, cfg, dists=d, cutoff_dist=torch.ones(24),
                            tau=torch.tensor(20.))[0]
    with torch.inference_mode():
        emb(torch.rand(3, 24))
        FE.view_pe_rows(torch.randn(2, 72), [1., 2.], 24)
    d = torch.rand(3, 24, requires_grad=True)
    x = torch.randn(2, 72, requires_grad=True)
    (emb(d).sum() + FE.view_pe_rows(x, [1., 2.], 24).sum()).backward()
    assert torch.isfinite(d.grad).all() and torch.isfinite(x.grad).all()
