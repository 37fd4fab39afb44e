"""Boundaries of the port: ``anerf_torch`` and ``chip_smoke.py`` import
nothing of JAX or anerf_tpu (the machine with the GPU has no JAX), and
the renderer never falls back to the CPU on its own.

The import check walks the sources' syntax trees: this environment
preloads jax at interpreter start, so ``sys.modules`` cannot show it.
"""
import ast
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'anerf_tpu')


def _sources():
    out = [os.path.join(ROOT, 'chip_smoke.py')]
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


def test_renderer_without_device_needs_cuda(monkeypatch):
    from anerf_torch.render.renderer import ImageRenderer, resolve_device
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match='CUDA'):
        ImageRenderer(None, {}, {})
    assert resolve_device('cpu') == torch.device('cpu')


def test_split_mlp_config_raises_off_cpu():
    """Outside ``supported_config`` a non-CPU tensor must not reach the
    split-MLP kernel's plain twin: that kernel is not ported."""
    import dataclasses
    from anerf_torch import testing_utils as T
    from anerf_torch.models.factory import (build_raycast_config,
                                            init_raycaster_params)
    from anerf_torch.models.raycaster import _run_network
    cfg = T.surreal_config(netwidth=64, netdepth=2, multires=2,
                           multires_views=1)
    rc = dataclasses.replace(build_raycast_config(cfg, n_framecodes=2),
                             mlp_backend='fused')
    params = init_raycaster_params(torch.Generator().manual_seed(0), rc, cfg)
    meta = lambda c: torch.zeros((2, 3, c), device='meta')
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        _run_network(rc, params['coarse'], meta(rc.nerf.input_ch),
                     meta(rc.nerf.input_ch_bones),
                     meta(rc.nerf.input_ch_views), None)
