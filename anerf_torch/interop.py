"""Parameter trees between anerf_tpu and the port, through numpy.

Both packages keep the same nested layout (``{'coarse': {'pts_linears':
[{'w', 'b'}, ...], ...}, 'fine': ..., 'cutoff_dist': (J,)}``), so a
tree from ``anerf_tpu.models.factory.init_raycaster_params`` or from a
checkpoint converts leaf by leaf.  Lists stay lists, None stays None.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def params_from_numpy(tree: Any, device='cpu') -> Any:
    """Array-like leaves (numpy, or anything ``np.asarray`` takes) ->
    float32 tensors on ``device``."""
    return _map(tree, lambda a: torch.tensor(
        np.asarray(a, dtype=np.float32), device=device))


def params_to_numpy(params: Any) -> Any:
    """Tensor leaves -> float32 numpy arrays."""
    return _map(params, lambda t: t.detach().float().cpu().numpy())


def params_to(params: Any, device) -> Any:
    """The same tree with every tensor leaf moved to ``device``."""
    return _map(params, lambda t: t.to(device))
