"""Parameter trees between anerf_tpu and the port, through numpy.

Both packages keep the same nested layout (``{'coarse': {'pts_linears':
[{'w', 'b'}, ...], ...}, 'fine': ..., 'cutoff_dist': (J,)}``), so a
tree from ``anerf_tpu.models.factory.init_raycaster_params`` or from a
checkpoint converts leaf by leaf.  Lists stay lists, None stays None.
A whole train state (parameters, both optimizers' states, the pose bank
and its accumulator, the step) converts the same way.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tree_map(fn, tree: Any) -> Any:
    """``fn`` on every leaf of nested dicts/lists/tuples; None stays."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def params_from_numpy(tree: Any, device='cpu') -> Any:
    """Array-like leaves (numpy, or anything ``np.asarray`` takes) ->
    float32 tensors on ``device``."""
    return tree_map(lambda a: torch.tensor(
        np.asarray(a, dtype=np.float32), device=device), tree)


def params_to_numpy(params: Any) -> Any:
    """Tensor leaves -> float32 numpy arrays (copies: a CPU tensor's
    numpy view would follow later in-place updates)."""
    return tree_map(lambda t: t.detach().float().cpu().numpy().copy(),
                    params)


def params_to(params: Any, device) -> Any:
    """The same tree with every tensor leaf moved to ``device``."""
    return tree_map(lambda t: t.to(device), params)


def _adam_from_chain(opt_state: Any, device) -> Any:
    """optax's Adam chain state -> the port's {'count', 'mu', 'nu'}.
    The chain is a tuple whose Adam part carries ``count``, ``mu`` and
    ``nu`` fields (a NamedTuple); it is read by field name, so optax
    itself is never imported."""
    if opt_state is None:
        return None
    parts = opt_state if isinstance(opt_state, (list, tuple)) and not \
        hasattr(opt_state, 'mu') else [opt_state]
    adam = next(p for p in parts if hasattr(p, 'mu') and hasattr(p, 'nu'))
    return {'count': int(np.asarray(adam.count)),
            'mu': params_from_numpy(adam.mu, device),
            'nu': params_from_numpy(adam.nu, device)}


def train_state_from_jax(state: Any, device='cpu') -> Any:
    """A train state of ``anerf_tpu.training.trainer`` (taken at any
    step) -> the port's, leaf by leaf through numpy: params, both Adam
    states (count, mu, nu), the pose bank, its accumulator and the
    step.  The port's state then continues the same trajectory."""
    return {'params': params_from_numpy(state['params'], device),
            'opt_state': _adam_from_chain(state['opt_state'], device),
            'pose_params': params_from_numpy(state.get('pose_params'),
                                             device),
            'pose_opt_state': _adam_from_chain(state.get('pose_opt_state'),
                                               device),
            'pose_accum': params_from_numpy(state.get('pose_accum'), device),
            'step': int(np.asarray(state['step']))}
