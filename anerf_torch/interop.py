"""Parameter trees between anerf_tpu and the port, through numpy.

Both packages keep the same nested layout (``{'coarse': {'pts_linears':
[{'w', 'b'}, ...], ...}, 'fine': ..., 'cutoff_dist': (J,)}``), so a
tree from ``anerf_tpu.models.factory.init_raycaster_params`` or from a
checkpoint converts leaf by leaf.  Lists stay lists, None stays None.
A whole train state (parameters, both optimizers' states, the pose bank
and its accumulator, the step, and the FlipFlop trackers and pose-bank
snapshot when present) converts the same way, from a live JAX state or
from one that a msgpack checkpoint restored as plain dicts.
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


def _field(x: Any, name: str) -> Any:
    """A NamedTuple's field, or the same key of the dict a checkpoint
    restored it as."""
    return x.get(name) if isinstance(x, dict) else getattr(x, name, None)


def _adam_from_chain(opt_state: Any, device) -> Any:
    """optax's Adam chain state -> the port's {'count', 'mu', 'nu'}.
    The chain is a tuple whose Adam part carries ``count``, ``mu`` and
    ``nu`` fields (a NamedTuple, or a dict once a checkpoint restored
    it); it is read by field name, so optax itself is never imported."""
    if opt_state is None:
        return None
    is_adam = lambda p: (_field(p, 'mu') is not None
                         and _field(p, 'nu') is not None)
    parts = [opt_state] if is_adam(opt_state) else list(opt_state)
    adam = next(p for p in parts if is_adam(p))
    return {'count': int(np.asarray(_field(adam, 'count'))),
            'mu': params_from_numpy(_field(adam, 'mu'), device),
            'nu': params_from_numpy(_field(adam, 'nu'), device)}


def train_state_from_jax(state: Any, device='cpu') -> Any:
    """A train state of ``anerf_tpu.training.trainer`` (taken at any
    step) -> the port's, leaf by leaf through numpy: params, both Adam
    states (count, mu, nu), the pose bank, its accumulator, the step,
    and the FlipFlop trackers and pose-bank snapshot when the state has
    them.  The port's state then continues the same trajectory."""
    out = {'params': params_from_numpy(state['params'], device),
           'opt_state': _adam_from_chain(state['opt_state'], device),
           'pose_params': params_from_numpy(state.get('pose_params'),
                                            device),
           'pose_opt_state': _adam_from_chain(state.get('pose_opt_state'),
                                              device),
           'pose_accum': params_from_numpy(state.get('pose_accum'), device),
           'step': int(np.asarray(state['step']))}
    for k in ('kp_tracker', 'pose_snapshot'):
        if state.get(k) is not None:
            out[k] = params_from_numpy(state[k], device)
    return out


def lists_from_state_dict(tree: Any) -> Any:
    """A tree as flax's ``to_state_dict`` stores it -> the nested lists
    it came from: a dict whose keys are exactly '0'..'n-1' (how lists,
    tuples and optax's chain tuples are written) becomes a list; an
    empty dict (an optax ``EmptyState``) becomes None."""
    if isinstance(tree, dict):
        if not tree:
            return None
        keys = sorted(tree, key=str)
        if all(isinstance(k, str) and k.isdigit() for k in keys) and \
                sorted(int(k) for k in keys) == list(range(len(keys))):
            return [lists_from_state_dict(tree[str(i)])
                    for i in range(len(keys))]
        return {k: lists_from_state_dict(v) for k, v in tree.items()}
    return tree


def train_state_from_jax_checkpoint(ckpt: Any, device='cpu') -> Any:
    """The dict a JAX msgpack checkpoint restores to (plain dicts of
    numpy arrays, lists and optax tuples as '0', '1', ... keys) -> the
    port's train state, as ``train_state_from_jax`` lays it out; the
    checkpoint's anchors, when stored, come along as float32 tensors
    under 'anchors'."""
    tree = lists_from_state_dict(ckpt)
    state = train_state_from_jax(tree, device)
    if tree.get('anchors') is not None:
        state['anchors'] = params_from_numpy(tree['anchors'], device)
    return state
