"""Checkpoints: ``torch.save`` train states, and imports of anerf_tpu's
msgpack checkpoints and of the reference's ``.tar``.

Port of ``anerf_tpu/training/checkpoint.py`` (the reference's resume
contract, SURVEY §5: the logdir is the source of truth and a restart
loads its newest checkpoint, core/raycasters.py:124-143).  A file
``ckpt_{step:08d}.pt`` holds the train state as the trainer keeps it:
parameters, both Adam states with their counts as host ints, the pose
bank, its accumulator, the FlipFlop trackers and snapshot when present,
the step as a host int, and the regularization anchors.  Tensors are
saved from the CPU, so a file loads on any machine.
``pose_ckpt_{step:08d}.pt`` holds the step, the pose bank and the
anchors (reference trainer.py:508-516).

``import_jax_checkpoint`` reads anerf_tpu's ``.msgpack`` files without
flax (msgpack is imported inside it and flax's ndarray extension is
decoded here); ``load_torch_checkpoint`` reads the reference's ``.tar``
(key mangling per raycasters.py:752-788).
"""
from __future__ import annotations

import glob
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..interop import tree_map, train_state_from_jax_checkpoint


def _to_cpu(tree: Any) -> Any:
    return tree_map(lambda x: x.detach().cpu() if torch.is_tensor(x) else x,
                    tree)


def save_checkpoint(logdir: str, state: Dict[str, Any], step: int,
                    anchors: Optional[Dict] = None, keep: int = 3) -> str:
    """Write ``ckpt_{step:08d}.pt`` and keep the newest ``keep``."""
    os.makedirs(logdir, exist_ok=True)
    payload = _to_cpu(dict(state))
    if anchors is not None:
        payload['anchors'] = _to_cpu(anchors)
    path = os.path.join(logdir, f'ckpt_{step:08d}.pt')
    torch.save(payload, path)
    _prune_old(logdir, keep)
    return path


def save_pose_checkpoint(logdir: str, state: Dict[str, Any], step: int,
                         anchors: Optional[Dict] = None) -> str:
    """Pose-only periodic checkpoint (reference trainer.py:508-516)."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f'pose_ckpt_{step:08d}.pt')
    torch.save(_to_cpu({'step': int(step),
                        'pose_params': state['pose_params'],
                        'anchors': anchors}), path)
    return path


def _prune_old(logdir: str, keep: int):
    for p in sorted(glob.glob(os.path.join(logdir, 'ckpt_*.pt')))[:-keep]:
        os.remove(p)


def latest_checkpoint(logdir: str) -> Optional[str]:
    ckpts = sorted(glob.glob(os.path.join(logdir, 'ckpt_*.pt')))
    return ckpts[-1] if ckpts else None


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint's payload on the CPU: the port's ``.pt``, or an
    anerf_tpu ``.msgpack`` imported into the port's layout."""
    if path.endswith('.msgpack'):
        return import_jax_checkpoint(path)
    return torch.load(path, map_location='cpu', weights_only=False)


def restore_like(like: Any, value: Any) -> Any:
    """``value`` in the layout of ``like``: tensors onto ``like``'s
    device and dtype, host numbers as they are."""
    if isinstance(like, dict):
        if value is None or set(value) != set(like):
            raise ValueError(f'checkpoint keys {sorted(value or [])} do not '
                             f'match the state\'s {sorted(like)}')
        return {k: restore_like(like[k], value[k]) for k in like}
    if isinstance(like, (list, tuple)):
        if len(value) != len(like):
            raise ValueError('checkpoint list length does not match')
        return type(like)(restore_like(a, b) for a, b in zip(like, value))
    if like is None:
        return None
    if torch.is_tensor(like):
        v = torch.as_tensor(value)
        if v.shape != like.shape:
            raise ValueError(f'checkpoint shape {tuple(v.shape)} does not '
                             f'match the state\'s {tuple(like.shape)}')
        return v.to(device=like.device, dtype=like.dtype).clone()
    return type(like)(value)


def restore_train_state(state: Dict[str, Any], ckpt: Dict[str, Any],
                        finetune: bool = False,
                        no_poseopt_reload: bool = False
                        ) -> Tuple[Dict[str, Any], int]:
    """A train state from a checkpoint payload, on the state's device.

    ``finetune`` loads the weights but keeps the state's step and
    optimizer states (reference raycasters.py:140-142);
    ``no_poseopt_reload`` keeps the state's (data-derived) pose bank
    (reference pose_opt.py:51)."""
    ckpt = dict(ckpt)
    ckpt.pop('anchors', None)
    restored = restore_like(state, ckpt)
    if finetune:
        restored['step'] = state['step']
        restored['opt_state'] = state['opt_state']
        if state.get('pose_opt_state') is not None:
            restored['pose_opt_state'] = state['pose_opt_state']
            restored['pose_accum'] = state['pose_accum']
    if no_poseopt_reload:
        for k in ('pose_params', 'pose_opt_state', 'pose_accum'):
            restored[k] = state.get(k)
    step = int(ckpt['step']) if not finetune else 0
    return restored, step


def load_pose_payload(path: str) -> Dict[str, Any]:
    """Pose bank (+ anchors) from any checkpoint file: the port's
    ``.pt`` (full or pose-only), anerf_tpu's ``.msgpack`` or a reference
    ``.tar`` (reference --init_poseopt, pose_opt.py:51-60)."""
    loaded = load_torch_checkpoint(path) if path.endswith('.tar') \
        else load_checkpoint(path)
    out: Dict[str, Any] = {}
    if loaded.get('pose_params') is not None:
        out['pose_params'] = loaded['pose_params']
    if loaded.get('anchors') is not None:
        out['anchors'] = loaded['anchors']
    if 'pose_params' not in out:
        raise ValueError(f'{path} holds no pose bank '
                         '(expected pose_params / poseopt_layer_state_dict)')
    return out


# --- anerf_tpu msgpack import --------------------------------------------

def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b'bfloat16':
        raise ValueError('bfloat16 arrays are not supported by the import')
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()),
                         count=-1, offset=0).reshape(shape, order='C')


def _ext_unpack(code: int, data: bytes):
    """flax's msgpack extensions: 1 ndarray, 2 complex, 3 numpy scalar
    (flax/serialization.py ``_MsgpackExtType``)."""
    import msgpack
    if code == 1:
        return _ndarray_from_bytes(data)
    if code == 2:
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    if code == 3:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree: Any) -> Any:
    """flax splits arrays over 2**30 bytes into chunks; join them."""
    if isinstance(tree, dict):
        if tree.get('__msgpack_chunked_array__'):
            shape = tuple(tree['shape'][str(i)]
                          for i in range(len(tree['shape'])))
            chunks = [tree['chunks'][str(i)]
                      for i in range(len(tree['chunks']))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_jax_msgpack(path: str) -> Dict[str, Any]:
    """A flax msgpack file as the nested dicts of numpy arrays it
    stores (what ``flax.serialization.msgpack_restore`` returns)."""
    import msgpack
    with open(path, 'rb') as f:
        return _unchunk(msgpack.unpackb(f.read(), ext_hook=_ext_unpack,
                                        raw=False))


def import_jax_checkpoint(path: str, device='cpu') -> Dict[str, Any]:
    """An anerf_tpu checkpoint (full ``ckpt_*.msgpack`` or pose-only
    ``pose_ckpt_*.msgpack``) in the port's layout, through
    ``interop.train_state_from_jax_checkpoint``; a pose-only file gives
    its step, pose bank and anchors."""
    raw = read_jax_msgpack(path)
    if 'params' not in raw:
        from ..interop import lists_from_state_dict, params_from_numpy
        raw = lists_from_state_dict(raw)
        return {'step': int(np.asarray(raw['step'])),
                'pose_params': params_from_numpy(raw.get('pose_params'),
                                                 device),
                'anchors': params_from_numpy(raw.get('anchors'), device)}
    return train_state_from_jax_checkpoint(raw, device)


# --- reference torch .tar import -----------------------------------------

def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(arr) -> np.ndarray:
    """torch Linear weight (out, in) -> ours (in, out)."""
    return np.ascontiguousarray(_np(arr).T)


def _convert_nerf_sd(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Torch NeRF state dict -> our param tree
    (reference core/networks/nerf.py layer naming)."""
    n_pts = len({k.split('.')[1] for k in sd if k.startswith('pts_linears.')})
    params: Dict[str, Any] = {
        'pts_linears': [
            {'w': _t(sd[f'pts_linears.{i}.weight']),
             'b': _np(sd[f'pts_linears.{i}.bias'])}
            for i in range(n_pts)],
    }
    for ours, theirs in [('alpha_linear', 'alpha_linear'),
                         ('feature_linear', 'feature_linear'),
                         ('views_linear', 'views_linears.0'),
                         ('rgb_linear', 'rgb_linear'),
                         ('output_linear', 'output_linear')]:
        if f'{theirs}.weight' in sd:
            params[ours] = {'w': _t(sd[f'{theirs}.weight']),
                            'b': _np(sd[f'{theirs}.bias'])}
    if 'framecodes.codes.weight' in sd:
        params['framecodes'] = _np(sd['framecodes.codes.weight'])
    return params


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Read a reference ``.tar`` checkpoint into our tree layout (numpy
    leaves): params {coarse, fine, cutoff_dist}, global_step, and
    pose_params / rest_pose / anchors when present."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    params: Dict[str, Any] = {
        'coarse': _convert_nerf_sd(ckpt['network_fn_state_dict']),
        'fine': (_convert_nerf_sd(ckpt['network_fine_state_dict'])
                 if 'network_fine_state_dict' in ckpt else None),
    }
    if 'embed_state_dict' in ckpt and \
            'cutoff_dist' in ckpt['embed_state_dict']:
        params['cutoff_dist'] = _np(ckpt['embed_state_dict']['cutoff_dist'])

    out: Dict[str, Any] = {
        'params': params,
        'global_step': int(ckpt.get('global_step', 0)),
    }
    popt = ckpt.get('poseopt_layer_state_dict')
    if popt is not None:
        pose_params = {'pelvis': _np(popt['pelvis']),
                       'bones': _np(popt['bones'])}
        if 'root_bones' in popt:
            pose_params['root_bones'] = _np(popt['root_bones'])
        out['pose_params'] = pose_params
        out['rest_pose'] = _np(popt['rest_pose']) \
            if 'rest_pose' in popt else None
    anchors = ckpt.get('poseopt_anchors')
    if anchors is not None and isinstance(anchors, dict):
        out['anchors'] = {k: _np(v) for k, v in anchors.items()
                          if v is not None and not isinstance(v, dict)}
    return out


def load_refined_pose_data(path: str, legacy: bool = False,
                           ext_scale: float = 0.001):
    """(kp3d, bones, skts, cyls, rest_pose, pelvis) from a refined-pose
    checkpoint: the port's, anerf_tpu's or the reference's torch
    ``.tar`` (reference pose_opt.py:523-559, including the legacy
    coordinate flip)."""
    from ..ops.cylinder import get_kp_bounding_cylinder
    from ..ops.fk import get_smpl_l2ws_np
    from scipy.spatial.transform import Rotation

    if path.endswith('.tar'):
        loaded = load_torch_checkpoint(path)
        pose_params = loaded['pose_params']
        rest_pose = loaded.get('rest_pose')
    else:
        ckpt = load_checkpoint(path)
        pose_params = ckpt['pose_params']
        rest_pose = ckpt.get('rest_pose')
    if rest_pose is None:
        from ..skeleton import SMPL_REST_POSE
        rest_pose = SMPL_REST_POSE * ext_scale * 2.2
    rest_pose = _np(rest_pose)

    pelvis = _np(pose_params['pelvis']).astype(np.float32)
    bones = _np(pose_params['bones']).astype(np.float32)
    if bones.shape[-1] == 6:
        from ..ops.rotations import rot6d_to_rotmat
        rots = rot6d_to_rotmat(torch.as_tensor(bones)).numpy()
        bones = Rotation.from_matrix(rots.reshape(-1, 3, 3)).as_rotvec() \
            .reshape(bones.shape[:-1] + (3,)).astype(np.float32)

    if legacy:
        pelvis = pelvis.copy()
        pelvis[..., 1:] *= -1
        rest_pose = np.concatenate([rest_pose[..., :1], -rest_pose[..., 2:3],
                                    rest_pose[..., 1:2]], axis=-1)
        bones = np.concatenate([bones[..., :1], -bones[..., 2:3],
                                bones[..., 1:2]], axis=-1)
        root_rot = Rotation.from_rotvec(
            bones[..., 0, :].reshape(-1, 3)).as_matrix()
        flip = np.array([[1., 0., 0.], [0., 0., -1.], [0., 1., 0.]],
                        np.float32)
        root_rot = Rotation.from_matrix(flip[None] @ root_rot).as_rotvec() \
            .reshape(-1, 3)
        bones = bones.copy()
        bones[..., 0, :] = root_rot

    rest_pose = np.asarray(rest_pose, np.float32).reshape(-1, 3)
    l2ws = np.stack([get_smpl_l2ws_np(b, rest_pose=rest_pose)
                     for b in bones])
    l2ws[..., :3, -1] += pelvis[:, None]
    kp3d = l2ws[..., :3, -1].astype(np.float32)
    skts = np.linalg.inv(l2ws).astype(np.float32)
    cyls = get_kp_bounding_cylinder(kp3d, ext_scale=ext_scale,
                                    extend_mm=250, head='-y').astype(
        np.float32)
    return kp3d, bones, skts, cyls, rest_pose, pelvis
