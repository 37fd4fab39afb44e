"""Training and rendering over several processes: ranks split the ray axis.

Port of ``anerf_tpu/parallel/sharding.py`` to ``torch.distributed``.
anerf_tpu runs one process per host over one ``Mesh(('data',))`` and
lets XLA place the gradient psums; here one process drives one device,
as PyTorch has it, and the ranks stand where anerf_tpu's processes
stand.  Every per-ray batch array is split on its leading axis into
equal contiguous blocks, one a rank; the parameters, the pose bank and
the optimizer states are replicated (``replicate_state``), and the
train step all-reduces its gradients explicitly
(``training/trainer.py``).  The collectives are ``all_reduce`` and
``broadcast`` only, which NCCL and gloo both take on CUDA tensors: the
same code runs over several cards under NCCL, on the CPU under gloo,
and in ranks that share one card under gloo.

Launch N ranks with ``python -m torch.distributed.run --nproc_per_node
N -m anerf_torch.run_train ...``; ``init_distributed`` joins the job
that launcher describes.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

LAUNCH = ('launch one rank a device with torchrun (python -m '
          'torch.distributed.run --nproc_per_node N ...)')


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> Tuple[int, int]:
    """Join the job that torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or
    the arguments describe; returns (rank, world size).

    With neither it is a no-op that returns (0, 1); a group already
    formed is returned as it is.  The backend is NCCL where CUDA is
    available and gloo elsewhere, unless one is passed.  Where CUDA is
    available the current device becomes ``LOCAL_RANK % device_count()``,
    so that ``utils.device.resolve_device`` gives each rank its card.
    A job that is described only in part raises; nothing falls back to
    one process."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env_world = os.environ.get('WORLD_SIZE')
    if init_method is None and world_size is None and env_world is None:
        return 0, 1
    world_size = int(world_size if world_size is not None else env_world)
    if rank is None:
        if os.environ.get('RANK') is None:
            raise RuntimeError(f'WORLD_SIZE={world_size} without RANK: '
                               f'{LAUNCH}')
        rank = int(os.environ['RANK'])
    if init_method is None:
        missing = [k for k in ('MASTER_ADDR', 'MASTER_PORT')
                   if not os.environ.get(k)]
        if missing:
            raise RuntimeError(f'WORLD_SIZE={world_size} without '
                               f'{" and ".join(missing)}: {LAUNCH}')
        init_method = 'env://'
    if torch.cuda.is_available():
        local = int(os.environ.get('LOCAL_RANK', rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return rank, world_size


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """The ray group: this process's rank, the number of ranks, and the
    process group their collectives run on (None: one process and no
    collectives)."""
    rank: int = 0
    size: int = 1
    group: Any = None


def make_mesh(n_devices: Optional[int] = None) -> RayMesh:
    """The ray group of the job this process has joined (one rank when
    it has joined none).  One process drives one device, so
    ``n_devices``, when given, must be the world size."""
    if dist.is_initialized():
        mesh = RayMesh(dist.get_rank(), dist.get_world_size(),
                       dist.group.WORLD)
    else:
        mesh = RayMesh()
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f'{n_devices} devices asked for in a world of '
                         f'{mesh.size} rank(s): {LAUNCH}')
    return mesh


def _tensor_leaves(tree: Any) -> List[torch.Tensor]:
    """Every tensor of a nested dict/list state, in a fixed order (dict
    keys sorted), the same on every rank."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def _by_dtype(tensors: List[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def replicate_state(mesh: RayMesh, state: Any) -> Any:
    """Broadcast every tensor of ``state`` from rank 0, in place, one
    flat buffer per dtype: afterwards the ranks' states are bit-equal.
    The host counters (the step, the Adam counts) are the caller's to
    agree on, as they do when every rank starts fresh or resumes from
    the same checkpoint."""
    if mesh.group is None:
        return state
    leaves = _tensor_leaves(state)
    for idx in _by_dtype(leaves).values():
        ts = [leaves[i] for i in idx]
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=0, group=mesh.group)
        with torch.no_grad():
            for t, f in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(f.view_as(t))
    return state


def all_reduce_mean(mesh: RayMesh, tensors: List[torch.Tensor]
                    ) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor: one flat buffer per
    dtype, summed by one ``all_reduce`` and divided by the world size.
    Returns new tensors (views of the buffer) in the order given."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in _by_dtype(tensors).values():
        ts = [tensors[i] for i in idx]
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.size)
        for i, t, f in zip(idx, ts, flat.split([t.numel() for t in ts])):
            out[i] = f.view_as(t)
    return out


def shard_batch(mesh: RayMesh, batch: Dict[str, Any],
                stacked: bool = False) -> Dict[str, Any]:
    """This rank's contiguous 1/P block of every array of a global
    batch (numpy or tensors), on its leading (ray) axis; with
    ``stacked`` on the second axis of a bundle's batches, whose leading
    axis is the step (anerf_tpu's ``P(None, 'data')``)."""
    axis = 1 if stacked else 0
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if v is None:
            out[k] = None
            continue
        n = v.shape[axis]
        if n % mesh.size:
            raise ValueError(f'batch {k!r} has {n} rays, not a multiple of '
                             f'{mesh.size} ranks (pad_rays_to_shards)')
        m = n // mesh.size
        block = slice(mesh.rank * m, (mesh.rank + 1) * m)
        out[k] = v[:, block] if stacked else v[block]
    return out


def shard_train_step(setup, mesh: RayMesh, global_batch: bool = False,
                     stacked: bool = False, steps: int = 1) -> Callable:
    """``train_step(state, batch, generator)`` over the ray group: the
    step of ``training.trainer.make_train_step`` with its gradients,
    statistics and kp-loss trackers all-reduced over ``mesh``.

    By default ``batch`` is the global batch, the same on every rank,
    and the step keeps this rank's block (``shard_batch``); with
    ``global_batch=True`` the batch is already this rank's block of the
    global one (the per-rank pixel draw of ``data.pipeline.Prefetcher``,
    anerf_tpu's ``make_global_batch`` input path).  The state must be
    the same on every rank (``replicate_state``); it stays so.  Each
    rank's ``generator`` should be seeded differently
    (``rank_generator``), or the ranks draw the same jitter rows.

    ``stacked=True`` bundles ``steps`` steps into one call
    (``training.trainer.make_multi_train_step`` over the ranks): the
    batch carries a leading ``steps`` axis and the rays are its second
    axis, of which each rank keeps its block of every step
    (``shard_batch(..., stacked=True)``); with ``global_batch=True`` the
    batches are this rank's blocks, stacked (its own draws).  anerf_tpu
    refuses a global batch here only because it drives every device of
    a host from one process; a host of several cards here is several
    ranks, each stacking its own draws.  Bundles are one host's, as in
    anerf_tpu (``require_one_host``)."""
    from ..training.trainer import make_multi_train_step, make_train_step
    setup = dataclasses.replace(setup, mesh=mesh)
    step = (make_multi_train_step(setup, steps) if stacked
            else make_train_step(setup))

    def sharded(state, batch, generator=None):
        if not global_batch:
            batch = shard_batch(mesh, batch, stacked=stacked)
        return step(state, batch, generator)

    return sharded


def require_one_host(mesh: Optional[RayMesh], steps: int) -> None:
    """Bundles of ``steps`` > 1 steps are one host's, as anerf_tpu
    asserts a single process for them: raises unless ``mesh`` is one
    rank or every rank runs on this host (torchrun's
    ``LOCAL_WORLD_SIZE`` equal to the world size).  A job joined
    through ``init_distributed``'s arguments, without torchrun's
    environment, counts as one host: its ranks are the processes one
    launcher spawned."""
    if steps <= 1 or mesh is None or mesh.size == 1:
        return
    local = int(os.environ.get('LOCAL_WORLD_SIZE', mesh.size))
    if local != mesh.size:
        raise NotImplementedError(
            f'steps_per_dispatch {steps} over {mesh.size} ranks on several '
            f'hosts (LOCAL_WORLD_SIZE {local}): bundles run on one host '
            'only, as anerf_tpu asserts one process for them; start one '
            "host's ranks, or --steps_per_dispatch 1")


def rank_generator(mesh: RayMesh, seed: int, device) -> torch.Generator:
    """This rank's generator: ``seed`` on rank 0 (a one-rank run draws
    as before), and on rank r ``seed + r * 0x9E3779B9`` modulo 2^32 (the
    CPU generator keeps a seed's low 32 bits only; an odd step keeps
    the ranks' seeds apart)."""
    return torch.Generator(device=device).manual_seed(
        (seed + mesh.rank * 0x9E3779B9) % 2 ** 32)


def pad_rays_to_shards(n: int, n_shards: int, multiple: int = 1) -> int:
    """Padded ray count divisible by the mesh size (and tile multiple)."""
    q = n_shards * multiple
    return ((n + q - 1) // q) * q
