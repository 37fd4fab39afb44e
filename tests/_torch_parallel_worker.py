"""Rank processes of ``tests/test_torch_parallel*.py``.

``spawn(task, kwargs, tmp)`` starts two ranks with
``torch.multiprocessing`` (the spawn start method); they meet through a
``file://`` store under ``tmp`` (no TCP port: several pytest workers
share the machine), join a gloo group through
``parallel.sharding.init_distributed``, run ``TASKS[task]`` (``jobs``
runs several in one spawn: starting ranks costs seconds) and save its
result for the test to read.  Every spawn has its own time limit, so a
hung rank fails its test.  This module imports ``torch`` and
``anerf_torch`` only: a rank never imports ``jax`` (each result records
whether it did).
"""
import builtins
import os
import sys
import time

import numpy as np
import torch

TIMEOUT = 120       # seconds a spawn may take, its ranks' start included


def to_numpy(tree):
    """Tensors -> numpy copies through a nested dict/list (other leaves
    kept): a copy, since the train step updates its state in place."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy().copy() if torch.is_tensor(tree) \
        else tree


def to_torch(tree):
    """numpy -> tensors (integer arrays int64) through a nested
    dict/list; copies, so no two ranks share memory."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    if isinstance(tree, np.ndarray):
        t = torch.tensor(tree)
        return t.long() if not t.is_floating_point() else t
    return tree


def same_bits(a, b, path=''):
    """Two nested dict/list trees of numpy arrays and host values are
    equal, every array bit for bit."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            same_bits(a[k], b[k], f'{path}/{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same_bits(x, y, f'{path}/{i}')
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    else:
        assert a == b, path


def _setup(spec, mesh=None):
    """The port's TrainSetup of a picklable spec: Config kwargs, the rest
    pose(s), the anchors' kps/bones, each frame's subject, near/far."""
    import dataclasses
    from anerf_torch.models.factory import build_raycast_config
    from anerf_torch.skeleton import SMPLSkeleton
    from anerf_torch.training import pose_opt as P
    from anerf_torch.training.trainer import TrainSetup
    from anerf_torch.utils.config import Config
    cfg = Config(**spec['cfg'])
    rc = build_raycast_config(cfg, n_framecodes=spec['n_frames'],
                              n_subjects=spec.get('n_subjects', 1))
    if 'viewfac' in spec:
        rc = dataclasses.replace(rc, viewfac=spec['viewfac'])
    return TrainSetup(cfg=cfg, rc=rc, skel=SMPLSkeleton,
                      rest_pose=spec['rest'],
                      anchors=P.make_anchors(spec['kps'], spec['bones']),
                      rest_pose_idxs=spec.get('subj'), near=spec['near'],
                      far=spec['far'], device='cpu', mesh=mesh)


def train_task(rank, world, spec, state, batch, steps, global_batch):
    """``steps`` steps of ``shard_train_step`` on the global ``batch``
    (this rank's block of it with ``global_batch``): each step's state
    and stats."""
    from anerf_torch.parallel.sharding import (make_mesh, shard_batch,
                                               shard_train_step)
    mesh = make_mesh(world)
    setup = _setup(spec)
    step = shard_train_step(setup, mesh, global_batch=global_batch)
    batch = to_torch(batch)
    if global_batch:
        batch = shard_batch(mesh, batch)
    state = to_torch(state)
    out = []
    for _ in range(steps):
        state, stats = step(state, batch, None)
        out.append((to_numpy(state), to_numpy(stats)))
    return {'steps': out}


def bundle_task(rank, world, spec, state, batch, steps, global_batch):
    """One bundle of ``steps`` steps (``shard_train_step(...,
    stacked=True)``) on ``batch`` stacked ``steps`` times (this rank's
    block of it, stacked, with ``global_batch``), and ``steps`` eager
    sharded steps from the same state: both final states and stats."""
    from anerf_torch.parallel.sharding import (make_mesh, shard_batch,
                                               shard_train_step)
    mesh = make_mesh(world)
    setup = _setup(spec)
    batch = to_torch(batch)
    if global_batch:
        batch = shard_batch(mesh, batch)
    eager = shard_train_step(setup, mesh, global_batch=global_batch)
    bundle = shard_train_step(setup, mesh, global_batch=global_batch,
                              stacked=True, steps=steps)
    a = to_torch(state)
    for _ in range(steps):
        a, sa = eager(a, batch, None)
    b, sb = bundle(to_torch(state),
                   {k: torch.stack([v] * steps) for k, v in batch.items()},
                   None)
    return {'eager': (to_numpy(a), to_numpy(sa)),
            'bundle': (to_numpy(b), to_numpy(sb))}


def render_task(rank, world, spec, params, est, chunks, image):
    """``ImageRenderer.render_image`` over the ranks, at each chunk."""
    from anerf_torch.parallel.sharding import make_mesh
    from anerf_torch.render.renderer import ImageRenderer
    rc, params = _setup(spec).rc, to_torch(params)
    return {'images': [ImageRenderer(rc, params, est, chunk=c, device='cpu',
                                     mesh=make_mesh(world)
                                     ).render_image(**image)
                       for c in chunks]}


def cli_task(rank, world, cfg_args, render_argv, root, env=None):
    """``run_train.train`` then, given ``render_argv``, ``run_render.main
    --mesh_devices``, with every file this rank opens for writing or
    saves with ``torch.save`` (which writes from C++) and every
    directory it makes under ``root`` recorded.  ``env`` is set in the
    rank's environment for the call; a ``NotImplementedError`` the
    training raises is returned as ``error`` (every rank raises it
    before the data loads)."""
    import torch.distributed as dist
    from anerf_torch.run_render import main
    from anerf_torch.run_train import train
    from anerf_torch.utils.config import config_from_cli
    writes = []
    real_open, real_makedirs, real_save = builtins.open, os.makedirs, \
        torch.save
    saved_env = {k: os.environ.get(k) for k in env or {}}

    def under_root(path):
        return os.path.abspath(str(path)).startswith(root)

    def spy_open(file, mode='r', *a, **k):
        if isinstance(file, (str, os.PathLike)) and under_root(file) \
                and any(c in mode for c in 'wax+'):
            writes.append(str(file))
        return real_open(file, mode, *a, **k)

    def spy_makedirs(name, *a, **k):
        if under_root(name) and not os.path.isdir(name):
            writes.append(str(name))
        return real_makedirs(name, *a, **k)

    def spy_save(obj, f, *a, **k):
        if isinstance(f, (str, os.PathLike)) and under_root(f):
            writes.append(str(f))
        return real_save(obj, f, *a, **k)

    builtins.open, os.makedirs, torch.save = spy_open, spy_makedirs, \
        spy_save
    os.environ.update(env or {})
    try:
        try:
            state = train(config_from_cli(cfg_args), device='cpu')
        except NotImplementedError as e:
            return {'error': str(e), 'writes': writes}
        dist.barrier()          # rank 0's final checkpoint is written
        out = main(render_argv, device='cpu') if render_argv else None
    finally:
        builtins.open, os.makedirs, torch.save = real_open, \
            real_makedirs, real_save
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {'state': to_numpy({k: state[k] for k in (
        'params', 'opt_state', 'pose_params', 'pose_opt_state', 'step')}),
        'rgbs': None if out is None else out['rgbs'], 'writes': writes}


def jobs_task(rank, world, jobs):
    """Several tasks in one spawn, in order: ``jobs`` maps a name to
    (task, kwargs); the results by name."""
    return {'jobs': {name: TASKS[task](rank, world, **kw)
                     for name, (task, kw) in jobs.items()}}


TASKS = {'train': train_task, 'bundle': bundle_task, 'render': render_task,
         'cli': cli_task, 'jobs': jobs_task}


def _rank(rank, world, store, task, kwargs, out_dir):
    import torch.distributed as dist
    from anerf_torch.parallel.sharding import init_distributed
    torch.set_num_threads(2)
    init_distributed(backend='gloo', init_method=f'file://{store}',
                     rank=rank, world_size=world)
    try:
        result = TASKS[task](rank, world, **kwargs)
    finally:
        dist.destroy_process_group()
    result['jax_imported'] = 'jax' in sys.modules
    torch.save(result, os.path.join(out_dir, f'rank{rank}.pt'))


def spawn(task, kwargs, tmp, world=2, timeout=TIMEOUT):
    """Run ``TASKS[task](rank, world, **kwargs)`` in ``world`` ranks;
    returns their results in rank order.  A rank that raises fails the
    call with its traceback; one that outlives ``timeout`` seconds is
    killed, and the call fails."""
    import torch.multiprocessing as mp
    out_dir = str(tmp)
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, 'store')
    ctx = mp.start_processes(_rank, args=(world, store, task, kwargs,
                                          out_dir),
                             nprocs=world, join=False, start_method='spawn')
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f'{task}: the ranks did not finish within '
                               f'{timeout} s')
    return [torch.load(os.path.join(out_dir, f'rank{r}.pt'),
                       weights_only=False) for r in range(world)]
