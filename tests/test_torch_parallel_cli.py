"""The port's entry points over two ranks, on the CPU.

Two gloo ranks (``_torch_parallel_worker.spawn``: torch and anerf_torch
only, a ``file://`` store, a time limit), spawned once for the module,
run ``run_train.train`` for 2 steps of ``configs/synthetic_tiny.txt`` on
a synthetic store, then ``run_render.main --mesh_devices 2`` from its
checkpoint: rank 0 alone writes files (every ``open`` for writing and
every ``os.makedirs`` under the test's directory is recorded on each
rank), the ranks' final states are bit-equal, and the two-rank frames
equal a one-rank render's within ``test_sharded_eval.py``'s rgb bar
(1e-5).  In the same spawn: 4 steps at ``--steps_per_dispatch 2`` leave
a checkpoint bit-equal to 4 eager steps', and with torchrun's
``LOCAL_WORLD_SIZE`` below the world size the bundles are refused
(anerf_tpu bundles on one host only).
"""
import os

import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
from anerf_torch.data.writer import make_synthetic_store

from test_torch_threads import one_torch_thread  # noqa: F401

CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'synthetic_tiny.txt')


def _train_args(store, logs, n_iters, **flags):
    args = ['--config', CONFIG, '--basedir', logs, '--datadir', store,
            '--n_iters', str(n_iters), '--i_weights', str(n_iters),
            '--i_print', '1', '--i_testset', '2',
            '--i_pose_weights', str(n_iters), '--num_workers', '1']
    for k, v in flags.items():
        args += [f'--{k}', str(v)]
    return args


@pytest.fixture(scope='module')
def cli(tmp_path_factory):
    """The spawn's results by job, its root and store, and the render
    flags of its checkpoint."""
    root = str(tmp_path_factory.mktemp('cli') / 'run')
    store = make_synthetic_store(os.path.join(root, 'synthetic.npstore'),
                                 n_frames=6, H=24, W=24)
    logs = os.path.join(root, 'logs')
    logdir = os.path.join(logs, 'synthetic_tiny')
    render = ['--nerf_args', os.path.join(logdir, 'args.txt'),
              '--ckptpath', os.path.join(logdir, 'ckpt_00000002.pt'),
              '--dataset_path', store, '--render_type', 'bullet',
              '--selected_idxs', '1', '--n_bullet', '2', '--chunk', '512',
              '--outputdir', os.path.join(root, 'render')]
    four = lambda name, **flags: _train_args(
        store, os.path.join(root, name), 4, i_testset=100, **flags)
    jobs = {
        'cli': ('cli', dict(
            cfg_args=_train_args(store, logs, 2),
            render_argv=render + ['--runname', 'two', '--mesh_devices', '2'],
            root=root)),
        'eager': ('cli', dict(cfg_args=four('eager'), render_argv=None,
                              root=root)),
        'bundled': ('cli', dict(cfg_args=four('bundled',
                                              steps_per_dispatch=2),
                                render_argv=None, root=root)),
        'two_hosts': ('cli', dict(cfg_args=four('hosts',
                                                steps_per_dispatch=2),
                                  render_argv=None, root=root,
                                  env={'LOCAL_WORLD_SIZE': '1'}))}
    results = W.spawn('jobs', dict(jobs=jobs),
                      tmp_path_factory.mktemp('ranks'))
    assert not any(r['jax_imported'] for r in results)
    return dict(results={name: [r['jobs'][name] for r in results]
                         for name in jobs},
                root=root, logdir=logdir, render=render)


def test_train_and_render_over_two_ranks(cli):
    from anerf_torch.run_render import main
    results, root, logdir = cli['results']['cli'], cli['root'], cli['logdir']

    # rank 0 alone wrote: the logdir, args.txt, logs, checkpoints, the
    # validation metrics and the frames
    assert results[1]['writes'] == []
    wrote = {os.path.relpath(p, root) for p in results[0]['writes']}
    for f in ('args.txt', 'ckpt_00000002.pt', 'pose_ckpt_00000002.pt',
              'metrics.jsonl', 'psnr.txt'):
        assert os.path.join('logs', 'synthetic_tiny', f) in wrote, f
    assert os.path.join('render', 'two', '0000.png') in wrote
    assert sorted(os.listdir(logdir)) == sorted(
        f for f in os.listdir(logdir) if os.path.join(
            'logs', 'synthetic_tiny', f) in wrote)

    # the ranks' states bit-equal, two steps taken
    W.same_bits(results[0]['state'], results[1]['state'])
    assert results[0]['state']['step'] == 2

    # the sharded frames: the same on both ranks, and a one-rank render's
    one = main(cli['render'] + ['--runname', 'one'], device='cpu')
    two = results[0]['rgbs']
    assert np.array_equal(two, results[1]['rgbs'])
    assert two.shape == one['rgbs'].shape == (2, 24, 24, 3)
    np.testing.assert_allclose(two, one['rgbs'], rtol=0, atol=1e-5)
    assert sorted(os.listdir(os.path.join(root, 'render', 'two'))) == \
        sorted(os.listdir(os.path.join(root, 'render', 'one')))


def test_bundles_over_two_ranks_match_eager_steps(cli):
    """Two ranks at ``--steps_per_dispatch 2`` over 4 steps: each rank
    stacks its own draws, rank 0 alone writes, and the checkpoints equal
    the two-rank eager run's bit for bit."""
    root = cli['root']
    eager, bundled = (cli['results'][k] for k in ('eager', 'bundled'))
    assert bundled[1]['writes'] == []
    for k in ('ckpt_00000004.pt', 'pose_ckpt_00000004.pt'):
        assert os.path.join(root, 'bundled', 'synthetic_tiny', k) in \
            bundled[0]['writes']
        a, b = (torch.load(os.path.join(root, run, 'synthetic_tiny', k),
                           weights_only=False) for run in ('eager',
                                                           'bundled'))
        W.same_bits(W.to_numpy(a), W.to_numpy(b))
    for r in (0, 1):
        W.same_bits(eager[r]['state'], bundled[r]['state'])
    W.same_bits(bundled[0]['state'], bundled[1]['state'])
    assert bundled[0]['state']['step'] == 4


def test_bundles_over_several_hosts_are_refused(cli):
    """``LOCAL_WORLD_SIZE`` 1 of a world of 2: every rank raises naming
    the one-host rule, before it writes anything."""
    for r in cli['results']['two_hosts']:
        assert 'one host' in r['error'] and 'LOCAL_WORLD_SIZE 1' in \
            r['error'], r['error']
        assert r['writes'] == []
