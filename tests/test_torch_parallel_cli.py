"""The port's entry points over two ranks, on the CPU.

Two gloo ranks (``_torch_parallel_worker.spawn``: torch and anerf_torch
only, a ``file://`` store, a time limit) run ``run_train.train`` for 2
steps of ``configs/synthetic_tiny.txt`` on a synthetic store, then
``run_render.main --mesh_devices 2`` from its checkpoint: rank 0 alone
writes files (every ``open`` for writing and every ``os.makedirs``
under the test's directory is recorded on each rank), the ranks' final
states are bit-equal, and the two-rank frames equal a one-rank render's
within ``test_sharded_eval.py``'s rgb bar (1e-5).
"""
import os

import numpy as np

import _torch_parallel_worker as W
from anerf_torch.data.writer import make_synthetic_store

CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'synthetic_tiny.txt')


def test_train_and_render_over_two_ranks(tmp_path):
    from anerf_torch.run_render import main
    root = str(tmp_path / 'run')
    store = make_synthetic_store(os.path.join(root, 'synthetic.npstore'),
                                 n_frames=6, H=24, W=24)
    logs = os.path.join(root, 'logs')
    cfg_args = ['--config', CONFIG, '--basedir', logs, '--datadir', store,
                '--n_iters', '2', '--i_weights', '2', '--i_print', '1',
                '--i_testset', '2', '--i_pose_weights', '2',
                '--num_workers', '1']
    logdir = os.path.join(logs, 'synthetic_tiny')
    render = ['--nerf_args', os.path.join(logdir, 'args.txt'),
              '--ckptpath', os.path.join(logdir, 'ckpt_00000002.pt'),
              '--dataset_path', store, '--render_type', 'bullet',
              '--selected_idxs', '1', '--n_bullet', '2', '--chunk', '512',
              '--outputdir', os.path.join(root, 'render')]
    results = W.spawn('cli', dict(
        cfg_args=cfg_args, render_argv=render + ['--runname', 'two',
                                                 '--mesh_devices', '2'],
        root=root), tmp_path / 'ranks')
    assert not any(r['jax_imported'] for r in results)

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
    one = main(render + ['--runname', 'one'], device='cpu')
    two = results[0]['rgbs']
    assert np.array_equal(two, results[1]['rgbs'])
    assert two.shape == one['rgbs'].shape == (2, 24, 24, 3)
    np.testing.assert_allclose(two, one['rgbs'], rtol=0, atol=1e-5)
    assert sorted(os.listdir(os.path.join(root, 'render', 'two'))) == \
        sorted(os.listdir(os.path.join(root, 'render', 'one')))
