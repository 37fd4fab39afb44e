"""The port's training entry point, on the CPU, and its eval metrics.

``anerf_torch.run_train.train`` on ``configs/synthetic_tiny.txt`` and a
synthetic store writes what the root ``run_train.py`` writes
(tests/test_e2e.py): ``args.txt``, checkpoints, pose checkpoints,
``metrics.jsonl`` with ``total_loss``, the validation videos'
tensorboard tags (RGB, disparity and the skeleton overlay) and ``psnr.txt``/``ssim.txt``; a second call resumes
from the newest checkpoint.  ``psnr``, ``ssim``, ``evaluate_images``
and the pose metrics match anerf_tpu's within 1e-6.
"""
import json
import os

import numpy as np
import pytest
import torch

from anerf_torch.data.writer import make_synthetic_store
from anerf_torch.utils.config import config_from_cli, load_config

from test_torch_threads import one_torch_thread  # noqa: F401

CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'synthetic_tiny.txt')


def test_train_cli_writes_and_resumes(tmp_path):
    from anerf_torch.run_train import train
    from anerf_torch.training.checkpoint import load_checkpoint
    from anerf_torch.utils.logging import read_tb_tags
    store = make_synthetic_store(str(tmp_path / 'synthetic.npstore'),
                                 n_frames=6, H=24, W=24)
    cfg = config_from_cli(['--config', CONFIG,
                           '--basedir', str(tmp_path / 'logs'),
                           '--datadir', store, '--n_iters', '6',
                           '--i_weights', '3', '--i_print', '2',
                           '--i_testset', '4', '--i_pose_weights', '3',
                           '--num_workers', '1'])
    seen = []
    state = train(cfg, device='cpu',
                  on_step=lambda i, st, stats: seen.append((i, stats is None)))
    assert seen[0] == (0, True) and [i for i, _ in seen[1:]] == list(
        range(1, 7))
    assert state['step'] == 6

    logdir = os.path.join(cfg.basedir, cfg.expname)
    files = os.listdir(logdir)
    assert 'args.txt' in files
    assert load_config(os.path.join(logdir, 'args.txt')) == cfg
    assert sorted(f for f in files if f.startswith('ckpt_')) == \
        ['ckpt_00000003.pt', 'ckpt_00000006.pt']
    assert sorted(f for f in files if f.startswith('pose_ckpt_')) == \
        ['pose_ckpt_00000003.pt', 'pose_ckpt_00000006.pt']
    with open(os.path.join(logdir, 'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    losses = [r['total_loss'] for r in recs if 'total_loss' in r]
    assert losses and np.isfinite(losses).all()
    assert 'Val/RGB' in read_tb_tags(logdir)
    assert 'Val/Disp' in read_tb_tags(logdir)
    assert 'Val/Skeleton' in read_tb_tags(logdir)
    for name in ('psnr', 'ssim'):
        lines = open(os.path.join(logdir, f'{name}.txt')).read().split()
        assert len(lines) == 1 and np.isfinite(float(lines[0]))

    # resume from the final checkpoint: the restored state is the saved
    final = load_checkpoint(os.path.join(logdir, 'ckpt_00000006.pt'))
    restored = {}
    cfg2 = load_config(CONFIG, basedir=cfg.basedir, datadir=store,
                       n_iters=8, num_workers=1)
    state2 = train(cfg2, device='cpu', on_step=lambda i, st, stats:
                   restored.setdefault('at', (i, {k: v.clone() for k, v in
                                                  st['pose_params'].items()},
                                              st['opt_state']['count'])))
    i0, bank, count = restored['at']
    assert i0 == 6 and count == final['opt_state']['count'] == 6
    assert all(torch.equal(bank[k], final['pose_params'][k]) for k in bank)
    assert state2['step'] == 8


def test_train_cli_refuses_several_devices(monkeypatch):
    """One process drives one device: ``n_devices=2`` in a world of one
    raises, naming torchrun, and so does ``WORLD_SIZE=2`` without the
    rest of a launcher's environment (``tests/test_torch_parallel_cli.py``
    trains two ranks)."""
    from anerf_torch.run_train import train
    with pytest.raises(ValueError, match='torchrun'):
        train(load_config(CONFIG, n_devices=2), device='cpu')
    for k in ('RANK', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv('WORLD_SIZE', '2')
    with pytest.raises(RuntimeError, match='torchrun'):
        train(load_config(CONFIG), device='cpu')
    monkeypatch.setenv('RANK', '1')
    with pytest.raises(RuntimeError, match='MASTER_ADDR and MASTER_PORT'):
        train(load_config(CONFIG), device='cpu')


def test_image_metrics_match_jax():
    from anerf_tpu.eval import metrics as JM
    from anerf_torch.eval import metrics as TM
    rng = np.random.RandomState(0)
    preds = rng.uniform(0, 1, (3, 20, 24, 3)).astype(np.float32)
    gts = np.clip(preds + rng.normal(0, 0.05, preds.shape), 0, 1).astype(
        np.float32)
    fgs = (rng.uniform(0, 1, (3, 20, 24, 1)) > 0.4).astype(np.uint8)
    for a, b in ((JM.psnr(preds[0], gts[0]), TM.psnr(preds[0], gts[0])),
                 (JM.psnr(preds[1], gts[1], fgs[1] > 0),
                  TM.psnr(preds[1], gts[1], fgs[1] > 0)),
                 (JM.ssim(preds[2], gts[2]), TM.ssim(preds[2], gts[2]))):
        assert abs(a - b) <= 1e-6 * abs(a)
    bboxes = [(np.array([2, 3]), np.array([20, 17]))] * 3
    # renders at half the resolution are resized before scoring
    small = preds[:, ::2, ::2]
    for args in ((preds, gts), (preds, gts, fgs, bboxes),
                 (small, gts, fgs, [(np.array([1, 1]), np.array([10, 8]))] * 3)):
        a, b = JM.evaluate_images(*args), TM.evaluate_images(*args)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6)


def test_pose_metrics_match_jax():
    from anerf_tpu.eval import metrics as JM
    from anerf_torch.eval import metrics as TM
    rng = np.random.RandomState(1)
    gt = rng.normal(size=(4, 17, 3))
    pred = gt @ np.linalg.qr(rng.normal(size=(3, 3)))[0] * 1.1 + 0.02 * \
        rng.normal(size=gt.shape)
    np.testing.assert_allclose(TM.procrustes(pred[0], gt[0]),
                               JM.procrustes(pred[0], gt[0]), rtol=1e-6)
    a, b = JM.pose_metrics(pred, gt), TM.pose_metrics(pred, gt)
    assert sorted(a) == sorted(b)
    for k in a:
        assert abs(a[k] - b[k]) <= 1e-6 * abs(a[k]) + 1e-12, k
