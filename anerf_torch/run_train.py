"""Training entry point of the port: the twin of the root ``run_train.py``.

    python -m anerf_torch.run_train --config configs/mixamo.txt [--flag value]

Mirrors ``run_train.py`` (reference run_nerf.py:491-618 ``train()``)
step for step, on one GPU: config -> data (a numpy data store,
``data/store.py``) -> raycaster -> pose refinement -> the step loop,
with checkpoints every ``i_weights`` steps, pose-only checkpoints every
``i_pose_weights``, scalar logs every ``i_print`` (one interval late,
so that printing never waits for the step just queued), a validation
render with PSNR/SSIM every ``i_testset``, and a final checkpoint.  A
restart in the same logdir resumes from its newest checkpoint.

``--steps_per_dispatch k`` bundles k steps into one call of
``make_multi_train_step`` (on a GPU k replays of one CUDA graph of the
step), as ``run_train.py`` does: the cadences are checked after each
bundle, so they should be multiples of k.

``train(cfg, device=None)`` is the function form: ``device=None`` means
the GPU and raises without one; pass ``device='cpu'`` to train on the
CPU (the fused kernels' plain twins stand in).

Several processes, one a device, as ``run_train.py`` trains over
several hosts:

    python -m torch.distributed.run --nproc_per_node N \
        -m anerf_torch.run_train --config configs/mixamo.txt ...

Each rank draws its block of every global batch of ``N_rand`` rays
(``data.pipeline.Prefetcher``), the states start bit-equal
(``parallel.sharding.replicate_state``) and the step all-reduces its
gradients (``parallel.sharding.shard_train_step``); rank 0 alone writes
the logdir: ``args.txt``, the logs, the checkpoints and the validation
renders.  ``n_devices``, when set, must be the number of ranks.  With
``--steps_per_dispatch k`` each rank stacks k of its own draws into one
bundle (``shard_train_step(..., stacked=True)``; under NCCL the graph
holds the collectives), on one host's ranks only, as ``run_train.py``
bundles on one host.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def _validate(cfg, renderer, render_data, logger, logdir: str,
              i: int) -> None:
    """Render the validation poses; log RGB, disparity and skeleton
    overlay videos and the mean PSNR/SSIM (also appended to psnr.txt /
    ssim.txt, the reference's format: evaluation_helpers.py:356-383)."""
    from .eval.metrics import evaluate_images
    from .utils.logging import draw_skeleton_2d
    out = renderer.render_path(render_data, ext_scale=cfg.ext_scale,
                               render_factor=cfg.render_factor)
    logger.log_video(i, 'Val/RGB', out['rgbs'])
    # disparity normalized by its global max, like the reference
    # (run_nerf.py:178,591 Val/ValDIPS)
    disps = out['disps']
    dmax = float(np.max(disps))
    logger.log_video(i, 'Val/Disp', (disps / (dmax if dmax > 0 else 1.0))
                     [..., None].repeat(3, axis=-1))
    focals = render_data['hwf'][2]
    logger.log_video(i, 'Val/Skeleton', np.stack([
        draw_skeleton_2d(rgb, render_data['kp3d'][j], render_data['c2ws'][j],
                         focals if np.isscalar(focals) else focals[j])
        for j, rgb in enumerate(out['rgbs'])]))
    if render_data.get('imgs') is None:
        return
    m = evaluate_images(out['rgbs'], render_data['imgs'],
                        fgs=render_data.get('fgs'), bboxes=out['bboxes'])
    means = {k: float(np.nanmean(m[k])) for k in ('psnr', 'ssim')}
    logger.log_scalars(i, means, prefix='Val/')
    for name, v in means.items():
        with open(os.path.join(logdir, f'{name}.txt'), 'a') as f:
            f.write(f'{v}\n')
    print(f"[val {i}] psnr={means['psnr']:.2f} ssim={means['ssim']:.3f}")


def train(cfg, device=None,
          on_step: Optional[Callable[[int, Dict[str, Any], Any], None]] = None
          ) -> Dict[str, Any]:
    """Train ``cfg`` and return the final train state.

    ``on_step(i, state, stats)``, when given, is called once before the
    first step (``i`` the start step, ``stats`` None) and then right
    after each step, or each bundle of ``steps_per_dispatch`` steps
    (``i`` the steps done), before its logging, checkpoints and
    validation."""
    from .data.loaders import load_data
    from .data.pipeline import DeviceFeeder
    from .models.factory import build_raycast_config, embed_state
    from .parallel.sharding import (init_distributed, make_mesh,
                                    rank_generator, replicate_state,
                                    require_one_host, shard_train_step)
    from .render.renderer import ImageRenderer
    from .training import pose_opt as P
    from .training.checkpoint import (latest_checkpoint, load_checkpoint,
                                      load_pose_payload,
                                      load_torch_checkpoint, restore_like,
                                      restore_train_state, save_checkpoint,
                                      save_pose_checkpoint)
    from .training.trainer import (TrainSetup, init_train_state,
                                   make_multi_train_step, make_train_step,
                                   stack_batches)
    from .utils.config import save_args_txt
    from .utils.device import resolve_device
    from .utils.logging import MetricLogger

    # several ranks: join the job torchrun describes (one process: a
    # no-op); rank 0 alone writes the logdir
    init_distributed(backend='gloo' if device is not None and torch.device(
        device).type == 'cpu' else None)
    mesh = make_mesh(cfg.n_devices)
    spd = max(1, int(cfg.steps_per_dispatch))
    require_one_host(mesh, spd)
    rank0 = mesh.rank == 0
    device = resolve_device(device)
    logdir = os.path.join(cfg.basedir, cfg.expname)
    if rank0:
        os.makedirs(logdir, exist_ok=True)
        save_args_txt(cfg, logdir)
    logger = MetricLogger(logdir) if rank0 else None

    # --- data: this rank's block of each global batch ---
    prefetcher, render_data, data_attrs = load_data(
        cfg, process_index=mesh.rank, process_count=mesh.size)
    n_framecodes = int(data_attrs['n_views'])
    rest_pose = np.asarray(data_attrs['rest_pose'], np.float32)

    # --- model + trainer ---
    n_subjects = int(data_attrs.get('n_subjects', 1) or 1)
    rc = build_raycast_config(cfg, skel=data_attrs['skel_type'],
                              n_framecodes=n_framecodes,
                              n_subjects=n_subjects)
    anchors = P.make_anchors(data_attrs['kp3d'], data_attrs['bones'],
                             device=device) if cfg.opt_pose else None
    setup = TrainSetup(cfg=cfg, rc=rc, skel=data_attrs['skel_type'],
                       rest_pose=rest_pose, anchors=anchors,
                       kp_map=data_attrs.get('kp_map'),
                       rest_pose_idxs=data_attrs.get('rest_pose_idxs'),
                       near=0.0, far=1.0, device=device)
    state = init_train_state(setup, torch.Generator().manual_seed(cfg.seed),
                             init_kp3d=data_attrs['kp3d'],
                             init_bones=data_attrs['bones'])

    # --- resume ---
    start = 0
    ckpt_path = None
    if cfg.ft_path not in (None, 'None'):
        ckpt_path = cfg.ft_path
    elif not cfg.no_reload:
        ckpt_path = latest_checkpoint(logdir)
    if ckpt_path is not None:
        print(f'Reloading from {ckpt_path}')
        if ckpt_path.endswith('.tar'):
            loaded = load_torch_checkpoint(ckpt_path)
            state['params'] = restore_like(state['params'], loaded['params'])
            if not cfg.finetune:
                start = state['step'] = loaded['global_step']
        else:
            state, start = restore_train_state(
                state, load_checkpoint(ckpt_path), finetune=cfg.finetune,
                no_poseopt_reload=cfg.no_poseopt_reload)

    # --- pose-bank init from an explicit pose checkpoint + anchors ---
    if cfg.opt_pose and cfg.init_poseopt not in (None, 'None') \
            and not cfg.no_poseopt_reload:
        # reference pose_opt.py:51-60: --init_poseopt seeds the bank
        # (and the anchors, when stored) from a separate checkpoint
        payload = load_pose_payload(cfg.init_poseopt)
        state['pose_params'] = restore_like(state['pose_params'],
                                            payload['pose_params'])
        if payload.get('anchors') is not None and not cfg.use_ckpt_anchor:
            anchors = {k: torch.as_tensor(np.asarray(v, np.float32),
                                          device=device)
                       for k, v in payload['anchors'].items()}
    if cfg.opt_pose and cfg.use_ckpt_anchor:
        # anchors = FK of the (loaded) bank, so the regularizer pulls
        # toward the checkpoint's refined poses instead of the initial
        # estimates (reference pose_opt.py:62-68)
        with torch.no_grad():
            all_idx = torch.arange(state['pose_params']['pelvis'].shape[0],
                                   device=device)
            a_kps, a_bones, _, _, a_rots = P.pose_fk(
                state['pose_params'], all_idx,
                setup.frame_rest_pose(all_idx), setup.skel, setup.kp_map)
        anchors = {'kps': a_kps, 'bones': a_bones, 'rots': a_rots}
    if anchors is not setup.anchors:
        setup = dataclasses.replace(setup, anchors=anchors)

    if mesh.size > 1:
        # every rank resumed from the same checkpoint: now bit-equal
        state = replicate_state(mesh, state)
        # each rank draws its own block of the global batch (host_slice)
        step_fn = shard_train_step(setup, mesh, global_batch=True,
                                   stacked=spd > 1, steps=spd)
    elif spd > 1:
        step_fn = make_multi_train_step(setup, spd)
    else:
        step_fn = make_train_step(setup)
    feeder = DeviceFeeder(device)
    gen = rank_generator(mesh, cfg.seed + 1, device)
    print(f'Training {cfg.expname}: steps {start}..{cfg.n_iters} on {device}'
          + (f', rank {mesh.rank} of {mesh.size}' if mesh.size > 1 else ''))
    t_last = time.time()
    i = start
    pending_log = None

    def _flush_log(pend):
        j, pstats, rays = pend
        scalars = dict(pstats)
        scalars['rays_per_sec'] = rays
        logger.log_scalars(j, scalars, prefix='Loss/')
        print(f"[{j}] loss={float(pstats['total_loss']):.5f} "
              f"psnr={float(pstats.get('psnr', np.nan)):.2f} "
              f'rays/s={rays:.0f}')

    if on_step is not None:
        on_step(i, state, None)
    bundle = []
    for batch in prefetcher:
        if i >= cfg.n_iters:
            break
        if spd > 1:
            # spd batches stacked into one call (k graph replays on a GPU)
            bundle.append(batch)
            if len(bundle) < spd:
                continue
            state, stats = step_fn(state, feeder(stack_batches(bundle)), gen)
            bundle = []
            i += spd
        else:
            state, stats = step_fn(state, feeder(batch), gen)
            i += 1
        if on_step is not None:
            on_step(i, state, stats)

        if not rank0:
            continue
        if i % cfg.i_print == 0:
            dt = time.time() - t_last
            t_last = time.time()
            # log the PREVIOUS interval's stats and keep this one for the
            # next: reading the scalars of the step just queued would
            # wait for it on every print
            if pending_log is not None:
                _flush_log(pending_log)
            pending_log = (i, stats, cfg.N_rand * cfg.i_print / dt)

        if i % cfg.i_weights == 0:
            path = save_checkpoint(logdir, state, i, anchors=anchors)
            print('Saved checkpoint at', path)

        if cfg.opt_pose and i % cfg.i_pose_weights == 0:
            save_pose_checkpoint(logdir, state, i, anchors=anchors)

        if i % cfg.i_testset == 0 and render_data is not None:
            renderer = ImageRenderer(rc, state['params'],
                                     embed_state(cfg, rc, i),
                                     chunk=cfg.chunk, near=0., far=1.,
                                     white_bkgd=cfg.white_bkgd,
                                     device=device)
            _validate(cfg, renderer, render_data, logger, logdir, i)

    if rank0:
        if pending_log is not None:
            _flush_log(pending_log)
        save_checkpoint(logdir, state, i, anchors=anchors)
        logger.close()
    prefetcher.stop()
    print('Training done at step', i)
    return state


if __name__ == '__main__':
    from anerf_torch.utils.config import config_from_cli
    train(config_from_cli(sys.argv[1:]))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
