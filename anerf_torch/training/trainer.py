"""The training step: NeRF Adam every step, plus pose refinement.

Port of ``anerf_tpu/training/trainer.py`` (reference core/trainer.py
Trainer.train_batch :230-273, compute_loss :319-441, optimize :451-483)
for one device.  The step renders a batch through ``render_rays``,
computes the loss stack, takes the gradients of the NeRF parameters and
the pose bank with autograd, and updates both in place.

Reference semantics, as in anerf_tpu:
  * the NeRF Adam steps every iteration with the piecewise-constant
    exponential decay (trainer.py:173-183);
  * pose gradients accumulate (sum) across iterations and the pose Adam
    fires every ``opt_pose_step`` iterations (trainer.py:476-482); only
    a fire advances the pose optimizer's count;
  * after ``opt_pose_stop`` / before ``opt_pose_warmup`` the pose bank
    gets no update and the kp losses drop out (trainer.py:240-241,252).

The host knows the step, so the gates are Python branches and the
schedules host floats; nothing in the step reads a device value back,
so the host queues the next step while the device runs this one.

Adam is optax's ``scale_by_adam(0.9, 0.999, 1e-8)`` ->
``scale_by_schedule`` -> ``scale(-1)`` written as tensor code, its
schedule fed the optimizer's own count.

The three pose modes of anerf_tpu (its trainer.py:322-415), each a
Python branch on host gates (``training/flipflop.py``):
  * the default: pose fires every ``opt_pose_step`` iterations inside
    the warmup/stop window;
  * joint (``opt_pose_joint``, or ``testopt`` without flipflop): the
    NeRF every step, the pose on ``update_gates(step + 1)``'s pose gate
    inside the window;
  * alternating (``opt_pose_flipflop`` without joint): NeRF and pose
    turns; a step off the NeRF turn skips the NeRF Adam update, so its
    count does not advance.
``testopt`` zeroes the NeRF gradients but, outside the alternating
mode, still runs the NeRF Adam update (its count and schedule advance,
the parameters stay).  With ``opt_pose_flipflop`` the per-frame kp-loss
trackers accumulate every step, and with ``opt_pose_reset`` the pose
bank's snapshot is refreshed from the pre-update bank at each pose-turn
start.

Multiple subjects (``ConcatH5Dataset``'s layout): a rest pose per
subject, ``rest_pose_idxs`` naming each frame's subject for FK, and the
batch's ``subject_idxs`` feeding the model's subject channel.

Not ported yet (ROADMAP.md A.3): ``make_multi_train_step``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..interop import params_to, tree_map
from ..models.factory import embed_state, init_raycaster_params
from ..models.raycaster import RayCastConfig, render_rays
from ..skeleton import Skeleton
from ..utils.config import Config
from ..utils.device import resolve_device
from . import flipflop as FF
from . import losses as L
from . import pose_opt as P

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Tensor leaves in JAX's order (dict keys sorted, lists in order,
    None skipped), so a leaf list lines up with ``jax.tree_util``'s."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def adam_init(params: Any) -> Dict[str, Any]:
    """The state of optax's Adam chain: one count (the schedule's count
    is the same number) and the two moment trees."""
    return {'count': 0, 'mu': tree_map(torch.zeros_like, params),
            'nu': tree_map(torch.zeros_like, params)}


@torch.no_grad()
def adam_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                opt_state: Dict[str, Any], sched: Callable[[int], float]
                ) -> None:
    """One step of optax's ``scale_by_adam`` -> ``scale_by_schedule`` ->
    ``scale(-1)`` -> ``apply_updates`` on leaf lists, in place (params,
    moments and count): mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu,
    p += -lr(count) (mu / bc1) / (sqrt(nu / bc2) + eps)."""
    mu, nu = tree_leaves(opt_state['mu']), tree_leaves(opt_state['nu'])
    lr = sched(opt_state['count'])
    count = opt_state['count'] + 1
    f32 = np.float32
    bc1 = float(f32(1) - f32(ADAM_B1) ** f32(count))
    bc2 = float(f32(1) - f32(ADAM_B2) ** f32(count))
    new_mu = torch._foreach_mul(grads, 1 - ADAM_B1)
    torch._foreach_add_(new_mu, torch._foreach_mul(mu, ADAM_B1))
    new_nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - ADAM_B2)
    torch._foreach_add_(new_nu, torch._foreach_mul(nu, ADAM_B2))
    den = torch._foreach_sqrt(torch._foreach_div(new_nu, bc2))
    torch._foreach_add_(den, ADAM_EPS)
    upd = torch._foreach_div(new_mu, bc1)
    torch._foreach_div_(upd, den)
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(params, upd)
    torch._foreach_copy_(mu, new_mu)
    torch._foreach_copy_(nu, new_nu)
    opt_state['count'] = count


def _nerf_sched(cfg: Config) -> Callable[[int], float]:
    return L.nerf_lr_schedule(cfg.lrate, cfg.lrate_decay,
                              cfg.lrate_decay_rate, cfg.decay_unit)


def _pose_sched(cfg: Config) -> Callable[[int], float]:
    return L.pose_lr_schedule(cfg.opt_pose_lrate, cfg.opt_pose_lrate_decay,
                              cfg.opt_pose_decay_rate,
                              cfg.opt_pose_decay_unit, cfg.opt_pose_step)


@dataclasses.dataclass
class TrainSetup:
    """Everything static the train step needs.  ``device=None`` means
    the GPU and raises when there is none; pass 'cpu' to train there
    (the fused kernels' plain twins stand in).  The rest pose, the
    subject of each frame and the anchors move to the device on
    construction."""
    cfg: Config
    rc: RayCastConfig
    skel: Skeleton
    rest_pose: Any                      # (J, 3) or (S, J, 3) per subject
    anchors: Optional[Dict[str, Any]] = None
    kp_map: Optional[Any] = None
    # multi-subject: per-frame subject index into rest_pose's leading
    # axis (ConcatH5Dataset meta rest_pose_idxs)
    rest_pose_idxs: Optional[Any] = None
    near: float = 0.0
    far: float = 1.0
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        to = lambda a: torch.as_tensor(np.asarray(a, np.float32)
                                       if not torch.is_tensor(a) else a,
                                       device=self.device)
        self.rest_pose = to(self.rest_pose)
        if self.anchors is not None:
            self.anchors = {k: to(v) for k, v in self.anchors.items()}
        idx = lambda a: (a if torch.is_tensor(a) else torch.as_tensor(
            np.asarray(a))).to(self.device).long()
        if self.kp_map is not None:
            self.kp_map = idx(self.kp_map)
        if self.rest_pose_idxs is not None:
            self.rest_pose_idxs = idx(self.rest_pose_idxs)

    def frame_rest_pose(self, kp_idx: torch.Tensor) -> torch.Tensor:
        """Rest pose rows of the indexed frames: (N, J, 3) when
        multi-subject, else the shared (J, 3)."""
        if self.rest_pose.dim() == 3 and self.rest_pose_idxs is not None:
            return self.rest_pose[self.rest_pose_idxs[kp_idx]]
        if self.rest_pose.dim() == 3:
            return self.rest_pose[0]
        return self.rest_pose


def init_train_state(setup: TrainSetup, generator: torch.Generator,
                     init_kp3d: Optional[np.ndarray] = None,
                     init_bones: Optional[np.ndarray] = None
                     ) -> Dict[str, Any]:
    """Fresh parameters drawn from ``generator`` (a CPU generator), both
    optimizer states, the pose bank and its gradient accumulator, on
    ``setup.device``."""
    cfg = setup.cfg
    params = params_to(init_raycaster_params(generator, setup.rc, cfg,
                                             setup.skel), setup.device)
    state: Dict[str, Any] = {'params': params,
                             'opt_state': adam_init(params),
                             'pose_params': None, 'pose_opt_state': None,
                             'pose_accum': None, 'step': 0}
    if cfg.opt_pose:
        if init_kp3d is None or init_bones is None:
            raise ValueError('opt_pose needs init_kp3d and init_bones')
        pose = P.init_pose_params(init_kp3d, init_bones,
                                  use_rot6d=cfg.opt_rot6d,
                                  kp_map=setup.kp_map, skel=setup.skel,
                                  device=setup.device)
        state['pose_params'] = pose
        state['pose_opt_state'] = adam_init(pose)
        state['pose_accum'] = tree_map(torch.zeros_like, pose)
        if cfg.opt_pose_flipflop:
            state['kp_tracker'] = FF.init_tracker_state(
                np.asarray(init_kp3d).shape[0], setup.device)
            if cfg.opt_pose_reset:
                # refreshed at each pose-turn start (reference
                # set_poseopt_ckpt, pose_opt.py:700-703)
                state['pose_snapshot'] = FF.clone_tree(pose)
    return state


def get_batch_pose(setup: TrainSetup, pose_params, batch
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Per-ray pose data from the pose bank, or from the batch when
    there is no bank (reference ``Trainer.get_kp_args``,
    trainer.py:285-312).  FK runs once over the bank's frames and the
    rays gather their rows, as in anerf_tpu."""
    if pose_params is None:
        pose = {k: batch[k] for k in ('kps', 'skts', 'bones', 'cyls')}
        return pose, {}
    kp_idx = batch['kp_idx']
    n_frames = pose_params['pelvis'].shape[0]
    all_idxs = torch.arange(n_frames, device=kp_idx.device)
    kps_b, bones_b, skts_b, _, rots_b = P.pose_fk(
        pose_params, all_idxs, setup.frame_rest_pose(all_idxs), setup.skel,
        setup.kp_map)
    pose = {'kps': kps_b[kp_idx], 'skts': skts_b[kp_idx],
            'bones': bones_b[kp_idx], 'cyls': batch['cyls']}
    extras = {'rots': rots_b[kp_idx],
              'bank': {'kps': kps_b, 'bones': bones_b, 'rots': rots_b}}
    return pose, extras


def compute_losses(setup: TrainSetup, out, batch, pose, extras, pose_params,
                   use_pose_loss: float) -> Tuple[torch.Tensor, Dict]:
    """The full loss stack (reference trainer.py:319-441)."""
    cfg = setup.cfg
    loss_fn = L.get_loss_fn(cfg.loss_fn, cfg.loss_beta, cfg.use_yuv)
    reg_fn = L.get_reg_fn(cfg.reg_fn)
    bgs = batch.get('bgs', 1.0)
    stats: Dict[str, torch.Tensor] = {}
    total = 0.

    def nerf_loss(rgb_pred, acc_pred, coarse):
        nonlocal total
        rgb = rgb_pred
        if cfg.use_background:
            rgb = rgb + (1. - acc_pred)[..., None] * bgs
        rl = loss_fn(rgb, batch['target_s'])
        if coarse:
            rl = rl * cfg.coarse_weight
        stats['psnr0' if coarse else 'psnr'] = L.img2psnr(
            rgb.detach(), batch['target_s'])
        stats['rgb_loss0' if coarse else 'rgb_loss'] = rl
        total = total + rl
        if reg_fn is not None:
            reg = reg_fn(acc_pred, batch['fgs'][..., 0],
                         reduction='off') * cfg.reg_coef
            stats['reg_loss0' if coarse else 'reg_loss'] = reg
            total = total + reg

    nerf_loss(out['rgb_map'], out['acc_map'], coarse=False)
    if 'rgb0' in out:
        nerf_loss(out['rgb0'], out['acc0'], coarse=True)

    if pose_params is not None and setup.anchors is not None:
        kp_idx = batch['kp_idx']
        kp_loss = P.kp_reg_loss(pose['bones'], extras['rots'], setup.anchors,
                                kp_idx, cfg.opt_pose_tol, cfg.opt_pose_coef,
                                cfg.opt_rot6d) * use_pose_loss
        stats['kp_loss'] = kp_loss
        total = total + kp_loss
        if cfg.opt_pose_flipflop:
            # per-frame signal for the FlipFlop CMA trackers
            stats['kp_loss_per_ray'] = P.kp_reg_loss(
                pose['bones'], extras['rots'], setup.anchors, kp_idx,
                cfg.opt_pose_tol, cfg.opt_pose_coef, cfg.opt_rot6d,
                per_ray=True).detach()
        if cfg.use_temp_loss:
            n_frames = pose_params['pelvis'].shape[0]
            prev_idx = torch.clamp(kp_idx - 1, min=0)
            next_idx = (kp_idx + 1) % n_frames
            bank = extras['bank']
            pk, pb, pr = (bank['kps'][prev_idx], bank['bones'][prev_idx],
                          bank['rots'][prev_idx])
            nk, nb, nr = (bank['kps'][next_idx], bank['bones'][next_idx],
                          bank['rots'][next_idx])
            if cfg.opt_rot6d:
                from ..ops.rotations import rot_to_rot6d
                pb, nb = rot_to_rot6d(pr), rot_to_rot6d(nr)
                bones_cmp = rot_to_rot6d(extras['rots'])
            else:
                bones_cmp = pose['bones']
            t_loss = P.temporal_loss(
                bones_cmp, pose['kps'], pb.detach(), pk.detach(),
                nb.detach(), nk.detach(), batch['temp_val'],
                cfg.temp_coef) * use_pose_loss
            stats['temp_loss'] = t_loss
            total = total + t_loss
        stats['mpjpc'] = P.mpjpc_stat(pose['kps'], setup.anchors, kp_idx,
                                      cfg.ext_scale)
    stats['total_loss'] = total
    return total, stats


def _state_on_device(cfg: Config, rc: RayCastConfig, step: int, device
                     ) -> Dict[str, Any]:
    """tau (and alpha) of the embedders at this step, as device scalars
    filled from host floats (no host-to-device copy).  The reference
    updates them at the end of each iteration, so step s renders with
    the schedule at max(s - 1, 0) (run_nerf.py:618, trainer.py:264-265)."""
    est = embed_state(cfg, rc, 0 if cfg.finetune else max(step - 1, 0))
    fill = lambda v: None if v is None else torch.full(
        (), float(v), dtype=torch.float32, device=device)
    return {'tau': fill(est['tau']), 'alpha': fill(est['alpha'])}


def _use_pose(cfg: Config, step: int) -> bool:
    """Pose refinement is on at this step: inside the warmup/stop
    window (reference trainer.py:240-241)."""
    return (cfg.opt_pose
            and not (cfg.opt_pose_stop is not None
                     and step >= cfg.opt_pose_stop)
            and step >= cfg.opt_pose_warmup)


def loss_and_grads(setup: TrainSetup, state, batch, generator=None):
    """The forward and backward of one step without the updates:
    returns (stats, NeRF gradients, pose gradients), the gradients as
    leaf lists in ``tree_leaves`` order (zeros where a leaf gets none,
    such as the frozen cutoff radii)."""
    cfg, rc = setup.cfg, setup.rc
    if batch['rays_o'].device != setup.device:
        raise ValueError(f'batch on {batch["rays_o"].device}, the step '
                         f'runs on {setup.device}')
    step = state['step']
    est = _state_on_device(cfg, rc, step, setup.device)
    nerf_leaves = tree_leaves(state['params'])
    pose_leaves = tree_leaves(state['pose_params'])
    leaves = nerf_leaves + pose_leaves
    for t in leaves:
        t.requires_grad_(True)
    try:
        pose, extras = get_batch_pose(setup, state['pose_params'], batch)
        out = render_rays(
            rc, state['params'], batch['rays_o'], batch['rays_d'],
            setup.near, setup.far, pose, est,
            cam_idxs=batch.get('cam_idxs') if cfg.opt_framecode else None,
            subject_idxs=batch.get('subject_idxs'), generator=generator)
        total, stats = compute_losses(setup, out, batch, pose, extras,
                                      state['pose_params'],
                                      float(_use_pose(cfg, step)))
        stats['alpha'] = out['acc_map'].mean()
        stats['tau'] = est['tau']
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    # detached, so holding the stats does not hold the step's graph
    stats = {k: v.detach() for k, v in stats.items()}
    return stats, grads[:len(nerf_leaves)], grads[len(nerf_leaves):]


@dataclasses.dataclass(frozen=True)
class StepGates:
    """What a step updates, decided on the host from the step alone:
    the NeRF Adam update (``nerf``), the pose Adam fire (``pose``), the
    pose gradient's accumulation (``accum``), and the schedule they
    came from (``ff``: None in the default mode)."""
    nerf: bool
    pose: bool
    accum: bool
    ff: Optional[FF.FlipFlopConfig] = None


def step_gates(cfg: Config, step: int) -> StepGates:
    """The gates of step ``step`` in the config's mode (anerf_tpu
    trainer.py:322-360).  Our step s is reference iteration s + 1
    (run_nerf.py:530-538 loops from 1), so the schedules read s + 1:
    the first pose fire comes after ``opt_pose_step`` gradients have
    accumulated (trainer.py:475-477)."""
    use_pose = _use_pose(cfg, step)
    if not cfg.opt_pose:
        return StepGates(nerf=True, pose=False, accum=False)
    if cfg.opt_pose_flipflop and not cfg.opt_pose_joint:
        # alternating NeRF-turn / pose-turn scheduler (reference
        # PoseOptFlipFlop, pose_opt.py:584-727)
        ff = FF.FlipFlopConfig(
            opt_pose_interval=cfg.opt_pose_interval,
            opt_pose_step=cfg.opt_pose_step, opt_pose_joint=False,
            opt_pose_warmup=cfg.opt_pose_warmup,
            opt_pose_stop=cfg.opt_pose_stop,
            opt_pose_reset=cfg.opt_pose_reset, testopt=cfg.testopt)
        nerf_g, pose_g = FF.update_gates(ff, step + 1)
        return StepGates(nerf=nerf_g, pose=pose_g and use_pose,
                         accum=FF.peek_pose_turn(ff, step + 1) and use_pose,
                         ff=ff)
    if cfg.opt_pose_joint or cfg.testopt:
        # joint mode (reference pose_opt.py:682-693): the gate's window
        # is warmup <= s + 1 <= stop, _use_pose's warmup <= s < stop
        ff = FF.FlipFlopConfig(
            opt_pose_step=cfg.opt_pose_step, opt_pose_joint=True,
            opt_pose_warmup=cfg.opt_pose_warmup,
            opt_pose_stop=cfg.opt_pose_stop, testopt=cfg.testopt)
        _, pose_g = FF.update_gates(ff, step + 1)
        return StepGates(nerf=True, pose=pose_g and use_pose,
                         accum=use_pose, ff=ff)
    return StepGates(nerf=True,
                     pose=use_pose and (step + 1) % cfg.opt_pose_step == 0,
                     accum=use_pose)


def make_train_step(setup: TrainSetup) -> Callable:
    """Build ``train_step(state, batch, generator) -> (state, stats)``.

    ``state`` comes from ``init_train_state`` (or ``interop``) and is
    updated in place: the parameters, moments and accumulator are
    overwritten rather than copied, which keeps one set of them in
    device memory; the same dict is returned.  ``batch`` holds tensors
    on ``setup.device``; ``generator`` draws the stratified jitter,
    the importance samples and the noise (None: no draws).  ``stats``
    are device tensors (the learning rate and the flipflop gates host
    floats): reading one waits for the step."""
    cfg = setup.cfg
    nerf_sched, pose_sched = _nerf_sched(cfg), _pose_sched(cfg)

    def train_step(state, batch, generator=None):
        step = state['step']
        gates = step_gates(cfg, step)
        stats, g_nerf, g_pose = loss_and_grads(setup, state, batch,
                                               generator)
        nerf_leaves = tree_leaves(state['params'])
        if cfg.opt_pose and cfg.testopt:
            # test-time pose optimization: the NeRF is frozen and only
            # the pose bank refines (reference PoseOptFlipFlop.testopt,
            # pose_opt.py:599,620-624); zero gradients keep the moments
            # at zero, so the network never moves
            g_nerf = [torch.zeros_like(g) for g in g_nerf]
        if cfg.finetune and cfg.fix_layer > 0:
            # freeze the first fix_layer trunk layers (reference
            # raycasters.py:215-217): zero gradients keep their moments
            # at zero, so they never move
            frozen = {id(t) for net in ('coarse', 'fine')
                      if state['params'].get(net) is not None
                      for lin in state['params'][net]['pts_linears']
                      [:cfg.fix_layer] for t in tree_leaves(lin)}
            g_nerf = [torch.zeros_like(g) if id(t) in frozen else g
                      for t, g in zip(nerf_leaves, g_nerf)]

        stats['total_norm'] = torch.sqrt(sum((g * g).sum() for g in g_nerf))
        stats['lrate'] = nerf_sched(step)
        if cfg.opt_pose_flipflop:
            stats['nerf_gate'] = float(gates.nerf)
            stats['pose_gate'] = float(gates.pose)
        # off the NeRF turn the update is skipped, Adam's count included
        # (anerf_tpu gates parameters and optimizer state alike)
        if gates.nerf:
            adam_update(nerf_leaves, g_nerf, state['opt_state'], nerf_sched)

        if cfg.opt_pose:
            kp_per_ray = stats.pop('kp_loss_per_ray', None)
            if cfg.opt_pose_flipflop and cfg.opt_pose_reset:
                # refresh the reset snapshot at pose-turn starts from
                # the PRE-update bank (set_poseopt_ckpt runs before the
                # iteration's step, pose_opt.py:700-703)
                state['pose_snapshot'] = FF.maybe_snapshot(
                    gates.ff, step + 1, state['pose_params'],
                    state['pose_snapshot'])
            accum = tree_leaves(state['pose_accum'])
            if gates.accum:
                torch._foreach_add_(accum, g_pose)
            if gates.pose:
                adam_update(tree_leaves(state['pose_params']), accum,
                            state['pose_opt_state'], pose_sched)
                torch._foreach_zero_(accum)
            if cfg.opt_pose_flipflop and kp_per_ray is not None:
                FF.accumulate_loss(state['kp_tracker'], kp_per_ray,
                                   batch['kp_idx'])
                stats['kp_tracker_mean'] = FF.get_trackers(
                    state['kp_tracker']).mean()
        state['step'] = step + 1
        return state, stats

    return train_step
