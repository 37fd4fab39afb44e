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

The host knows the step, so it computes the gates, the schedules and
Adam's bias corrections itself (``step_table``: one float32 row a
step); the step body reads its row as device scalars and applies each
gated update with ``torch.where``, which keeps the bits of a branch.
Nothing in the step reads a device value back, so the host queues the
next step while the device runs this one, and one body serves the
eager step and the bundled one.

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

``make_multi_train_step`` bundles k steps into one call (anerf_tpu's
``lax.scan`` of k steps): on the CPU and under gloo k runs of the step
body, on a GPU k replays of one CUDA graph of the step (``_GraphStep``),
the collectives of NCCL ranks captured in it.

Over several ranks (``TrainSetup.mesh``, ``parallel.sharding``) each
rank steps its block of the global batch and the step all-reduces what
XLA's partitioner reduces for anerf_tpu: the cylinder misses' mean
near/far, the masked-mean regularizer's count, the gradients of both
trees, the statistics and the FlipFlop trackers' increments.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..interop import params_to, tree_map
from ..models.factory import embed_state, init_raycaster_params
from ..models.raycaster import RayCastConfig, render_rays
from ..parallel.sharding import all_reduce_mean, require_one_host
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


def adam_scalars(sched: Callable[[int], float], count: int
                 ) -> Tuple[np.float32, np.float32, np.float32]:
    """(lr, bc1, bc2) of the Adam step that takes the optimizer's count
    from ``count`` to ``count + 1``, in float32 as optax computes them:
    lr = sched(count), bc = 1 - b^(count + 1)."""
    f32 = np.float32
    c = f32(count + 1)
    return (f32(sched(count)), f32(1) - f32(ADAM_B1) ** c,
            f32(1) - f32(ADAM_B2) ** c)


def _where_(gate: torch.Tensor, dst: List[torch.Tensor],
            src: List[torch.Tensor]) -> None:
    """dst = src where the 0-d bool ``gate`` holds, in place; the bits of
    ``if gate: dst.copy_(src)`` without reading the gate on the host."""
    for d, s in zip(dst, src):
        torch.where(gate, s, d, out=d)


@torch.no_grad()
def _adam_apply(params: List[torch.Tensor], grads: List[torch.Tensor],
                opt_state: Dict[str, Any], lr, bc1, bc2,
                gate: Optional[torch.Tensor] = None) -> None:
    """optax's Adam step on leaf lists, in place (params and moments; the
    count is the caller's): mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2
    nu, p += -lr (mu / bc1) / (sqrt(nu / bc2) + eps).  ``lr``, ``bc1``,
    ``bc2``: floats or 0-d float32 tensors (the same bits).  With a 0-d
    bool ``gate`` the parameters and moments change only where it
    holds."""
    mu, nu = tree_leaves(opt_state['mu']), tree_leaves(opt_state['nu'])
    new_mu = torch._foreach_mul(grads, 1 - ADAM_B1)
    torch._foreach_add_(new_mu, torch._foreach_mul(mu, ADAM_B1))
    new_nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - ADAM_B2)
    torch._foreach_add_(new_nu, torch._foreach_mul(nu, ADAM_B2))
    den = torch._foreach_sqrt(torch._foreach_div(new_nu, bc2))
    torch._foreach_add_(den, ADAM_EPS)
    upd = torch._foreach_div(new_mu, bc1)
    torch._foreach_div_(upd, den)
    torch._foreach_mul_(upd, lr)
    if gate is None:
        torch._foreach_sub_(params, upd)
        torch._foreach_copy_(mu, new_mu)
        torch._foreach_copy_(nu, new_nu)
    else:
        _where_(gate, params + mu + nu,
                torch._foreach_sub(params, upd) + new_mu + new_nu)


def adam_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                opt_state: Dict[str, Any], sched: Callable[[int], float]
                ) -> None:
    """One step of optax's ``scale_by_adam`` -> ``scale_by_schedule`` ->
    ``scale(-1)`` -> ``apply_updates`` on leaf lists, in place (params,
    moments and count), the schedule fed the optimizer's own count."""
    lr, bc1, bc2 = adam_scalars(sched, opt_state['count'])
    _adam_apply(params, grads, opt_state, float(lr), float(bc1), float(bc2))
    opt_state['count'] += 1


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
    construction.  ``mesh`` (a ``parallel.sharding.RayMesh``): the ray
    group whose ranks step the other blocks of each global batch;
    None, one process."""
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
    mesh: Any = None

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

    @property
    def group(self):
        """The ray group's process group (None: no collectives)."""
        return None if self.mesh is None else self.mesh.group

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
    """The full loss stack (reference trainer.py:319-441).

    Over several ranks every term is this rank's share of the global
    batch's loss, so that the mean of the ranks' terms is the global
    term and the mean of their gradients its gradient: the photometric
    loss is a mean over (rays, channels), ``kp_reg_loss`` over (rays,
    joints) and the temporal loss over (rays, joints), each over equal
    blocks; the regularizer's mean over the off-foreground pixels is
    rescaled to the global count (``_masked_share``).  ``psnr`` is then
    taken from the reduced MSE (stats ``_mse``, ``_mse0``; ``_step_body``)."""
    cfg = setup.cfg
    group = setup.group
    loss_fn = L.get_loss_fn(cfg.loss_fn, cfg.loss_beta, cfg.use_yuv)
    reg_fn = L.get_reg_fn(cfg.reg_fn)
    bgs = batch.get('bgs', 1.0)
    stats: Dict[str, torch.Tensor] = {}
    total = 0.
    share = (_masked_share(setup.mesh, batch['fgs'][..., 0])
             if reg_fn is not None and group is not None else None)

    def nerf_loss(rgb_pred, acc_pred, coarse):
        nonlocal total
        rgb = rgb_pred
        if cfg.use_background:
            rgb = rgb + (1. - acc_pred)[..., None] * bgs
        rl = loss_fn(rgb, batch['target_s'])
        if coarse:
            rl = rl * cfg.coarse_weight
        if group is None:
            stats['psnr0' if coarse else 'psnr'] = L.img2psnr(
                rgb.detach(), batch['target_s'])
        else:
            stats['_mse0' if coarse else '_mse'] = L.img2mse(
                rgb.detach(), batch['target_s'])
        stats['rgb_loss0' if coarse else 'rgb_loss'] = rl
        total = total + rl
        if reg_fn is not None:
            reg = reg_fn(acc_pred, batch['fgs'][..., 0],
                         reduction='off') * cfg.reg_coef
            if share is not None:
                reg = reg * share
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


def _masked_share(mesh, y: torch.Tensor) -> torch.Tensor:
    """The factor that turns this rank's regularizer, a mean over its
    pixels off the foreground (``losses._masked_mean``: y < 1), into its
    share of the global batch's: P max(c, 1) / max(C, 1), with c this
    rank's count and C the ranks' total.  (A rank with c = 0 has a zero
    sum, so its max(c, 1) changes nothing.)  Data only: no gradient
    flows through it."""
    c = (y < 1.0).to(y.dtype).sum()
    total = c.clone()
    dist.all_reduce(total, group=mesh.group)
    return mesh.size * torch.clamp(c, min=1.) / torch.clamp(total, min=1.)


def reduce_stats(mesh, stats: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """The ranks' mean of every scalar statistic (one buffer), then
    ``psnr``/``psnr0`` from the mean MSE: the global batch's values.
    tau, the same on every rank, stays as it is."""
    keys = sorted(k for k, v in stats.items() if v.dim() == 0 and k != 'tau')
    stats = dict(stats)
    stats.update(zip(keys, all_reduce_mean(mesh, [stats[k] for k in keys])))
    for tag in ('', '0'):
        if '_mse' + tag in stats:
            stats['psnr' + tag] = L.mse2psnr(stats.pop('_mse' + tag))
    return stats


def _use_pose(cfg: Config, step: int) -> bool:
    """Pose refinement is on at this step: inside the warmup/stop
    window (reference trainer.py:240-241)."""
    return (cfg.opt_pose
            and not (cfg.opt_pose_stop is not None
                     and step >= cfg.opt_pose_stop)
            and step >= cfg.opt_pose_warmup)


def loss_and_grads(setup: TrainSetup, state, batch, generator=None,
                   values: Optional[Dict[str, torch.Tensor]] = None):
    """The forward and backward of one step without the updates:
    returns (stats, NeRF gradients, pose gradients), the gradients as
    leaf lists in ``tree_leaves`` order (zeros where a leaf gets none,
    such as the frozen cutoff radii).  ``values``: the step's row of
    ``step_table`` as device scalars (``row_values``); by default that
    of ``state['step']``."""
    cfg, rc = setup.cfg, setup.rc
    if batch['rays_o'].device != setup.device:
        raise ValueError(f'batch on {batch["rays_o"].device}, the step '
                         f'runs on {setup.device}')
    if values is None:
        values = row_values(
            rows_on(step_table(setup, state, 1), setup.device)[0])
    est = {'tau': values['tau'],
           'alpha': values['alpha'] if cfg.freq_schedule else None}
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
            subject_idxs=batch.get('subject_idxs'), generator=generator,
            group=setup.group)
        total, stats = compute_losses(setup, out, batch, pose, extras,
                                      state['pose_params'],
                                      values['use_pose'])
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


# The host's values of one step, a float32 row each (``step_table``):
# the embedders' schedule, the kp losses' switch, the NeRF learning rate
# of the step (a stat), each gate (1 or 0) and each Adam step's learning
# rate and bias corrections at the count it would take.
ROW = ('tau', 'alpha', 'use_pose', 'lrate', 'nerf_gate', 'nerf_lr',
       'nerf_bc1', 'nerf_bc2', 'accum_gate', 'pose_gate', 'pose_lr',
       'pose_bc1', 'pose_bc2', 'snapshot_gate')
_COL = {k: i for i, k in enumerate(ROW)}


def step_table(setup: TrainSetup, state, steps: int) -> np.ndarray:
    """The rows (``steps``, len(ROW)) of steps ``state['step']`` to
    ``state['step'] + steps - 1``, from the host's schedules and gates
    alone: each Adam's count advances by its gate, row by row.  The
    reference updates tau and alpha at the end of each iteration, so
    step s renders with their schedule at max(s - 1, 0) (run_nerf.py:618,
    trainer.py:264-265)."""
    cfg, rc = setup.cfg, setup.rc
    nerf_sched, pose_sched = _nerf_sched(cfg), _pose_sched(cfg)
    nerf_count = state['opt_state']['count']
    pose_count = (state['pose_opt_state'] or {}).get('count', 0)
    reset = cfg.opt_pose and cfg.opt_pose_flipflop and cfg.opt_pose_reset
    rows = np.zeros((steps, len(ROW)), np.float32)
    for j in range(steps):
        s = state['step'] + j
        g = step_gates(cfg, s)
        est = embed_state(cfg, rc, 0 if cfg.finetune else max(s - 1, 0))
        nerf_lr, nerf_bc1, nerf_bc2 = adam_scalars(nerf_sched, nerf_count)
        pose_lr, pose_bc1, pose_bc2 = adam_scalars(pose_sched, pose_count)
        vals = dict(
            tau=float(est['tau']),
            alpha=0. if est['alpha'] is None else float(est['alpha']),
            use_pose=_use_pose(cfg, s), lrate=nerf_sched(s),
            nerf_gate=g.nerf, nerf_lr=nerf_lr, nerf_bc1=nerf_bc1,
            nerf_bc2=nerf_bc2, accum_gate=g.accum, pose_gate=g.pose,
            pose_lr=pose_lr, pose_bc1=pose_bc1, pose_bc2=pose_bc2,
            snapshot_gate=reset and FF.snapshot_gate(g.ff, s + 1))
        rows[j] = [vals[k] for k in ROW]
        nerf_count += g.nerf
        pose_count += g.pose
    return rows


def rows_on(rows: np.ndarray, device) -> torch.Tensor:
    """``step_table``'s rows on ``device`` without a host wait for the
    stream: on a GPU through pinned memory, copied asynchronously (the
    pinned block is not reused before the copy is done)."""
    t = torch.from_numpy(rows)
    if torch.device(device).type != 'cuda':
        return t
    return t.pin_memory().to(device, non_blocking=True)


def row_values(row: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One row on the device as named 0-d views (a graph's static row
    keeps feeding them)."""
    return dict(zip(ROW, row.unbind(0)))


def _advance(state, rows: np.ndarray) -> None:
    """The host's counters after the steps of ``rows``: the step, and
    each Adam count by its gate's fires."""
    state['step'] += len(rows)
    state['opt_state']['count'] += int(rows[:, _COL['nerf_gate']].sum())
    if state['pose_opt_state'] is not None:
        state['pose_opt_state']['count'] += int(
            rows[:, _COL['pose_gate']].sum())


def _step_body(setup: TrainSetup, state, batch, row: torch.Tensor,
               generator) -> Dict[str, torch.Tensor]:
    """One train step from the device values of ``row`` alone: renders,
    takes the gradients and updates the parameters, moments, pose
    accumulator, pose bank, snapshot and trackers in place.  It reads
    and writes no host counter (``_advance`` does) and rebinds no entry
    of ``state`` (except a missing reset snapshot, made on the first
    step), so a CUDA graph of it replays any step.  Returns the stats."""
    cfg = setup.cfg
    v = row_values(row)
    stats, g_nerf, g_pose = loss_and_grads(setup, state, batch, generator,
                                           v)
    if setup.group is not None:
        # each rank's loss is its share of the global one (compute_losses)
        # over equal blocks, so the global gradient is the ranks' mean
        g_nerf = all_reduce_mean(setup.mesh, g_nerf)
        if g_pose:
            g_pose = all_reduce_mean(setup.mesh, g_pose)
        stats = reduce_stats(setup.mesh, stats)
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
    stats['lrate'] = v['lrate']
    if cfg.opt_pose_flipflop:
        stats['nerf_gate'] = v['nerf_gate']
        stats['pose_gate'] = v['pose_gate']
    # off the NeRF turn (the alternating mode) the update is skipped,
    # Adam's count included (anerf_tpu gates parameters and optimizer
    # state alike); in the other modes the NeRF steps every iteration
    alternating = cfg.opt_pose and cfg.opt_pose_flipflop \
        and not cfg.opt_pose_joint
    _adam_apply(nerf_leaves, g_nerf, state['opt_state'], v['nerf_lr'],
                v['nerf_bc1'], v['nerf_bc2'],
                gate=v['nerf_gate'] > 0 if alternating else None)

    if cfg.opt_pose:
        kp_per_ray = stats.pop('kp_loss_per_ray', None)
        pose = tree_leaves(state['pose_params'])
        if cfg.opt_pose_flipflop and cfg.opt_pose_reset:
            # refresh the reset snapshot at pose-turn starts from the
            # PRE-update bank (set_poseopt_ckpt runs before the
            # iteration's step, pose_opt.py:700-703)
            if state.get('pose_snapshot') is None:
                state['pose_snapshot'] = FF.clone_tree(state['pose_params'])
            else:
                _where_(v['snapshot_gate'] > 0,
                        tree_leaves(state['pose_snapshot']), pose)
        accum = tree_leaves(state['pose_accum'])
        _where_(v['accum_gate'] > 0, accum, torch._foreach_add(accum, g_pose))
        fire = v['pose_gate'] > 0
        _adam_apply(pose, accum, state['pose_opt_state'], v['pose_lr'],
                    v['pose_bc1'], v['pose_bc2'], gate=fire)
        for a in accum:
            a.masked_fill_(fire, 0.)
        if cfg.opt_pose_flipflop and kp_per_ray is not None:
            FF.accumulate_loss(state['kp_tracker'], kp_per_ray,
                               batch['kp_idx'], group=setup.group)
            stats['kp_tracker_mean'] = FF.get_trackers(
                state['kp_tracker']).mean()
    return stats


def make_train_step(setup: TrainSetup) -> Callable:
    """Build ``train_step(state, batch, generator) -> (state, stats)``.

    ``state`` comes from ``init_train_state`` (or ``interop``) and is
    updated in place: the parameters, moments and accumulator are
    overwritten rather than copied, which keeps one set of them in
    device memory; the same dict is returned.  ``batch`` holds tensors
    on ``setup.device``; ``generator`` draws the stratified jitter,
    the importance samples and the noise (None: no draws).  ``stats``
    are device tensors: reading one waits for the step."""

    def train_step(state, batch, generator=None):
        rows = step_table(setup, state, 1)
        stats = _step_body(setup, state, batch,
                           rows_on(rows, setup.device)[0], generator)
        _advance(state, rows)
        return state, stats

    return train_step


def _state_tensors(state) -> List[torch.Tensor]:
    return [t for k in sorted(state) if isinstance(state[k], (dict, list))
            for t in tree_leaves(state[k]) if torch.is_tensor(t)]


class _GraphStep:
    """The train step captured once in a CUDA graph, replayed once a
    step.

    A call first warms up if the state's tensors, the batch's shapes or
    the generator differ from those of the last capture: the call's
    first ``WARMUP`` steps run eagerly on a side stream (building the
    kernels' libraries and cached tensors and any missing state entry),
    then one step is captured on static inputs (one batch, one row) and
    the generator registered with the graph, so that every replay draws
    on from the generator's current offset.  Each further step copies
    its batch and row into the static inputs and replays.  A failed
    capture raises; nothing replays eager steps in its place.  The
    kernels' launch counters advance at capture only (the wrappers'
    Python runs then); a replay launches without them.

    Over NCCL ranks the graph holds the step's collectives.  The
    warm-up runs them first, on every capture: NCCL makes its
    communicator at a group's first collective, which a capture cannot
    hold, and every rank warms up and captures at the same steps, as
    their keys change together."""

    WARMUP = 2

    def __init__(self, setup: TrainSetup):
        self.setup = setup
        self.key = None
        self.graph = None

    def _capture(self, state, batches, rows, generator):
        self.graph = self.stats = None
        self.batch = {k: v[0].clone() for k, v in batches.items()}
        self.row = rows[0].clone()
        self.generator = generator
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before = [t.data_ptr() for t in _state_tensors(state)]
        with torch.cuda.graph(graph):
            stats = _step_body(self.setup, state, self.batch, self.row,
                               generator)
        if [t.data_ptr() for t in _state_tensors(state)] != before:
            raise RuntimeError('the train step rebound a state tensor '
                               'while it was captured')
        self.graph, self.stats = graph, stats

    def __call__(self, state, batches, rows, generator):
        dev = self.setup.device
        key = ([t.data_ptr() for t in _state_tensors(state)],
               [(k, v.shape, v.dtype) for k, v in sorted(batches.items())],
               id(generator))
        start, stats = 0, None
        if key != self.key:
            start = min(self.WARMUP, len(rows))
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for j in range(start):
                    stats = _step_body(self.setup, state,
                                       {k: v[j] for k, v in batches.items()},
                                       rows[j], generator)
            torch.cuda.current_stream(dev).wait_stream(side)
            self._capture(state, batches, rows, generator)
            self.key = ([t.data_ptr() for t in _state_tensors(state)],
                        key[1], key[2])
        for j in range(start, len(rows)):
            for k, t in self.batch.items():
                t.copy_(batches[k][j])
            self.row.copy_(rows[j])
            self.graph.replay()
        if start < len(rows):
            # the graph's outputs are overwritten by its next replay
            stats = {k: t.clone() for k, t in self.stats.items()}
        return stats


def _stacked_on(batches, device, steps: int) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batches.items():
        if not torch.is_tensor(v):
            v = np.asarray(v)
            v = torch.as_tensor(v, dtype=torch.long if np.issubdtype(
                v.dtype, np.integer) else torch.float32)
        if v.shape[0] != steps:
            raise ValueError(f'batch {k!r} stacks {v.shape[0]} steps, '
                             f'the bundle takes {steps}')
        out[k] = v.to(device)
    return out


def make_multi_train_step(setup: TrainSetup, steps: int) -> Callable:
    """Bundle ``steps`` train steps into one call (anerf_tpu's
    ``make_multi_train_step``, a ``lax.scan`` of its train step; the
    ``run_train --steps_per_dispatch`` path).

    ``multi_step(state, batches, generator) -> (state, stats)`` takes
    the batches stacked on a leading ``steps`` axis (``stack_batches``;
    numpy, or tensors on ``setup.device`` to spare the host a wait for
    the copy) and returns the state after the ``steps`` steps, updated
    in place as by ``make_train_step``'s step, and the LAST step's
    stats.  The result is that of ``steps`` calls of the train step: on
    the CPU it is those calls' body; on a GPU one captured CUDA graph of
    the step replayed once a step (``_GraphStep``), the host's work per
    step two small copies and a replay.

    Over several ranks (``setup.mesh``; ``parallel.sharding.
    shard_train_step(..., stacked=True)`` shards the batches) the graph
    captures the step's collectives, which NCCL allows; a group of
    another backend (gloo) cannot be captured, so there the bundle is
    the steps' body run in turn, as on the CPU.  The ranks must share
    one host (torchrun's ``LOCAL_WORLD_SIZE`` equal to the world size),
    as anerf_tpu bundles only on one host; past that it raises."""
    if steps < 1:
        raise ValueError(f'steps_per_dispatch {steps} < 1')
    require_one_host(setup.mesh, steps)
    capture = setup.device.type == 'cuda' and (
        setup.group is None or dist.get_backend(setup.group) == 'nccl')
    graph = _GraphStep(setup) if capture else None

    def multi_step(state, batches, generator=None):
        rows = step_table(setup, state, steps)
        dev_rows = rows_on(rows, setup.device)
        batches = _stacked_on(batches, setup.device, steps)
        if graph is not None:
            stats = graph(state, batches, dev_rows, generator)
        else:
            for j in range(steps):
                stats = _step_body(setup, state,
                                   {k: v[j] for k, v in batches.items()},
                                   dev_rows[j], generator)
        _advance(state, rows)
        return state, stats

    return multi_step


def stack_batches(batches: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Stack per-step batch dicts on a new leading axis for
    ``make_multi_train_step``, in host numpy (the stacked bundle is what
    goes to the device)."""
    return {k: np.stack([np.asarray(b[k]) for b in batches], 0)
            for k in batches[0]}
