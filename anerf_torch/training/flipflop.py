"""Alternating NeRF / pose optimization (FlipFlop) scheduler.

Port of ``anerf_tpu/training/flipflop.py`` (reference ``PoseOptFlipFlop``,
core/pose_opt.py:584-727, and ``update_pose_opt_params``,
pose_opt.py:560-582).  The schedule is a function of the step the host
already knows, so the gates are plain Python on ints and read no device
value; the per-frame loss trackers and the pose-bank snapshot are
tensors on the device, updated in place.

Semantics (pose_opt.py:676-727):
  * ``opt_pose_joint``: NeRF steps every iteration, pose every
    ``opt_pose_step``;
  * alternating mode: the turn flips every ``opt_pose_interval`` steps;
    on the iteration the turn flips nerf->pose the NeRF still takes one
    last update (the "just turned" rule, pose_opt.py:712-715); pose
    updates fire on the pose turn every ``opt_pose_step`` iterations;
  * ``peek_pose_turn`` gates the turn by warmup/stop (pose_opt.py:625-630);
  * per-frame cumulative-moving-average loss trackers, initialized at
    10 so frames not yet seen are not favored (pose_opt.py:632-662);
  * ``opt_pose_reset``: the pose bank is snapshot when a pose turn
    starts so that it can be restored (pose_opt.py:603-605,663-666).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..interop import tree_map


@dataclasses.dataclass(frozen=True)
class FlipFlopConfig:
    opt_pose_interval: int = 100   # steps between turn flips
    opt_pose_step: int = 1         # pose update cadence within a pose turn
    opt_pose_joint: bool = False   # both nets each step (tracker-only mode)
    opt_pose_warmup: int = 0
    opt_pose_stop: Optional[int] = None
    opt_pose_reset: bool = False   # snapshot pose bank at pose-turn start
    testopt: bool = False          # freeze NeRF entirely (test-time popt)


def init_tracker_state(n_kps: int, device='cpu') -> Dict[str, torch.Tensor]:
    """CMA loss trackers (reference reset_kp_loss_tracker,
    pose_opt.py:632-636)."""
    return {'kp_loss_tracker': torch.full((n_kps,), 10., device=device),
            'kp_loss_cnt': torch.zeros((n_kps,), device=device)}


@torch.no_grad()
def accumulate_loss(tracker: Dict[str, torch.Tensor], loss: torch.Tensor,
                    kp_idx: torch.Tensor, group=None
                    ) -> Dict[str, torch.Tensor]:
    """Scatter-add per-frame losses into the CMA trackers, in place
    (reference accumulate_loss, pose_opt.py:638-662).  With a process
    ``group`` whose ranks hold the other blocks of the batch, the
    per-frame sums and counts are all-reduced before the update: the
    global batch's."""
    loss = loss.reshape(-1).float()
    kp_idx = kp_idx.reshape(-1).long()
    cma, cnt = tracker['kp_loss_tracker'], tracker['kp_loss_cnt']
    acc = torch.zeros_like(cma).index_add_(0, kp_idx, loss)
    inc = torch.zeros_like(cnt).index_add_(0, kp_idx, torch.ones_like(loss))
    if group is not None:
        both = torch.stack([acc, inc])
        dist.all_reduce(both, group=group)
        acc, inc = both
    cnt.add_(inc)       # whole numbers: the bits of an index_add_ into cnt
    cma.add_((acc - cma) / torch.clamp(cnt, min=1.))
    return tracker


def get_trackers(tracker: Dict[str, torch.Tensor],
                 idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-frame mean loss (reference get_trackers, pose_opt.py:673-680)."""
    out = tracker['kp_loss_tracker'] / torch.clamp(tracker['kp_loss_cnt'],
                                                   min=1.)
    return out if idx is None else out[idx]


def pose_turn(ff: FlipFlopConfig, step: int) -> bool:
    """Whether ``step`` is inside a pose turn (before warmup/stop gating).

    The reference initializes ``pose_turn=False`` (pose_opt.py:596) but
    flips it on the very first iteration (0 % interval == 0,
    pose_opt.py:697-700), so even blocks of ``opt_pose_interval`` steps
    are pose turns.
    """
    if ff.opt_pose_joint:
        return True
    return (step // ff.opt_pose_interval) % 2 == 0


def just_turned(ff: FlipFlopConfig, step: int) -> bool:
    return step % ff.opt_pose_interval == 0


def peek_pose_turn(ff: FlipFlopConfig, step: int) -> bool:
    """Turn gated by warmup/stop (reference peek_pose_turn,
    pose_opt.py:625-630)."""
    turn = pose_turn(ff, step)
    if ff.opt_pose_stop is not None:
        turn = turn and step <= ff.opt_pose_stop
    return turn and step >= ff.opt_pose_warmup


def update_gates(ff: FlipFlopConfig, step: int) -> Tuple[bool, bool]:
    """(nerf_gate, pose_gate) for this step.

    Encodes the reference's step() control flow (pose_opt.py:682-727):
    joint: NeRF every iteration, pose every opt_pose_step; alternating
    (pose_opt.py:712-727): NeRF updates when ``turn == just_turned``,
    i.e. through its own turn plus one last update on the first
    iteration of a pose turn; otherwise the pose optimizer fires every
    ``opt_pose_step`` iterations, which includes the first iteration
    back on the NeRF turn (flushing the accumulated pose gradients).
    """
    kth = step % ff.opt_pose_step == 0
    if ff.opt_pose_joint:
        nerf_g, pose_g = True, kth
    else:
        nerf_g = pose_turn(ff, step) == just_turned(ff, step)
        pose_g = (not nerf_g) and kth
    if ff.testopt:
        nerf_g = False
    # warmup / stop window on the pose side
    window = step >= ff.opt_pose_warmup
    if ff.opt_pose_stop is not None:
        window = window and step <= ff.opt_pose_stop
    return nerf_g, pose_g and window


def snapshot_gate(ff: FlipFlopConfig, step: int) -> bool:
    """True on the first iteration of a pose turn, when the reference
    snapshots the pose bank for a possible reset (pose_opt.py:700-703)."""
    if ff.opt_pose_joint or not ff.opt_pose_reset:
        return False
    return pose_turn(ff, step) and just_turned(ff, step)


def clone_tree(tree: Any) -> Any:
    """A copy of every tensor leaf (a real copy: the snapshot and the
    live bank never share storage)."""
    return tree_map(lambda t: t.detach().clone(), tree)


@torch.no_grad()
def reset_poseopt(pose_params: Any, snapshot: Any) -> Any:
    """Restore the pose bank from the snapshot, in place (reference
    reset_poseopt, pose_opt.py:603-605); copies, so the bank and the
    snapshot never alias."""
    for k in pose_params:
        pose_params[k].copy_(snapshot[k])
    return pose_params


def anneal_pose_reg(opt_pose_coef: float, step: int,
                    reg_step: Optional[int], reg_rate: float = 5.) -> float:
    """Pose-regularization coefficient annealing (reference
    update_pose_opt_params, pose_opt.py:560-582): every ``reg_step``
    optimizer steps the coefficient multiplies by ``reg_rate``."""
    if reg_step is None:
        return float(opt_pose_coef)
    return opt_pose_coef * reg_rate ** float(step // reg_step)
