"""Photometric losses and learning-rate schedules.

Port of ``anerf_tpu/training/losses.py`` (reference core/trainer.py:8-62
loss functions, :147-170 loss/reg factories, :173-183 the exponential
lr decay with integer-division step units).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch


def mse2psnr(x):
    return -10. * torch.log(x) / math.log(10.)


def rgb_to_yuv(rgb: torch.Tensor) -> torch.Tensor:
    m = torch.tensor([[0.299, 0.587, 0.114],
                      [-0.14713, -0.28886, 0.436],
                      [0.615, -0.51499, -0.10001]], dtype=rgb.dtype,
                     device=rgb.device)
    return rgb @ m.T


def _abs(d: torch.Tensor) -> torch.Tensor:
    """|d| with JAX's gradient at 0 (+1; torch.abs gives 0 there), so a
    prediction that hits its target exactly gets anerf_tpu's gradient."""
    return torch.where(d >= 0, d, -d)


def _reduce(d: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == 'mean':
        return d.mean()
    if reduction == 'sum':
        return d.sum()
    return d


def _yuv_scale(d: torch.Tensor, scale_yuv) -> torch.Tensor:
    return d * torch.tensor(scale_yuv, dtype=d.dtype, device=d.device)


def img2mse(x, y, reduction='mean', to_yuv=False, scale_yuv=(0.1, 1.0, 1.0)):
    if to_yuv:
        x, y = rgb_to_yuv(x), rgb_to_yuv(y)
        return _reduce(_yuv_scale((x - y) ** 2, scale_yuv), reduction)
    return _reduce((x - y) ** 2, reduction)


def img2l1(x, y, reduction='mean', to_yuv=False, scale_yuv=(0.1, 1.0, 1.0)):
    if to_yuv:
        x, y = rgb_to_yuv(x), rgb_to_yuv(y)
        return _reduce(_yuv_scale(_abs(x - y), scale_yuv), reduction)
    return _reduce(_abs(x - y), reduction)


def img2huber(x, y, reduction='mean', beta=0.1):
    d = _abs(x - y)
    return _reduce(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta),
                   reduction)


def _masked_mean(loss: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    mask = (y < 1.0).to(loss.dtype)
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.)


def acc2bce(x, y, reduction='mean', eps=1e-8):
    """Binary cross-entropy of the accumulated opacity against the
    foreground mask; ``reduction='off'`` averages over the pixels off
    the foreground only (reference trainer.py:44-54).  The complement
    is ``max(1 - x, 0) + eps``, as in anerf_tpu: the plain ``1 - x +
    eps`` folds to ``(1 + eps) - x`` under a compiler, and in f32
    ``1 + 1e-8 == 1``, so an opaque ray would take ``log(0)``.  The
    max is written ``(a + |a|) / 2``: the same value, and at the tie
    a = 0 the half gradient that JAX's ``maximum`` gives there."""
    a = 1. - x
    bce = -(y * torch.log(x + eps)
            + (1. - y) * torch.log(0.5 * (a + a.abs()) + eps))
    if reduction == 'off':
        return _masked_mean(bce, y)
    return _reduce(bce, reduction)


def img2psnr(img, target):
    return mse2psnr(img2mse(img, target))


def get_loss_fn(name: str, beta: float = 0.1,
                use_yuv: bool = False) -> Callable:
    if name == 'MSE':
        return lambda x, y, reduction='mean': img2mse(x, y, reduction,
                                                      to_yuv=use_yuv)
    if name == 'L1':
        return lambda x, y, reduction='mean': img2l1(x, y, reduction,
                                                     to_yuv=use_yuv)
    if name == 'Huber':
        return lambda x, y, reduction='mean': img2huber(x, y, reduction, beta)
    raise NotImplementedError(f'loss {name} not implemented')


def get_reg_fn(name: Optional[str]) -> Optional[Callable]:
    if name is None:
        return None
    if name == 'L1':
        return lambda x, y, reduction='off': (
            _masked_mean(_abs(x - y), y) if reduction == 'off'
            else img2l1(x, y, reduction))
    if name == 'MSE':
        return lambda x, y, reduction='off': (
            _masked_mean((x - y) ** 2, y) if reduction == 'off'
            else img2mse(x, y, reduction))
    if name == 'BCE':
        return acc2bce
    raise NotImplementedError(f'reg {name} not implemented')


def nerf_lr_schedule(lrate: float, lrate_decay: int, decay_rate: float,
                     decay_unit: int = 1000) -> Callable[[int], float]:
    """``lrate * decay_rate^((step // decay_unit) / lrate_decay)``: the
    reference's piecewise-constant exponential decay (trainer.py:173-183,
    note the integer division).  The step is a host int; the arithmetic
    is float32, as anerf_tpu's."""
    f = np.float32

    def sched(step: int) -> float:
        u = f(step // decay_unit)
        return float(f(lrate) * f(decay_rate) ** (u / f(lrate_decay)))
    return sched


def pose_lr_schedule(lrate: float, lrate_decay: int, decay_rate: float,
                     decay_unit: int, opt_pose_step: int
                     ) -> Callable[[int], float]:
    """The pose optimizer's decay (reference pose_opt.py:562-571): a
    continuous exponent over its own step count / opt_pose_step."""
    f = np.float32

    def sched(step: int) -> float:
        pose_steps = f(step) / f(opt_pose_step)
        return float(f(lrate) * f(decay_rate) ** (
            pose_steps / f(lrate_decay * decay_unit)))
    return sched
