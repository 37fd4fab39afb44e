"""Positional encoding: plain NeRF PE and A-NeRF's cutoff-windowed PE.

Port of ``anerf_tpu/ops/embedding.py`` (reference
core/cutoff_embedder.py).  tau and the schedule alpha are explicit
arguments rather than module buffers.

Layout (as in the JAX package): frequencies stack as (..., 2F, C) with
per-band order [sin f0, cos f0, sin f1, cos f1, ...]; the raw input row
is prepended; the window ``w`` multiplies everything (``cutoff_inputs``)
or the frequency rows only; the output is the row-major flatten of
(..., 1+2F, C).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EmbedConfig:
    """Static embedder configuration."""
    input_dims: int                    # C: feature channels being encoded
    num_freqs: int                     # F (== multires)
    include_input: bool = True
    log_sampling: bool = True
    cutoff: bool = False               # enable cutoff windowing
    dist_inputs: bool = False          # C == n_joints * D; dists are (J,)
    cutoff_inputs: bool = False        # window the raw-input row too
    cut_to_cutoff: bool = False        # x <- cutoff - x    (cut_to_dist)
    shift_inputs: bool = False         # x <- 2x/cutoff - 1 (cutoff_shift)
    normalize: bool = False            # not ported (ROADMAP.md)
    freq_schedule: bool = False        # BARF-style coarse-to-fine
    init_alpha: float = 0.
    cutoff_dim: int = 24               # J: number of joints (window count)
    init_tau: float = 20.0

    @property
    def out_dim(self) -> int:
        d = 2 * self.num_freqs * self.input_dims
        if self.include_input:
            d += self.input_dims
        return d

    def freq_bands(self) -> np.ndarray:
        if self.num_freqs == 0:
            return np.zeros((0,), dtype=np.float32)
        if self.log_sampling:
            return (2.0 ** np.linspace(0., self.num_freqs - 1,
                                       self.num_freqs)).astype(np.float32)
        return np.linspace(2. ** 0., 2. ** (self.num_freqs - 1),
                           self.num_freqs).astype(np.float32)

    def freq_k(self) -> np.ndarray:
        """log2 of freq bands duplicated per sin/cos row: (2F,)."""
        return np.repeat(np.log2(self.freq_bands()), 2)


@functools.lru_cache(maxsize=None)
def _band_tensor(cfg: EmbedConfig, which: str, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """``cfg.freq_bands()`` or ``cfg.freq_k()`` on ``device``, built once:
    a host-to-device copy waits for the stream to drain, so a copy per
    call would idle the GPU between chunks.  Built outside inference
    mode, so that a renderer's first call leaves a tensor that autograd
    may save later."""
    with torch.inference_mode(False):
        return torch.as_tensor(getattr(cfg, which)(), dtype=dtype,
                               device=device)


def tau_schedule(cfg: EmbedConfig, global_step, cutoff_step: float,
                 cutoff_rate: float) -> torch.Tensor:
    """tau annealing ``init_tau * rate^(step / (step_k*1000))`` clamped
    at 2000 (reference cutoff_embedder.py:181-183).  0-d f32 tensor."""
    step = torch.as_tensor(global_step, dtype=torch.float32)
    tau = cfg.init_tau * cutoff_rate ** (step / float(cutoff_step * 1000))
    return torch.clamp(tau, max=2000.)


def alpha_schedule(cfg: EmbedConfig, global_step, alpha_step: float,
                   target: Optional[float] = None) -> torch.Tensor:
    """BARF frequency-schedule alpha (reference
    cutoff_embedder.py:185-190)."""
    if target is None:
        target = float(np.max(cfg.freq_k())) if cfg.num_freqs > 0 else 0.
    step = torch.as_tensor(global_step, dtype=torch.float32)
    return cfg.init_alpha + (target - cfg.init_alpha) * step / float(
        alpha_step * 1000)


def _schedule_w(cfg: EmbedConfig, alpha, like: torch.Tensor
                ) -> torch.Tensor:
    """Per-band coarse-to-fine weight (2F, 1)
    (reference cutoff_embedder.py:192-197)."""
    k = _band_tensor(cfg, 'freq_k', like.dtype, like.device)
    diff = torch.clamp(alpha - k, 0., 1.)
    return (0.5 * (1. - torch.cos(np.pi * diff)))[:, None]


def embed(inputs: torch.Tensor,
          cfg: EmbedConfig,
          dists: Optional[torch.Tensor] = None,
          cutoff_dist: Optional[torch.Tensor] = None,
          tau=None,
          alpha=None,
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Encode ``inputs`` (..., C) -> (..., out_dim).

    For cutoff embedders ``dists`` (..., J) are per-joint distances,
    ``cutoff_dist`` (J,) the window radii and ``tau`` the window
    sharpness.  Per-ray inputs (a singleton sample axis) broadcast
    against per-sample distances.  Returns (embedded, window) like the
    reference ``_embed`` (cutoff_embedder.py:111-174); the window is
    None without cutoff.
    """
    if not cfg.cutoff:
        return _plain_embed(inputs, cfg), None
    if cfg.normalize:
        raise NotImplementedError(
            'normalize_cutoff is not ported yet (ROADMAP.md)')

    assert dists is not None and cutoff_dist is not None and tau is not None
    C = cfg.input_dims
    freq = _band_tensor(cfg, 'freq_bands', inputs.dtype, inputs.device)

    if cfg.dist_inputs:
        # per-joint vectors flattened to J*D: repeat each joint's
        # distance/cutoff D times (cutoff_embedder.py:116-124)
        D = C // cfg.cutoff_dim
        dists_e = torch.repeat_interleave(dists, D, dim=-1)
        cutoff_e = torch.repeat_interleave(cutoff_dist, D, dim=-1)
        x = x_f = inputs
    else:
        # inputs ARE the distances (RelDist): C == J
        dists_e = inputs
        cutoff_e = cutoff_dist
        x = inputs
        if cfg.cut_to_cutoff:
            x = cutoff_dist - x
        # only the frequency inputs are shifted; the include-input row
        # stays unshifted (cutoff_embedder.py:129-134)
        x_f = x * (2. / cutoff_dist) - 1. if cfg.shift_inputs else x

    x_freq = freq[:, None] * x_f[..., None, :]             # (..., F, C)
    w = 1. - torch.sigmoid(tau * (dists_e - cutoff_e))[..., None, :]

    enc = torch.stack([torch.sin(x_freq), torch.cos(x_freq)], dim=-2)
    enc = enc.reshape(enc.shape[:-3] + (2 * cfg.num_freqs, C))
    if cfg.freq_schedule:
        assert alpha is not None
        enc = enc * _schedule_w(cfg, alpha, enc)

    if cfg.include_input and cfg.cutoff_inputs:
        enc = torch.cat([x[..., None, :], enc], dim=-2) * w
    elif cfg.include_input:
        enc = enc * w
        x_b = x[..., None, :].expand(enc.shape[:-2] + (1, C))
        enc = torch.cat([x_b, enc], dim=-2)
    else:
        enc = enc * w
    return enc.reshape(enc.shape[:-2] + (enc.shape[-2] * C,)), w


def _plain_embed(inputs: torch.Tensor, cfg: EmbedConfig) -> torch.Tensor:
    """Classic NeRF PE (reference cutoff_embedder.py:9-58):
    [x, sin(f0 x), cos(f0 x), sin(f1 x), ...] along channels."""
    outs = []
    if cfg.include_input:
        outs.append(inputs)
    for f in cfg.freq_bands():
        outs.append(torch.sin(inputs * float(f)))
        outs.append(torch.cos(inputs * float(f)))
    if not outs:
        return inputs[..., :0]
    return torch.cat(outs, dim=-1)
