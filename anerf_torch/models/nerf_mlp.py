"""The A-NeRF radiance MLP as a pure function over a parameter tree.

Port of ``anerf_tpu/models/nerf_mlp.py`` (reference
core/networks/nerf.py:12-148 and the per-frame codes of
core/networks/embedding.py:4-44).  Parameters are the same nested dict
of tensors as the JAX package's tree (``{'pts_linears': [{'w': (in,
out), 'b': (out,)}, ...], 'alpha_linear': ..., 'framecodes': ...}``), so
``anerf_torch.interop`` moves trees between the two through numpy.

Architecture: density trunk of ``depth`` x ``width`` ReLU layers with
the input concatenated (input first) after each layer in ``skips``;
heads ``alpha_linear`` W->1, ``feature_linear`` W->W, ``views_linear``
[feature | view encoding | framecode] -> W/2 -> ReLU, ``rgb_linear``
-> 3.  Output is [rgb, alpha].
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    depth: int = 8                 # args.netdepth
    width: int = 256               # args.netwidth
    input_ch: int = 360            # kp encoding width (after PE)
    input_ch_bones: int = 72       # bone encoding width (after PE)
    input_ch_views: int = 648      # view encoding width (after PE)
    skips: Tuple[int, ...] = (4,)
    use_viewdirs: bool = True
    use_framecode: bool = False    # args.opt_framecode
    framecode_ch: int = 16
    n_framecodes: int = 0
    n_subjects: int = 1            # >1: subject-idx channel on the view net
    output_ch: int = 4             # only used when not use_viewdirs
    compute_dtype: torch.dtype = torch.float32

    @property
    def dnet_input(self) -> int:
        return self.input_ch + self.input_ch_bones

    @property
    def vnet_input(self) -> int:
        off = self.framecode_ch if self.use_framecode else 0
        subj = 1 if self.n_subjects > 1 else 0
        return self.input_ch_views + subj + off + self.width


def _linear_init(gen: torch.Generator, fan_in: int, fan_out: int):
    """torch nn.Linear default init: U(+-1/sqrt(fan_in)) for W and b."""
    bound = 1.0 / np.sqrt(fan_in)
    w = (torch.rand((fan_in, fan_out), generator=gen) * 2. - 1.) * bound
    b = (torch.rand((fan_out,), generator=gen) * 2. - 1.) * bound
    return {'w': w, 'b': b}


def init_nerf_params(generator: torch.Generator, cfg: NeRFConfig
                     ) -> Dict[str, Any]:
    """Fresh parameters drawn from ``generator`` (a CPU generator; move
    the tree with ``anerf_torch.interop.params_to``).  Framecodes are
    N(0, 1) like ``nn.Embedding``."""
    params: Dict[str, Any] = {}
    pts_linears = []
    in_dim = cfg.dnet_input
    for i in range(cfg.depth):
        pts_linears.append(_linear_init(generator, in_dim, cfg.width))
        # layer i+1 sees the skip concat if i is in skips
        in_dim = cfg.width + cfg.dnet_input if i in cfg.skips else cfg.width
    params['pts_linears'] = pts_linears
    if cfg.use_viewdirs:
        params['alpha_linear'] = _linear_init(generator, cfg.width, 1)
        params['feature_linear'] = _linear_init(generator, cfg.width,
                                                cfg.width)
        params['views_linear'] = _linear_init(generator, cfg.vnet_input,
                                              cfg.width // 2)
        params['rgb_linear'] = _linear_init(generator, cfg.width // 2, 3)
    else:
        params['output_linear'] = _linear_init(generator, cfg.width,
                                               cfg.output_ch)
    if cfg.use_framecode:
        params['framecodes'] = torch.randn(
            (cfg.n_framecodes, cfg.framecode_ch), generator=generator)
    return params


def _dense(p, x, dtype):
    """x @ w + b with operands rounded to ``dtype`` and the products
    summed in f32 (bf16 products are exact in f32)."""
    return x.to(dtype).float() @ p['w'].to(dtype).float() + p['b']


def forward_density(params, cfg: NeRFConfig, x_pts: torch.Tensor
                    ) -> torch.Tensor:
    """Density trunk with skip concat (reference nerf.py:94-102)."""
    dt = cfg.compute_dtype
    h = x_pts
    for i, p in enumerate(params['pts_linears']):
        h = torch.relu(_dense(p, h, dt))
        if i in cfg.skips:
            h = torch.cat([x_pts.float(), h], -1)
    return h


def framecode_lookup(codes: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """Per-frame code with eval fallback: idx < 0 -> mean code
    (reference embedding.py:17-28)."""
    mean_code = torch.mean(codes, dim=0)
    gathered = codes[torch.clamp(idx, 0, codes.shape[0] - 1)]
    return torch.where((idx < 0)[..., None], mean_code, gathered)


def framecode_lerp(codes: torch.Tensor, idx_a, idx_b, t) -> torch.Tensor:
    """Two-code interpolation path (reference embedding.py:24-28)."""
    ca = framecode_lookup(codes, idx_a)
    cb = framecode_lookup(codes, idx_b)
    return ca + (cb - ca) * t[..., None]


def framecode_select(codes: torch.Tensor, cam_idxs: torch.Tensor
                     ) -> torch.Tensor:
    """``(R,)`` integer indices -> per-frame lookup (idx < 0 -> mean
    code); ``(R, 3)`` float rows ``[idx_a, idx_b, w]`` -> two-code lerp
    (reference embedding.py:17-28)."""
    if cam_idxs.ndim == 2 and cam_idxs.shape[-1] == 3:
        return framecode_lerp(codes, cam_idxs[..., 0].long(),
                              cam_idxs[..., 1].long(), cam_idxs[..., 2])
    return framecode_lookup(codes, cam_idxs.long())


def nerf_forward(params, cfg: NeRFConfig,
                 x_pts: torch.Tensor,
                 x_views: Optional[torch.Tensor] = None,
                 framecode_idx: Optional[torch.Tensor] = None,
                 codes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full forward: (..., dnet_input), (..., input_ch_views) -> (..., 4)
    (reference ``NeRF.forward``, nerf.py:133-148).  Per-point ``codes``
    may be passed directly instead of ``framecode_idx``."""
    dt = cfg.compute_dtype
    h = forward_density(params, cfg, x_pts)
    if not cfg.use_viewdirs:
        return _dense(params['output_linear'], h, dt)

    alpha = _dense(params['alpha_linear'], h, dt)
    feature = _dense(params['feature_linear'], h, dt)
    if cfg.use_framecode:
        if codes is None:
            codes = framecode_lookup(params['framecodes'], framecode_idx)
        x_views = torch.cat([x_views, codes.to(x_views.dtype)], -1)
    hv = torch.cat([feature, x_views.float()], -1)
    hv = torch.relu(_dense(params['views_linear'], hv, dt))
    rgb = _dense(params['rgb_linear'], hv, dt)
    return torch.cat([rgb, alpha], -1)


def density_only(params, cfg: NeRFConfig, x_pts: torch.Tensor
                 ) -> torch.Tensor:
    """Raw density head only, for mesh extraction
    (reference raycasters.py:626-646)."""
    h = forward_density(params, cfg, x_pts)
    return _dense(params['alpha_linear'], h, cfg.compute_dtype)


def count_params(params) -> int:
    """The number of values in a parameter tree (nested dicts and lists
    of tensors or arrays; None leaves count nothing)."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return 0 if params is None else int(np.prod(params.shape))
