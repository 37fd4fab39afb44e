"""Volume rendering (alpha compositing) in PyTorch.

Port of ``anerf_tpu/ops/compositing.py`` (reference
core/networks/nerf.py:150-205): alpha = 1 - exp(-act(raw_sigma / B +
noise) * delta * ||d||), transmittance by exclusive cumulative product,
sigmoid RGB stretched by +-rgb_eps, disparity/accumulation/depth maps
with the same clamping.  The JAX package merged coarse and fine samples
through a one-hot rank-permutation matmul; here the same permutation is
a ``scatter``/``gather`` by the ranks, which moves values exactly.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


def softplus_shifted(shift: float = 1.0) -> Callable[[torch.Tensor],
                                                     torch.Tensor]:
    """Density activation ``softplus(x - shift)``
    (reference core/raycasters.py:230-238)."""
    def act(x):
        return F.softplus(x - shift)
    return act


def get_density_fn(density_type: str, softplus_shift: float = 1.0):
    if density_type == 'relu':
        return torch.relu
    if density_type == 'softplus':
        return softplus_shifted(softplus_shift)
    raise NotImplementedError(f'density activation {density_type} undefined')


def _deltas(z: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    dists = z[..., 1:] - z[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    return dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)


def _weights(sigma: torch.Tensor, dists: torch.Tensor, act_fn: Callable):
    alpha = 1. - torch.exp(-act_fn(sigma) * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]),
                   1. - alpha + 1e-10], -1), -1)[..., :-1]
    return alpha, alpha * trans


def _maps(rgb_map, depth_map, weights, alpha):
    acc_raw = torch.sum(weights, -1)
    disp_map = 1. / torch.clamp(depth_map / (acc_raw + 1e-10), min=1e-10)
    disp_map = torch.where(
        torch.isclose(acc_raw, torch.zeros_like(acc_raw)),
        torch.zeros_like(disp_map), disp_map)
    acc_map = torch.clamp(acc_raw, max=1.)
    return {'rgb_map': rgb_map, 'disp_map': disp_map, 'acc_map': acc_map,
            'depth_map': depth_map, 'weights': weights, 'alpha': alpha}


def _stretch(c: torch.Tensor, rgb_eps: float) -> torch.Tensor:
    return torch.sigmoid(c) * (1 + 2 * rgb_eps) - rgb_eps


def raw2outputs(raw: torch.Tensor,
                z_vals: torch.Tensor,
                rays_d: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                density_scale: float = 1.0,
                act_fn: Callable = torch.relu,
                rgb_eps: float = 0.001) -> Dict[str, torch.Tensor]:
    """Composite raw (N_rays, N_samples, 4) [rgb logits, raw density]
    along rays at depths z_vals (N_rays, N_samples)."""
    dists = _deltas(z_vals, rays_d)
    rgb = _stretch(raw[..., :3], rgb_eps)
    sigma = raw[..., 3] / density_scale
    if noise is not None:
        sigma = sigma + noise
    alpha, weights = _weights(sigma, dists, act_fn)
    rgb_map = torch.sum(weights[..., None] * rgb, -2)
    depth_map = torch.sum(weights * z_vals, -1)
    return _maps(rgb_map, depth_map, weights, alpha)


def raw2outputs_rows(sig: torch.Tensor, r: torch.Tensor, g: torch.Tensor,
                     b: torch.Tensor,
                     z_vals: torch.Tensor,
                     rays_d: torch.Tensor,
                     noise: Optional[torch.Tensor] = None,
                     density_scale: float = 1.0,
                     act_fn: Callable = torch.relu,
                     rgb_eps: float = 0.001) -> Dict[str, torch.Tensor]:
    """``raw2outputs`` on channel rows: sig/r/g/b are (N_rays, S), the
    per-channel views of the fused kernels' (4, R, S) output."""
    dists = _deltas(z_vals, rays_d)
    sigma = sig / density_scale
    if noise is not None:
        sigma = sigma + noise
    alpha, weights = _weights(sigma, dists, act_fn)
    rgb_map = torch.stack([torch.sum(weights * _stretch(c, rgb_eps), -1)
                           for c in (r, g, b)], -1)
    depth_map = torch.sum(weights * z_vals, -1)
    return _maps(rgb_map, depth_map, weights, alpha)


def _to_sorted(x_cat: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """x_sorted[r, ranks[r, k]] = x_cat[r, k]."""
    return torch.empty_like(x_cat).scatter_(-1, ranks, x_cat)


def raw2outputs_merged(raw_cat: torch.Tensor,
                       z_cat: torch.Tensor,
                       ranks: torch.Tensor,
                       rays_d: torch.Tensor,
                       noise: Optional[torch.Tensor] = None,
                       density_scale: float = 1.0,
                       act_fn: Callable = torch.relu,
                       rgb_eps: float = 0.001) -> Dict[str, torch.Tensor]:
    """``raw2outputs`` on the depth-sorted union of coarse and fine
    samples without permuting the raw rows.

    ``raw_cat`` (N_rays, K, 4) and ``z_cat`` (N_rays, K) are in concat
    order and ``ranks`` (N_rays, K) gives each element's sorted
    position.  Depths and densities move into depth order for the
    transmittance scan, the weights move back, and every map is a
    concat-order reduction: the same result as the reference's
    sort-then-composite (core/raycasters.py:796-812).  ``noise`` is in
    SORTED order; ``weights``/``alpha`` come back in sorted order.
    """
    z_sorted = _to_sorted(z_cat, ranks)
    dists = _deltas(z_sorted, rays_d)
    sigma = _to_sorted(raw_cat[..., 3] / density_scale, ranks)
    if noise is not None:
        sigma = sigma + noise
    alpha, weights = _weights(sigma, dists, act_fn)
    w_cat = weights.gather(-1, ranks)
    rgb = _stretch(raw_cat[..., :3], rgb_eps)
    rgb_map = torch.sum(w_cat[..., None] * rgb, -2)
    depth_map = torch.sum(w_cat * z_cat, -1)
    return _maps(rgb_map, depth_map, weights, alpha)


def raw2outputs_merged_rows(sig_cat: torch.Tensor, r_cat: torch.Tensor,
                            g_cat: torch.Tensor, b_cat: torch.Tensor,
                            z_cat: torch.Tensor,
                            ranks: torch.Tensor,
                            rays_d: torch.Tensor,
                            noise: Optional[torch.Tensor] = None,
                            density_scale: float = 1.0,
                            act_fn: Callable = torch.relu,
                            rgb_eps: float = 0.001
                            ) -> Dict[str, torch.Tensor]:
    """``raw2outputs_merged`` on channel rows (each (N_rays, K))."""
    z_sorted = _to_sorted(z_cat, ranks)
    dists = _deltas(z_sorted, rays_d)
    sigma = _to_sorted(sig_cat / density_scale, ranks)
    if noise is not None:
        sigma = sigma + noise
    alpha, weights = _weights(sigma, dists, act_fn)
    w_cat = weights.gather(-1, ranks)
    rgb_map = torch.stack([torch.sum(w_cat * _stretch(c, rgb_eps), -1)
                           for c in (r_cat, g_cat, b_cat)], -1)
    depth_map = torch.sum(w_cat * z_cat, -1)
    return _maps(rgb_map, depth_map, weights, alpha)
