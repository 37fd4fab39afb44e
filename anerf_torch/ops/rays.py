"""Ray generation and sampling primitives in PyTorch.

Port of ``anerf_tpu/ops/rays.py`` (reference core/utils/ray_utils.py).
Randomness is explicit: every stochastic function takes either a
``torch.Generator`` or precomputed uniforms (``u``), the latter
replicating the reference's deterministic ``pytest=True`` mode for
parity tests.  The JAX package built searchsorted and the row picks
from comparison counts and one-hot matmuls because gathers lower
serially on a TPU; here they are ``torch.searchsorted`` and ``gather``,
which give the same values.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed


def get_rays_np(H, W, focal, c2w, center=None):
    """Per-pixel ray origins/directions for a full image, host-side
    (reference ray_utils.py:31-61, including the identity/axis-aligned
    rotation fast paths).  Returns (rays_o, rays_d), each (H, W, 3)."""
    if isinstance(focal, float) or (np.asarray(focal).reshape(-1).size < 2):
        fx = fy = focal
    else:
        fx, fy = np.asarray(focal).reshape(-1)[:2]
    if center is None:
        ox, oy = W * 0.5, H * 0.5
    else:
        ox, oy = center
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing='xy')
    dirs = np.stack([(i - ox) / fx, -(j - oy) / fy, -np.ones_like(i)], -1)
    eye = np.eye(3)
    rot = c2w[:3, :3]
    if np.isclose(eye, rot).all():
        rays_d = dirs
    elif np.isclose(eye, np.abs(rot)).all():
        rays_d = dirs * rot.sum(-1)
    else:
        rays_d = np.sum(dirs[..., None, :] * rot, -1)
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
    return rays_o, rays_d


def _linspace01(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.linspace(0., 1., n, dtype=like.dtype, device=like.device)


def sample_from_lineseg(near: torch.Tensor, far: torch.Tensor,
                        N_samples: int,
                        perturb: float = 0.,
                        lindisp: bool = False,
                        generator: Optional[torch.Generator] = None,
                        u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stratified depths along rays (reference ray_utils.py:204-251).

    near, far: (N_rays, 1).  With ``perturb > 0`` each interval is
    jittered by ``u`` (N_rays, N_samples) or, when ``u`` is None, by
    uniforms drawn from ``generator``.  Returns (N_rays, N_samples).
    """
    t = _linspace01(N_samples, near)
    if not lindisp:
        z_vals = near * (1. - t) + far * t
    else:
        z_vals = 1. / (1. / near * (1. - t) + 1. / far * t)
    if perturb > 0.:
        mids = .5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], -1)
        lower = torch.cat([z_vals[..., :1], mids], -1)
        if u is None:
            u = torch.rand(z_vals.shape, generator=generator,
                           dtype=z_vals.dtype, device=z_vals.device)
        z_vals = lower + (upper - lower) * u
    return z_vals


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, N_samples: int,
               det: bool = False,
               generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF (hierarchical) sampling (reference
    ray_utils.py:157-201).

    bins: (N_rays, M) bin edges; weights: (N_rays, M-1).  Returns
    (N_rays, N_samples) samples, detached like the reference.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)

    if u is None:
        if det:
            u = _linspace01(N_samples, cdf).expand(
                cdf.shape[:-1] + (N_samples,))
        else:
            u = torch.rand(cdf.shape[:-1] + (N_samples,),
                           generator=generator, dtype=cdf.dtype,
                           device=cdf.device)
    u = u.contiguous()

    # count of cdf entries <= u, i.e. searchsorted(side='right')
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    M = cdf.shape[-1]
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=M - 1)
    # bins has M or fewer columns: clamp like an edge-padded table
    nb = bins.shape[-1]
    cdf_below = cdf.gather(-1, below)
    cdf_above = cdf.gather(-1, above)
    bins_below = bins.gather(-1, below.clamp(max=nb - 1))
    bins_above = bins.gather(-1, above.clamp(max=nb - 1))
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    tt = (u - cdf_below) / denom
    samples = bins_below + tt * (bins_above - bins_below)
    return samples.detach()


def isample_ranks(z_vals: torch.Tensor, weights: torch.Tensor,
                  N_importance: int,
                  det: bool = False,
                  is_only: bool = False,
                  alpha_base: float = 0.01,
                  generator: Optional[torch.Generator] = None,
                  u: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Importance samples plus the sorted-union RANKS of
    [z_vals | z_samples]: ``ranks[k]`` is the position of concatenated
    element k in the stable sort of the concatenation (ties: coarse
    before fine, and among fine samples by index), as torch.sort of the
    concatenation orders them (reference ray_utils.py:283-287).

    Returns z_samples (N_rays, N_importance) and ranks
    (N_rays, N_samples + N_importance) int64.
    """
    z_mid = .5 * (z_vals[..., 1:] + z_vals[..., :-1])
    if is_only:
        w_l = weights[..., 0:-2]
        w_k = weights[..., 1:-1]
        w_u = weights[..., 2:]
        dist_w = 0.5 * (torch.maximum(w_l, w_k)
                        + torch.maximum(w_k, w_u)) + alpha_base
    else:
        dist_w = weights[..., 1:-1]
    z_samples = sample_pdf(z_mid, dist_w, N_importance, det=det,
                           generator=generator, u=u)
    # z_vals is sorted, so each coarse element's final position is its
    # index plus the count of fine samples strictly before it
    S = z_vals.shape[-1]
    I = z_samples.shape[-1]
    dev = z_vals.device
    rank_coarse = torch.arange(S, device=dev) + torch.sum(
        z_samples[..., None, :] < z_vals[..., :, None], dim=-1)
    lt = z_samples[..., None, :] < z_samples[..., :, None]
    eq_before = (z_samples[..., None, :] == z_samples[..., :, None]) & (
        torch.arange(I, device=dev)[:, None]
        > torch.arange(I, device=dev)[None, :])
    rank_in_samples = torch.sum(lt | eq_before, dim=-1)
    rank_fine = rank_in_samples + torch.sum(
        z_vals[..., None, :] <= z_samples[..., :, None], dim=-1)
    ranks = torch.cat([rank_coarse, rank_fine], dim=-1)
    return z_samples, ranks


def get_near_far_in_cylinder(rays_o: torch.Tensor, rays_d: torch.Tensor,
                             cyl: torch.Tensor,
                             near=0.35, far=2.75,
                             g_axes=(0, 2), group=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray near/far from intersecting the bounding cylinder
    (reference ray_utils.py:292-344).

    Rays that miss the cylinder take the mean near/far of the rays in
    the SAME batch that hit it (the input bounds when none hits), as the
    JAX package does; callers that chunk must chunk and pad alike to get
    the same values.  With a process ``group`` the batch is the ranks'
    blocks together: the hits' sums and count are all-reduced over it
    first, so that a rank's misses take the global batch's mean, as on
    anerf_tpu's sharded mesh.  cyl: (N_rays, 5) (cx, cz, radius, top,
    bot).  Returns (new_near, new_far), each (N_rays, 1).
    """
    # the two ground-plane axes, picked by slicing: indexing with a
    # python list builds an index tensor on the host and waits for the
    # stream
    ground = lambda x: torch.stack([x[..., g_axes[0]], x[..., g_axes[1]]],
                                   -1)
    col = rays_o[..., :1]
    # python bounds are filled on the device (a host copy would wait
    # for the stream)
    near = (near.to(col.dtype) if torch.is_tensor(near)
            else torch.full_like(col, float(near))).expand(col.shape)
    far = (far.to(col.dtype) if torch.is_tensor(far)
           else torch.full_like(col, float(far))).expand(col.shape)
    r_near = ground(rays_o + rays_d * near)
    r_far = ground(rays_o + rays_d * far)

    radius = cyl[..., 2:3]
    center = cyl[..., :2]

    nc = center - r_near
    nf = r_far - r_near
    nf_norm = torch.linalg.norm(nf, dim=-1).clamp(min=1e-12)
    scale = torch.linalg.norm(ground(rays_d), dim=-1,
                              keepdim=True).clamp(min=1e-12)

    cross = nc[..., 0] * nf[..., 1] - nc[..., 1] * nf[..., 0]
    dist = (torch.abs(cross) / nf_norm)[..., None]

    q_sq = radius ** 2 - dist ** 2
    hit = q_sq[..., 0] > 0.
    Q = torch.sqrt(torch.clamp(q_sq, min=1e-12))
    K = (torch.sum(nc * nf, -1) / nf_norm)[..., None]
    outside = (Q < K).to(rays_o.dtype)     # near point outside the circle

    new_near = near + outside * (K - Q) / scale
    new_far = near + (K + Q) / scale

    hit_f = hit.to(rays_o.dtype)[..., None]
    sums = torch.stack([(new_near * hit_f).sum(), (new_far * hit_f).sum(),
                        hit_f.sum()])
    if group is not None:
        torch.distributed.all_reduce(sums, group=group)
    n_hit = torch.clamp(sums[2], min=1.)
    mean_near = sums[0] / n_hit
    mean_far = sums[1] / n_hit
    any_hit = sums[2] > 0.
    new_near = torch.where(hit[..., None], new_near,
                           torch.where(any_hit, mean_near, near))
    new_far = torch.where(hit[..., None], new_far,
                          torch.where(any_hit, mean_far, far))
    return new_near, new_far


def get_near_far_in_cylinder_np(rays_o, rays_d, cyl, near=0.35, far=2.75):
    """Numpy twin (reference ray_utils.py:346-379) for host-side prep."""
    r_near = (rays_o + rays_d * near)[..., [0, -1]]
    r_far = (rays_o + rays_d * far)[..., [0, -1]]
    radius = cyl[..., 2:3]
    center = cyl[..., :2]
    nc = center - r_near
    nf = r_far - r_near
    nf_norm = np.linalg.norm(nf, axis=-1)
    scale = np.linalg.norm(rays_d[..., [0, -1]], axis=-1)[..., None]
    cross = nc[..., 0] * nf[..., 1] - nc[..., 1] * nf[..., 0]
    dist = (np.abs(cross) / nf_norm)[..., None]
    q_sq = radius ** 2 - dist ** 2
    hit = q_sq > 0.
    Q = np.sqrt(np.maximum(q_sq, 0.))
    K = ((nc * nf).sum(-1) / nf_norm)[..., None]
    mask = (Q < K).astype(np.float32)
    new_near = np.where(hit, near + mask * (K - Q) / scale, near)
    new_far = np.where(hit, near + (K + Q) / scale, far)
    return new_near, new_far
