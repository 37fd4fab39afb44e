"""The volumetric renderer: sample -> transform -> encode -> MLP -> composite.

Port of ``anerf_tpu/models/raycaster.py`` (reference
core/raycasters.py: render_rays :361-474, encode_inputs :476-555,
run_network :557-577).  Parameters and randomness are explicit: a
``torch.Generator`` replaces the JAX key, and ``fixed`` pins every
random draw for parity tests.

Two MLP backends (``RayCastConfig.mlp_backend``):
  * 'fused': the hand-written fused encode+MLP kernels
    (ops/fused_encmlp.py) when the model has one subject and
    ``supported_config`` holds, K1/K2 forward and K3/K4 backward.
    Otherwise (multi-subject models, trainable cutoffs, other encoders)
    the encodings are computed with plain ops and handed as separate
    parts to the split-operand MLP kernels (ops/fused_mlp.py), K5
    forward and K6 backward.  The wrappers take the plain twins for CPU
    tensors.  Gradients reach the nets' parameters, the framecodes and
    the per-ray ``skts``.
  * 'plain': the unfused encode + MLP (the JAX package's 'xla').

A multi-subject model (``n_subjects > 1``) takes each ray's subject
index as one extra view channel (reference raycasters.py:545-548).

The coarse/fine merge is a scatter/gather by the sorted-union ranks
(ops/compositing.raw2outputs_merged*): only the scalar densities and
depths move into depth order, the weights move back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops import compositing, encoders, rays as ray_ops
from ..ops.embedding import EmbedConfig, embed
from .nerf_mlp import NeRFConfig, framecode_select, nerf_forward


@dataclasses.dataclass(frozen=True)
class RayCastConfig:
    """Static rendering configuration."""
    nerf: NeRFConfig
    kp_embed: EmbedConfig
    bone_embed: EmbedConfig
    view_embed: EmbedConfig
    n_joints: int = 24
    N_samples: int = 64
    N_importance: int = 16
    perturb: float = 1.0
    raw_noise_std: float = 0.0
    ray_noise_std: float = 0.0
    lindisp: bool = False
    single_net: bool = False
    use_viewdirs: bool = True
    density_scale: float = 1.0
    density_type: str = 'relu'
    softplus_shift: float = 1.0
    kp_dist_type: str = 'reldist'
    view_type: str = 'relray'
    bone_type: str = 'reldir'
    n_subjects: int = 1
    # cutoff radii are a frozen buffer in the reference
    # (cutoff_embedder.py:91, requires_grad=False) unless --opt_cutoff
    opt_cutoff: bool = False
    mlp_backend: str = 'plain'      # 'fused' | 'plain'
    # the point tile the viewfac cost gate prices (fused_encmlp._build_call)
    pallas_tile: Optional[int] = None
    # per-ray view factorization (anerf_tpu); the port computes the cost
    # gate but always runs the dense form (ROADMAP.md)
    viewfac: bool = False

    def density_fn(self):
        return compositing.get_density_fn(self.density_type,
                                          self.softplus_shift)

    def eval_variant(self) -> 'RayCastConfig':
        """Test-time settings (reference raycasters.py:170-178): no
        perturbation, no noise, the eval tile of 1024."""
        return dataclasses.replace(self, perturb=0., raw_noise_std=0.,
                                   ray_noise_std=0., pallas_tile=1024)


def encode_inputs(rc: RayCastConfig,
                  params: Dict[str, Any],
                  pts: torch.Tensor,
                  rays_o: torch.Tensor,
                  rays_d: torch.Tensor,
                  pose: Dict[str, torch.Tensor],
                  state: Dict[str, Any],
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                             Optional[torch.Tensor]]:
    """Skeleton-relative encodings (v, r, d) for query points
    (reference ``RayCaster.encode_inputs``, raycasters.py:476-555).

    pts: (N_rays, S, 3) world points; pose: kps (N_rays, J, 3), skts
    (N_rays, J, 4, 4), bones; state: {'tau', 'alpha'}.  The encodings
    come back in the MLP's compute dtype.
    """
    kps, skts, bones = pose['kps'], pose['skts'], pose.get('bones')
    kp_fn, _, _ = encoders.get_kp_input_fn(rc.kp_dist_type, rc.n_joints)
    bone_fn, bone_dims = encoders.get_bone_input_fn(rc.bone_type,
                                                    rc.n_joints)
    view_fn, _ = encoders.get_view_input_fn(rc.view_type, rc.n_joints)

    pts_t = encoders.transform_batch_pts(pts, skts)
    rays_t = encoders.transform_batch_rays(rays_d[:, None], skts)

    v = kp_fn(pts, pts_t, kps)
    r = bone_fn(pts_t, bones) if bone_dims > 0 else None
    d = view_fn(rays_t, pts_t) if rc.use_viewdirs else None
    j_dists = v     # 'reldist': the kp input IS the joint distances

    cutoff_dist = params['cutoff_dist']
    if not rc.opt_cutoff:
        cutoff_dist = cutoff_dist.detach()
    tau, alpha = state.get('tau'), state.get('alpha')
    v, _ = embed(v, rc.kp_embed, dists=j_dists, cutoff_dist=cutoff_dist,
                 tau=tau, alpha=alpha)
    if r is not None:
        r, _ = embed(r, rc.bone_embed, dists=j_dists,
                     cutoff_dist=cutoff_dist, tau=tau, alpha=alpha)
    if d is not None:
        d, _ = embed(d, rc.view_embed, dists=j_dists,
                     cutoff_dist=cutoff_dist, tau=tau, alpha=alpha)
    cast = lambda x: None if x is None else x.to(rc.nerf.compute_dtype)
    v, r, d = cast(v), cast(r), cast(d)
    if d is not None and d.shape[1] != pts.shape[1]:
        # per-ray view encoding (no per-sample cutoff): expand now
        d = d.expand(d.shape[:1] + (pts.shape[1],) + d.shape[2:])
    return v, r, d


def _run_network(rc: RayCastConfig, net_params, v, r, d, cam_idxs,
                 subject_idxs=None):
    """The MLP on the encodings, keeping (R, S) structure (reference
    raycasters.py:557-577 + nerf.py:133-148).  On the fused backend the
    encodings go to K5 as separate parts, never concatenated: the
    views input [d | subject | codes] as three parts (the view rows of
    ``views_linear`` split 648/1/16, the same function as anerf_tpu's
    [d+subject, codes] without the copy of d)."""
    subj = None
    if rc.n_subjects > 1 and d is not None:
        # the per-ray subject index rides as one extra view channel
        # (zeros when none is given, as the renderers do)
        if subject_idxs is None:
            subj = torch.zeros(d.shape[:2] + (1,), dtype=d.dtype,
                               device=d.device)
        else:
            subj = subject_idxs.to(d.dtype)[:, None, None].expand(
                d.shape[:2] + (1,))
    codes = None
    if rc.nerf.use_framecode and cam_idxs is not None:
        # per-ray lookup broadcast over the samples
        codes_ray = framecode_select(net_params['framecodes'], cam_idxs)
        codes = codes_ray[:, None].expand(v.shape[:2]
                                          + codes_ray.shape[-1:])

    if rc.mlp_backend == 'fused' and rc.use_viewdirs and d is not None:
        from ..ops.fused_mlp import nerf_mlp_fused
        xv_parts = [p for p in (d, subj, codes) if p is not None]
        return nerf_mlp_fused(net_params, rc.nerf,
                              [v] if r is None else [v, r], xv_parts)
    if subj is not None:
        d = torch.cat([d, subj], -1)
    x_pts = v if r is None else torch.cat([v, r], -1)
    return nerf_forward(net_params, rc.nerf, x_pts, d, codes=codes)


def _normal(shape, like: torch.Tensor, generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def render_rays(rc: RayCastConfig,
                params: Dict[str, Any],
                rays_o: torch.Tensor,
                rays_d: torch.Tensor,
                near,
                far,
                pose: Dict[str, torch.Tensor],
                state: Optional[Dict[str, Any]] = None,
                cam_idxs: Optional[torch.Tensor] = None,
                subject_idxs: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                fixed: Optional[Dict[str, torch.Tensor]] = None,
                ) -> Dict[str, torch.Tensor]:
    """Render a batch of rays through the articulated NeRF (reference
    ``RayCaster.render_rays``, raycasters.py:361-474): cylinder-clipped
    near/far, stratified coarse samples, encode, coarse MLP and
    composite, importance sampling, sorted-union fine pass.

    params: {'coarse', 'fine', 'cutoff_dist' (J,)}; rays_o/rays_d
    (N_rays, 3); near/far scalars or (N_rays, 1); pose: kps, skts, bones
    and cyls (N_rays, 5); state: {'tau', 'alpha'}; subject_idxs: (N_rays,)
    subject of each ray for a multi-subject model; generator: draws the
    jitter and noise (omit for deterministic rendering); fixed: pins
    'coarse_u', 'fine_u', 'coarse_noise', 'fine_noise'.
    Returns rgb_map/disp_map/acc_map/alpha/weights (+ rgb0/disp0/acc0/
    alpha0 of the coarse pass).
    """
    state = state or {'tau': None, 'alpha': None}
    fixed = fixed or {}
    dev = rays_o.device
    tau = state.get('tau')
    tau = (torch.full((), 1e6, device=dev) if tau is None
           else torch.as_tensor(tau, dtype=torch.float32, device=dev))
    state = dict(state, tau=tau)
    draws = generator is not None

    near, far = ray_ops.get_near_far_in_cylinder(
        rays_o, rays_d, pose['cyls'], near=near, far=far)
    z_vals = ray_ops.sample_from_lineseg(
        near, far, rc.N_samples, perturb=rc.perturb, lindisp=rc.lindisp,
        generator=generator, u=fixed.get('coarse_u'))
    pts = rays_o[:, None] + rays_d[:, None] * z_vals[..., None]
    if rc.ray_noise_std > 0. and draws:
        pts = pts + _normal(pts.shape, pts, generator) * rc.ray_noise_std

    fused_net = fused_dual = None
    if rc.mlp_backend == 'fused' and rc.n_subjects == 1:
        from ..ops import fused_encmlp as FE
        if FE.supported_config(rc):
            skts = pose['skts']
            rays_t = encoders.transform_batch_rays(rays_d[:, None], skts)
            rays_t_norm = encoders.vec_norm(rays_t)[:, 0]
            cutoff = params['cutoff_dist'].detach()
            cams = cam_idxs if rc.nerf.use_framecode else None
            # per-ray view PE rows built once for both kernel calls
            enc_ray = FE.view_pe_rows(
                rays_t_norm, [float(f) for f in rc.view_embed.freq_bands()],
                rc.n_joints).float()

            def fused_net(net_params, q_pts):  # noqa: E306
                return FE.nerf_encmlp(
                    net_params, rc,
                    encoders.transform_batch_pts_cm(q_pts, skts).float(),
                    rays_t_norm, cutoff, state['tau'], cams,
                    tile=rc.pallas_tile, enc_ray=enc_ray)

            def fused_dual(q_pts):  # noqa: E306
                return FE.nerf_encmlp_dual(
                    params['coarse'], params['fine'], rc,
                    encoders.transform_batch_pts_cm(q_pts, skts).float(),
                    rays_t_norm, cutoff, state['tau'], cams,
                    tile=rc.pallas_tile, enc_ray=enc_ray)

    enc_cache: Dict[str, Any] = {}

    def run_pass(net_params, q_pts, key):
        """Returns (raw, rows): rows=True means channel-major (4, R, S)
        from a fused kernel, else dense (R, S, 4)."""
        if fused_net is not None:
            return fused_net(net_params, q_pts), True
        if key not in enc_cache:  # coarse encodings serve both nets
            enc_cache[key] = encode_inputs(rc, params, q_pts, rays_o,
                                           rays_d, pose, state)
        vv, rr, dd = enc_cache[key]
        return _run_network(rc, net_params, vv, rr, dd, cam_idxs,
                            subject_idxs), False

    def composite(raw, rows, z, noise):
        kw = dict(noise=noise, density_scale=rc.density_scale,
                  act_fn=rc.density_fn())
        if rows:
            return compositing.raw2outputs_rows(raw[3], raw[0], raw[1],
                                                raw[2], z, rays_d, **kw)
        return compositing.raw2outputs(raw, z, rays_d, **kw)

    to_dense = lambda a: a.permute(1, 2, 0)

    # both nets on the coarse samples in one kernel launch
    raw_c_pre = None
    two_nets = (rc.N_importance > 0 and not rc.single_net
                and params.get('fine') is not None)
    if fused_dual is not None and two_nets:
        raw, raw_c_pre = fused_dual(pts)
        rows = True
    else:
        raw, rows = run_pass(params['coarse'], pts, 'coarse')

    noise = fixed.get('coarse_noise')
    if noise is None and rc.raw_noise_std > 0. and draws:
        noise = _normal(z_vals.shape, z_vals, generator) \
            * rc.raw_noise_std * rc.density_scale
    ret = composite(raw, rows, z_vals, noise)

    ret0 = None
    if rc.N_importance > 0:
        ret0 = ret
        z_samples, ranks = ray_ops.isample_ranks(
            z_vals, ret0['weights'], rc.N_importance,
            det=(rc.perturb == 0.), is_only=rc.single_net,
            generator=generator, u=fixed.get('fine_u'))
        z_cat = torch.cat([z_vals, z_samples], -1)
        pts_is = rays_o[:, None] + rays_d[:, None] * z_samples[..., None]
        if rc.ray_noise_std > 0. and draws:
            pts_is = pts_is + _normal(pts_is.shape, pts_is, generator) \
                * rc.ray_noise_std

        fine_params = params['coarse'] if rc.single_net else params['fine']
        if not rc.single_net:
            # the MLP is pointwise across samples: run the fine net on the
            # coarse points and on the new points as two passes, then
            # composite straight off the unsorted concatenation
            if raw_c_pre is not None:
                raw_c, rows_f = raw_c_pre, True
            else:
                raw_c, rows_f = run_pass(fine_params, pts, 'coarse')
            raw_n, rows_n = run_pass(fine_params, pts_is, 'fine')
        else:
            raw_c, rows_f = raw, rows
            raw_n, rows_n = run_pass(fine_params, pts_is, 'fine')

        noise = fixed.get('fine_noise')
        if noise is None and rc.raw_noise_std > 0. and draws:
            noise = _normal(z_cat.shape, z_cat, generator) \
                * rc.raw_noise_std * rc.density_scale
        kw = dict(noise=noise, density_scale=rc.density_scale,
                  act_fn=rc.density_fn())
        if rows_f and rows_n:
            cat = lambda c: torch.cat([raw_c[c], raw_n[c]], -1)
            ret = compositing.raw2outputs_merged_rows(
                cat(3), cat(0), cat(1), cat(2), z_cat, ranks, rays_d, **kw)
        else:
            raw_cat = torch.cat(
                [to_dense(raw_c) if rows_f else raw_c,
                 to_dense(raw_n) if rows_n else raw_n], 1)
            ret = compositing.raw2outputs_merged(raw_cat, z_cat, ranks,
                                                 rays_d, **kw)

    out = {'rgb_map': ret['rgb_map'], 'disp_map': ret['disp_map'],
           'acc_map': ret['acc_map'], 'alpha': ret['alpha'],
           'weights': ret['weights']}
    if ret0 is not None:
        out.update({'rgb0': ret0['rgb_map'], 'disp0': ret0['disp_map'],
                    'acc0': ret0['acc_map'], 'alpha0': ret0['alpha']})
    return out
