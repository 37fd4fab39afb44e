"""Raycaster factory: Config -> RayCastConfig + initial parameters.

Port of ``anerf_tpu/models/factory.py`` (reference ``create_raycaster``,
core/raycasters.py:17-184).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..ops import encoders
from ..ops.embedding import EmbedConfig, alpha_schedule, tau_schedule
from ..skeleton import Skeleton, SMPLSkeleton
from ..utils.config import Config
from .nerf_mlp import NeRFConfig, init_nerf_params
from .raycaster import RayCastConfig

# Config.mlp_backend (the names anerf_tpu uses) -> RayCastConfig.mlp_backend
_BACKENDS = {'pallas': 'fused', 'fused': 'fused', 'xla': 'plain',
             'plain': 'plain'}


def _mlp_backend(name: str, nerf: NeRFConfig) -> str:
    """'auto' takes the fused kernels for the tensor-core-aligned
    use_viewdirs nets (width a multiple of 256), as anerf_tpu's
    ``pallas_mlp.auto_worthwhile`` does; 'pallas'/'fused' always, and
    'xla'/'plain' never."""
    if name == 'auto':
        return ('fused' if nerf.use_viewdirs and nerf.width % 256 == 0
                else 'plain')
    if name not in _BACKENDS:
        raise ValueError(f'unknown mlp_backend {name!r}')
    return _BACKENDS[name]


def build_raycast_config(cfg: Config,
                         skel: Skeleton = SMPLSkeleton,
                         n_framecodes: int = 0,
                         n_subjects: int = 1) -> RayCastConfig:
    n_joints = skel.n_joints
    if cfg.n_subjects is not None:
        n_subjects = cfg.n_subjects
    _, input_dims, cutoff_dims = encoders.get_kp_input_fn(
        cfg.kp_dist_type, n_joints)
    _, bone_dims = encoders.get_bone_input_fn(cfg.bone_type, n_joints)
    _, view_dims = encoders.get_view_input_fn(cfg.view_type, n_joints)

    # kp embedder: cutoff on the distances themselves
    # (reference raycasters.py:30-50)
    kp_embed = EmbedConfig(
        input_dims=input_dims,
        num_freqs=cfg.multires,
        cutoff=cfg.use_cutoff,
        dist_inputs=not (input_dims == cutoff_dims),
        cutoff_inputs=cfg.cutoff_inputs,
        cut_to_cutoff=cfg.cut_to_dist,
        shift_inputs=cfg.cutoff_shift,
        normalize=cfg.normalize_cutoff,
        freq_schedule=cfg.freq_schedule,
        init_alpha=cfg.init_freq,
        cutoff_dim=cutoff_dims,
    )
    # bone embedder (reference raycasters.py:52-64)
    bone_embed = EmbedConfig(
        input_dims=max(bone_dims, 1),
        num_freqs=cfg.multires_bones,
        cutoff=cfg.use_cutoff and cfg.cutoff_bones and bone_dims > 0,
        dist_inputs=True,
        cutoff_inputs=cfg.cutoff_inputs,
        normalize=cfg.normalize_cutoff,
        freq_schedule=cfg.freq_schedule,
        init_alpha=cfg.init_freq,
        cutoff_dim=cutoff_dims,
    )
    # view embedder (reference raycasters.py:66-79)
    view_embed = EmbedConfig(
        input_dims=max(view_dims, 1),
        num_freqs=cfg.multires_views,
        cutoff=cfg.use_cutoff and cfg.cutoff_viewdir,
        dist_inputs=True,
        cutoff_inputs=cfg.cutoff_inputs,
        normalize=cfg.normalize_cutoff,
        freq_schedule=cfg.freq_schedule,
        init_alpha=cfg.init_freq,
        cutoff_dim=n_joints,
    )

    nerf = NeRFConfig(
        depth=cfg.netdepth,
        width=cfg.netwidth,
        input_ch=kp_embed.out_dim,
        input_ch_bones=bone_embed.out_dim if bone_dims > 0 else 0,
        input_ch_views=view_embed.out_dim if cfg.use_viewdirs else 0,
        skips=(4,),
        use_viewdirs=cfg.use_viewdirs,
        use_framecode=cfg.opt_framecode,
        framecode_ch=cfg.framecode_size,
        n_framecodes=(cfg.n_framecodes if cfg.n_framecodes is not None
                      else n_framecodes),
        n_subjects=n_subjects,
        output_ch=5 if cfg.N_importance > 0 else 4,
        compute_dtype=(torch.bfloat16 if cfg.compute_dtype == 'bfloat16'
                       else torch.float32),
    )
    return RayCastConfig(
        nerf=nerf,
        n_subjects=n_subjects,
        mlp_backend=_mlp_backend(cfg.mlp_backend, nerf),
        kp_embed=kp_embed,
        bone_embed=bone_embed,
        view_embed=view_embed,
        n_joints=n_joints,
        N_samples=cfg.N_samples,
        N_importance=cfg.N_importance,
        perturb=cfg.perturb,
        raw_noise_std=cfg.raw_noise_std,
        ray_noise_std=cfg.ray_noise_std,
        lindisp=cfg.lindisp,
        single_net=cfg.single_net,
        use_viewdirs=cfg.use_viewdirs,
        density_scale=cfg.density_scale,
        density_type=cfg.density_type,
        softplus_shift=cfg.softplus_shift,
        kp_dist_type=cfg.kp_dist_type,
        view_type=cfg.view_type,
        bone_type=cfg.bone_type,
        opt_cutoff=cfg.opt_cutoff,
        viewfac=cfg.viewfac,
        fuse_tform=cfg.fuse_tform,
    )


def init_raycaster_params(generator: torch.Generator, rc: RayCastConfig,
                          cfg: Config, skel: Skeleton = SMPLSkeleton
                          ) -> Dict[str, Any]:
    """Initial parameters drawn from ``generator`` (CPU): coarse + fine
    MLPs and the per-joint cutoff distances (frozen buffers in the
    reference, cutoff_embedder.py:91)."""
    params: Dict[str, Any] = {
        'coarse': init_nerf_params(generator, rc.nerf),
        'fine': None,
        'cutoff_dist': torch.as_tensor(
            skel.cutoff_dists(1.0, cfg.cutoff_mm) * cfg.ext_scale),
    }
    if rc.N_importance > 0 and not rc.single_net:
        params['fine'] = init_nerf_params(generator, rc.nerf)
    return params


def embed_state(cfg: Config, rc: RayCastConfig, global_step
                ) -> Dict[str, Any]:
    """Schedule state (tau, alpha) at a given step (reference
    trainer.py:264-265 -> update_embed_fns)."""
    tau = tau_schedule(rc.kp_embed, global_step, cfg.cutoff_step,
                       cfg.cutoff_rate)
    alpha = None
    if cfg.freq_schedule:
        alpha = alpha_schedule(rc.kp_embed, global_step,
                               cfg.freq_schedule_step,
                               target=float(cfg.multires - 1))
    return {'tau': tau, 'alpha': alpha}
