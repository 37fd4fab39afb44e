"""Configuration system.

Replaces the reference's configargparse stack (run_nerf.py:184-488) with
a typed dataclass whose field names and defaults match the reference
flags one-to-one, plus a parser for the reference's ``key = value`` txt
config files (configs/*/*.txt) and the ``args.txt`` round-trip that the
render scripts rely on (reference run_nerf.py:505-510,
evaluation_helpers.py:221-255).

Copy of ``anerf_tpu/utils/config.py``: one ``Config`` and one txt-file
format serve both packages, so a recipe or an ``args.txt`` written for
one is read by the other.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple


@dataclasses.dataclass
class Config:
    # experiment
    expname: str = 'experiment'
    basedir: str = './logs'
    datadir: str = './data'

    # training
    lindisp: bool = False
    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    N_rand: int = 32 * 32 * 4
    lrate: float = 5e-4
    lrate_decay: int = 250
    lrate_decay_rate: float = 0.1
    decay_unit: int = 1000
    weight_decay: Optional[float] = None
    single_net: bool = False
    coarse_weight: float = 1.0
    use_temp_loss: bool = False
    use_temp_vel: bool = False
    temp_coef: float = 0.05
    chunk: int = 1024 * 32
    netchunk: int = 1024 * 64
    no_reload: bool = False
    ft_path: Optional[str] = None
    n_iters: int = 200000
    loss_fn: str = 'MSE'
    loss_beta: float = 0.1
    reg_fn: Optional[str] = None
    reg_coef: float = 0.1
    init_poseopt: Optional[str] = None
    no_poseopt_reload: bool = False
    finetune: bool = False
    fix_layer: int = 0
    use_yuv: bool = False

    # rendering
    density_scale: float = 1.0
    N_samples: int = 64
    N_importance: int = 0
    perturb: float = 1.0
    P_nms: float = 0.0
    use_viewdirs: bool = False
    i_embed: int = 0
    multires: int = 10
    multires_pts: int = 5
    multires_views: int = 4
    multires_bones: int = 0
    raw_noise_std: float = 0.0
    ray_noise_std: float = 0.0
    render_factor: int = 0
    save_image: bool = False

    # model
    nerf_type: str = 'nerf'
    density_type: str = 'relu'
    softplus_shift: float = 1.0
    # None: inferred from the dataset (ConcatH5Dataset meta n_subjects);
    # set explicitly to override (reference run_nerf.py:306)
    n_subjects: Optional[int] = None

    # per-frame codes
    opt_framecode: bool = False
    n_framecodes: Optional[int] = None
    framecode_size: int = 16

    # pose optimization
    opt_rot6d: bool = False
    opt_pose: bool = False
    opt_pose_stop: Optional[int] = None
    opt_pose_coef: float = 0.0
    opt_pose_tol: float = 0.0
    opt_pose_type: str = 'B'
    opt_pose_step: int = 1
    opt_pose_lrate: float = 5e-4
    opt_pose_lrate_decay: int = 250
    opt_pose_decay_rate: float = 1.0
    opt_pose_warmup: int = 0
    opt_pose_decay_unit: int = 400
    opt_pose_cache: bool = False
    opt_pose_joint: bool = False
    # Alternating NeRF-turn / pose-turn optimization (the reference's
    # PoseOptFlipFlop, pose_opt.py:584-727 — a legacy subsystem whose
    # flags were dropped from run_nerf.py's final parser; kept CLI-
    # reachable here).  The turn flips every opt_pose_interval steps;
    # per-frame CMA loss trackers run alongside, and opt_pose_reset
    # snapshots the pose bank at each pose-turn start.
    opt_pose_flipflop: bool = False
    opt_pose_interval: int = 100
    opt_pose_reset: bool = False
    testopt: bool = False
    use_ckpt_anchor: bool = False

    # dataset
    num_workers: int = 16
    dataset_type: Tuple[str, ...] = ('h36m',)
    subject: Tuple[str, ...] = ('S9',)
    use_val: bool = False
    white_bkgd: bool = False
    ext_scale: float = 0.001
    use_background: bool = False
    fg_ratio: Optional[float] = None
    kp_dist_type: str = 'reldist'
    view_type: str = 'relray'
    bone_type: str = 'reldir'
    pts_tr_type: str = 'local'
    train_skip: int = 1
    view_skip: int = 1
    N_cams: Optional[int] = None

    # cutoff embedder
    use_cutoff: bool = False
    normalize_cutoff: bool = False
    cutoff_mm: float = 500.0
    cutoff_inputs: bool = False
    cut_to_dist: bool = False
    cutoff_shift: bool = False
    cutoff_viewdir: bool = False
    opt_cutoff: bool = False
    cutoff_step: int = 250
    cutoff_rate: float = 10.0
    cutoff_bones: bool = False
    cutoff_ancestors: int = 5
    freq_schedule: bool = False
    freq_schedule_step: int = 5
    init_freq: float = 0.0

    # h36m / misc dataset
    multiview: bool = False
    training_res: float = 1.0
    val_seq: Tuple[int, ...] = (6, 18)
    rand_train_kps: Optional[str] = None
    N_sample_images: int = 8
    image_batching: bool = False
    mask_image: bool = False
    patch_size: int = 1
    load_refined: bool = False

    # logging
    i_print: int = 100
    i_weights: int = 10000
    i_pose_weights: int = 2000
    i_testset: int = 50000
    i_video: int = 10000
    debug: bool = False

    # --- additions absent in the reference (shared with anerf_tpu) ---
    seed: int = 0
    compute_dtype: str = 'float32'   # 'bfloat16' for tensor-core matmuls
    # 'auto' | 'xla' | 'pallas' (the names anerf_tpu uses).  In the port
    # 'auto' and 'pallas' select the hand-written fused encode+MLP
    # kernels (anerf_torch/ops/fused_encmlp.py), 'xla' the plain
    # unfused encode + MLP path.
    mlp_backend: str = 'auto'
    remat: bool = True               # recompute encodings in backward
    # per-ray view factorization inside the fused kernels (anerf_tpu;
    # K1-K4 where its cost gate picks it, ops/fused_encmlp.py)
    viewfac: bool = True
    # in-kernel rigid transform inside the fused kernels (anerf_tpu; K1-K4
    # build the points from per-ray affine rows and depths,
    # ops/fused_encmlp.tform_rows; off by default, and off under ray noise)
    fuse_tform: bool = False
    data_axis: str = 'data'          # mesh axis name for ray sharding
    n_devices: Optional[int] = None  # None = all visible devices
    # bundle k train steps into one dispatch (anerf_tpu trainer)
    steps_per_dispatch: int = 1

    def __post_init__(self):
        if self.nerf_type != 'nerf':
            raise NotImplementedError(
                f"nerf_type={self.nerf_type!r}: only 'nerf' is supported "
                "(the reference's minerf branch, run_render.py:282, is a "
                "separate unreleased model family)")
        if self.weight_decay is not None:
            raise ValueError(
                'weight_decay is not supported: the reference branch '
                '(raycasters.py:219-227) is an empty `pass` that silently '
                'drops every trainable parameter — set it to None')
        for name in _PARSED_ONLY:
            if getattr(self, name) != _FIELD_TYPES[name].default:
                import warnings
                warnings.warn(
                    f'config flag {name!r} is parsed for recipe parity but '
                    'has NO consumer (same in the reference: the flag is '
                    'a nerf-pytorch leftover that core/ never reads)',
                    stacklevel=2)

    def to_args_txt(self) -> str:
        """Serialize in the reference args.txt format (sorted keys,
        ``key = value`` lines) for render-script round-trips."""
        lines = []
        for f in sorted(dataclasses.fields(self), key=lambda f: f.name):
            v = getattr(self, f.name)
            if isinstance(v, tuple):
                v = list(v)
            lines.append(f'{f.name} = {v}')
        return '\n'.join(lines) + '\n'


_FIELD_TYPES = {f.name: f for f in dataclasses.fields(Config)}
_LIST_FIELDS = {'dataset_type', 'subject', 'val_seq'}
# flags the reference parser accepts but core/ never reads (nerf-pytorch
# leftovers; its shipped recipes still set the first two) — parsed for
# recipe parity, warned on when set (see Config.__post_init__)
_PARSED_ONLY = ('image_batching', 'fg_ratio', 'i_video', 'cutoff_ancestors')


def _parse_value(name: str, raw: str):
    raw = raw.strip()
    f = _FIELD_TYPES.get(name)
    if raw in ('None', 'none', 'null'):
        return None
    if raw.startswith('[') and raw.endswith(']'):
        items = [x.strip().strip("'\"") for x in raw[1:-1].split(',') if x.strip()]
        return tuple(_parse_scalar(name, x) for x in items)
    if name in _LIST_FIELDS:
        items = raw.split()
        return tuple(_parse_scalar(name, x) for x in items)
    return _parse_scalar(name, raw)


def _annotated_type(name: str) -> str:
    """The field's annotation as a string ('int', 'Optional[float]', ...)."""
    t = _FIELD_TYPES[name].type
    return t if isinstance(t, str) else getattr(t, '__name__', str(t))


def _parse_scalar(name: str, raw: str):
    """Typed scalar parse; raises ValueError on a value that does not fit
    the field's declared type (a typo'd value must not silently train
    with a string where a number belongs)."""
    if name in _LIST_FIELDS:
        if name == 'val_seq':
            return int(raw)
        return raw.strip("'\"")
    t = _annotated_type(name)
    try:
        if 'bool' in t:
            if raw in ('True', 'true', '1'):
                return True
            if raw in ('False', 'false', '0'):
                return False
            raise ValueError(raw)
        if 'int' in t:
            v = float(raw)
            if v != int(v):
                raise ValueError(raw)
            return int(v)
        if 'float' in t:
            return float(raw)
    except ValueError:
        raise ValueError(
            f'config flag {name!r} expects {t}, got {raw!r}') from None
    return raw.strip("'\"")


def parse_config_txt(path: str, allow_unknown: bool = False) -> dict:
    """Parse a reference-style config/args txt file into a dict.

    Unknown keys raise (the opposite of silently training with defaults
    after a typo); pass ``allow_unknown`` to skip them when importing a
    foreign args.txt.
    """
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split('#', 1)[0].strip()
            if not line or '=' not in line:
                continue
            k, v = line.split('=', 1)
            k = k.strip().lstrip('-')
            if k not in _FIELD_TYPES:
                if allow_unknown or k == 'config':
                    continue
                raise ValueError(
                    f'unknown config flag {k!r} in {path} '
                    '(pass allow_unknown=True to skip foreign flags)')
            out[k] = _parse_value(k, v)
    return out


def load_config(config_path: Optional[str] = None, **overrides) -> Config:
    """Build a Config from an optional txt file plus overrides."""
    kwargs = {}
    if config_path is not None:
        kwargs.update(parse_config_txt(config_path))
    kwargs.update(overrides)
    return Config(**kwargs)


def config_from_cli(argv: List[str]) -> Config:
    """Minimal CLI: ``--config path.txt --flag value --boolflag``."""
    kwargs = {}
    config_path = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith('--'):
            raise ValueError(f'unexpected argument {a}')
        name = a[2:]
        if name == 'config':
            config_path = argv[i + 1]
            i += 2
            continue
        if name not in _FIELD_TYPES:
            raise ValueError(f'unknown flag --{name}')
        default = _FIELD_TYPES[name].default
        if isinstance(default, bool):
            # support both "--flag" and "--flag True"
            if i + 1 < len(argv) and argv[i + 1] in ('True', 'False',
                                                     'true', 'false'):
                kwargs[name] = argv[i + 1] in ('True', 'true')
                i += 2
            else:
                kwargs[name] = True
                i += 1
        else:
            kwargs[name] = _parse_value(name, argv[i + 1])
            i += 2
    return load_config(config_path, **kwargs)


def save_args_txt(cfg: Config, logdir: str) -> str:
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, 'args.txt')
    with open(path, 'w') as f:
        f.write(cfg.to_args_txt())
    return path
