"""Rendering, evaluation and mesh-extraction entry point of the port: the
twin of the root ``run_render.py``.

    python -m anerf_torch.run_render --nerf_args logs/exp/args.txt \
        --ckptpath logs/exp/ckpt_00150000.pt \
        --render_type bullet --selected_idxs 0 \
        --outputdir render_output --runname demo [--eval] [--white_bkgd]

Render types (reference run_render.py:301-471 catalog):
  val | bullet | interpolate | retarget | animate | poserot | bubble |
  correction | selected | mesh

The same flags, flow and outputs as ``run_render.py``: ``%04d.png``
frames and ``<render_type>.mp4`` (per-frame ``<render_type>_%04d.png``
where imageio cannot write the mp4, or is not installed, as on the
card's machine), ``mesh_%05d.ply`` with its turntable, and with
``--eval`` ``scores.npy`` and ``score_final.txt``.  Data comes from a
numpy data store (``--dataset_path``, the config's ``datadir``, or a
catalog entry's store); ``--ckptpath`` takes the port's ``ckpt_*.pt``,
anerf_tpu's ``.msgpack`` or the reference's ``.tar``.

``main(argv, device=None)`` is the function form: ``device=None``
renders on the GPU and raises without one; pass ``device='cpu'`` to
render on the CPU (the fused kernels' plain twins stand in).  It
returns what it rendered (see ``main``).

``--mesh_devices N`` shards each chunk of rays over N ranks, one a
device (``render.renderer.ImageRenderer``'s ``mesh``), launched as

    python -m torch.distributed.run --nproc_per_node N \
        -m anerf_torch.run_render --mesh_devices N ...

Every rank renders its block of every chunk and gets the frames back;
rank 0 alone writes the files (a mesh is extracted on rank 0 alone).
N must be the number of ranks.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, List

import numpy as np

RENDER_TYPES = ('val', 'bullet', 'interpolate', 'retarget', 'animate',
                'poserot', 'bubble', 'correction', 'selected', 'mesh')


def parse_args(argv):
    p = argparse.ArgumentParser()
    p.add_argument('--nerf_args', type=str, required=True,
                   help='path to the training args.txt')
    p.add_argument('--ckptpath', type=str, required=True,
                   help='checkpoint (the port\'s .pt, anerf_tpu\'s '
                        '.msgpack, or reference .tar)')
    p.add_argument('--render_type', type=str, default='bullet',
                   choices=RENDER_TYPES + ('val2',))
    p.add_argument('--entry', type=str, default=None,
                   help="catalog entry 'dataset/subject' (e.g. surreal/"
                        'hard): fills dataset path, selected idxs and '
                        'generator params for --render_type from the '
                        'curated catalog (reference run_render.py:301-471)')
    p.add_argument('--data_root', type=str, default='data',
                   help='root the catalog data paths resolve against')
    p.add_argument('--ckpt_root', type=str,
                   default='neurips21_ckpt/trained/ours',
                   help='root the catalog refined-ckpt paths resolve '
                        'against')
    p.add_argument('--render_res', type=int, nargs=2, default=None,
                   help='override H W')
    p.add_argument('--selected_idxs', type=int, nargs='+', default=None)
    p.add_argument('--n_bullet', type=int, default=None)
    p.add_argument('--n_step', type=int, default=None)
    p.add_argument('--joints', type=int, nargs='+',
                   default=None, help='joints for animate')
    p.add_argument('--mix_framecodes', action='store_true',
                   help='interpolate renders: blend the two endpoint '
                        'frames\' appearance codes with the pose lerp '
                        'weight (reference Optcodes 2-idx path, '
                        'embedding.py:24-28)')
    p.add_argument('--render_refined', action='store_true',
                   help='use refined poses from the checkpoint pose bank')
    p.add_argument('--white_bkgd', action='store_true')
    p.add_argument('--eval', action='store_true',
                   help='compute PSNR/SSIM vs dataset images (val only)')
    p.add_argument('--outputdir', type=str, default='render_output')
    p.add_argument('--runname', type=str, default='run')
    p.add_argument('--fps', type=int, default=14)
    p.add_argument('--mesh_res', type=int, default=128)
    p.add_argument('--mesh_thres', type=float, default=10.)
    p.add_argument('--dataset_path', type=str, default=None,
                   help='override the data store path (e.g. synthetic '
                        'data)')
    p.add_argument('--chunk', type=int, default=None)
    p.add_argument('--mesh_devices', type=int, default=0,
                   help='>1: shard each render chunk over this many '
                        'ranks, one a device (launched by torchrun); '
                        'the chunk must split evenly')
    p.add_argument('--render_factor', type=int, default=0,
                   help='downsample factor for fast renders '
                        '(reference run_nerf.py:37-48)')
    return p.parse_args(argv)


def apply_entry(args):
    """Fill CLI defaults from the curated catalog entry (reference
    run_render.py:116-155).  Returns extra generator kwargs the entry
    carries (undo_rot / center_cam / center_kps / length / skip)."""
    gen_kwargs = {}
    args.refined_path = None
    args.entry_h5 = None
    args.idx_map = None
    if args.entry:
        from .render.catalog import resolve_entry
        ent = resolve_entry(args.entry, args.render_type,
                            data_root=args.data_root,
                            ckpt_root=args.ckpt_root)
        args.entry_h5 = ent['data_h5']
        args.refined_path = ent.get('refined')
        idx_map = ent.get('idx_map')
        if idx_map is not None and len(idx_map):
            args.idx_map = np.asarray(idx_map)
        if args.selected_idxs is None:
            args.selected_idxs = [int(i) for i in ent['selected_idxs']]
        for k in ('n_bullet', 'n_step', 'joints'):
            if getattr(args, k) is None and k in ent:
                setattr(args, k, ent[k])
        gen_kwargs = {k: ent[k] for k in
                      ('undo_rot', 'center_cam', 'center_kps', 'length',
                       'skip') if k in ent}
    args.explicit_idxs = args.selected_idxs is not None
    if args.selected_idxs is None:
        args.selected_idxs = [0]
    if args.n_bullet is None:
        args.n_bullet = 30
    if args.n_step is None:
        args.n_step = 10
    if args.joints is None:
        args.joints = [16, 18, 20]
    return gen_kwargs


def _accepts(fn, kwargs):
    """Keep only the kwargs ``fn`` actually takes."""
    import inspect
    names = set(inspect.signature(fn).parameters)
    return {k: v for k, v in kwargs.items() if k in names}


def load_everything(args):
    """(cfg, rc, params, state, step, pose_params, dataset, data_attrs)
    from the training args, the data store and the checkpoint; params
    are CPU tensors."""
    import torch
    from .data.loaders import get_dataset
    from .interop import tree_map
    from .models.factory import build_raycast_config, embed_state
    from .training.checkpoint import load_checkpoint, load_torch_checkpoint
    from .utils.config import load_config

    cfg = load_config(args.nerf_args)
    if args.dataset_path is not None:
        cfg.dataset_type = ('synthetic',)
        cfg.datadir = args.dataset_path
    if args.chunk:
        cfg.chunk = args.chunk

    # catalog entry overrides the store location but keeps the dataset
    # class from the training args
    dataset = get_dataset(cfg, h5_override=getattr(args, 'entry_h5', None))
    data_attrs = dataset.get_meta()
    n_framecodes = int(data_attrs['n_views'])
    rc = build_raycast_config(cfg, skel=data_attrs['skel_type'],
                              n_framecodes=n_framecodes)

    if args.ckptpath.endswith('.tar'):
        loaded = load_torch_checkpoint(args.ckptpath)
        params = loaded['params']
        step = loaded['global_step']
        pose_params = loaded.get('pose_params')
    else:
        ckpt = load_checkpoint(args.ckptpath)
        params = ckpt['params']
        step = int(ckpt['step'])
        pose_params = ckpt.get('pose_params')
    if params.get('cutoff_dist') is None:
        from .skeleton import SMPLSkeleton
        params['cutoff_dist'] = np.asarray(
            SMPLSkeleton.cutoff_dists(1.0, cfg.cutoff_mm) * cfg.ext_scale)
    params = tree_map(lambda a: a if torch.is_tensor(a) else
                      torch.as_tensor(np.asarray(a, np.float32)), params)
    state = embed_state(cfg, rc, step)
    return cfg, rc, params, state, step, pose_params, dataset, data_attrs


def get_poses(args, cfg, data_attrs, pose_params):
    """(kps, bones) source: dataset meta, the checkpoint pose bank, or
    the catalog entry's refined-pose checkpoint (reference
    --render_refined + catalog 'refined' paths)."""
    if args.render_refined:
        refined = getattr(args, 'refined_path', None)
        if refined and os.path.exists(refined):
            from .training.checkpoint import load_refined_pose_data
            kp3d, bones = load_refined_pose_data(
                refined, ext_scale=cfg.ext_scale)[:2]
            return np.asarray(kp3d), np.asarray(bones)
        if pose_params is not None:
            from .training.pose_opt import pose_params_to_pose_data
            kp3d, bones = pose_params_to_pose_data(
                pose_params, data_attrs['rest_pose'],
                ext_scale=cfg.ext_scale)[:2]
            return kp3d, bones
    return data_attrs['kp3d'], data_attrs['bones']


def _render_data(args, gen_kwargs, dataset, data_attrs, kps, bones,
                 rest_pose, sel):
    """The render_data dict of ``args.render_type`` (all but mesh)."""
    from .render import poses as pose_gen
    c2ws = data_attrs['c2ws']
    focals = data_attrs['hwf'][2]
    common = (kps, bones, c2ws, focals, rest_pose, sel)
    rt = args.render_type
    if rt in ('val', 'val2'):
        return dataset.get_render_data(sel if args.explicit_idxs else None)
    if rt == 'bullet':
        return pose_gen.load_bullettime(
            *common, n_bullet=args.n_bullet,
            **_accepts(pose_gen.load_bullettime, gen_kwargs))
    if rt == 'interpolate':
        return pose_gen.load_interpolate(
            *common, n_step=args.n_step,
            **_accepts(pose_gen.load_interpolate, gen_kwargs))
    if rt == 'retarget':
        return pose_gen.load_retarget(
            *common, **_accepts(pose_gen.load_retarget, gen_kwargs))
    if rt == 'animate':
        return pose_gen.load_animate(
            *common, joints=args.joints, n_step=args.n_step,
            **_accepts(pose_gen.load_animate, gen_kwargs))
    if rt == 'poserot':
        return pose_gen.load_pose_rotate(
            *common, n_bullet=args.n_bullet,
            **_accepts(pose_gen.load_pose_rotate, gen_kwargs))
    if rt == 'bubble':
        return pose_gen.load_bubble(
            *common, n_step=args.n_step,
            **_accepts(pose_gen.load_bubble, gen_kwargs))
    if rt == 'correction':
        return pose_gen.load_correction(
            data_attrs['kp3d'], data_attrs['bones'], *common,
            n_step=args.n_step)
    if rt == 'selected':
        return pose_gen.load_selected(*common)
    raise NotImplementedError(rt)


def mesh_pose(kps, bones, rest_pose, idx, device) -> Dict[str, Any]:
    """Frame ``idx``'s pose as ``render.mesh`` takes it: kps (1, J, 3),
    skts (1, J, 4, 4) and bones (1, J, 3) tensors on ``device``."""
    import torch
    from .ops.fk import get_smpl_l2ws_np
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    l2ws = get_smpl_l2ws_np(bones[idx], rest_pose)
    l2ws[..., :3, 3] += kps[idx, :1]
    return {'kps': t(l2ws[None, :, :3, 3]),
            'skts': t(np.linalg.inv(l2ws)[None]),
            'bones': t(bones[idx][None])}


def _meshes(args, rc, renderer, kps, bones, rest_pose, sel, outdir
            ) -> List[Dict[str, Any]]:
    """Extract, save and turntable-render one mesh per selected frame."""
    from .render.mesh import extract_mesh, render_turntable, save_ply
    from .utils.logging import save_video

    out = []
    for idx in sel:
        pose = mesh_pose(kps, bones, rest_pose, idx, renderer.device)
        verts, faces = extract_mesh(rc, renderer.params, pose, radius=1.0,
                                    res=args.mesh_res,
                                    threshold=args.mesh_thres,
                                    state=renderer.state)
        ply = os.path.join(outdir, f'mesh_{idx:05d}.ply')
        save_ply(ply, verts, faces)
        print(f'saved {ply}: {len(verts)} verts, {len(faces)} faces')
        if len(verts) > 0:
            frames = render_turntable(verts, faces, n_views=20,
                                      H=256, W=256)
            save_video(os.path.join(outdir, f'mesh_{idx:05d}.mp4'),
                       frames, fps=args.fps)
        out.append({'idx': int(idx), 'verts': verts, 'faces': faces,
                    'pose': pose})
    return out


def main(argv, device=None) -> Dict[str, Any]:
    """Run the render CLI on ``device`` (None: the GPU, raising without
    one).  Returns {'outdir', 'renderer', 'render_data', and
    ``render_path``'s 'rgbs', 'disps', 'accs', 'bboxes'} for a render, or
    {'outdir', 'renderer', 'meshes': [{'idx', 'verts', 'faces', 'pose'},
    ...]} for ``mesh``."""
    import torch
    from .parallel.sharding import init_distributed, make_mesh
    from .utils.device import resolve_device
    args = parse_args(argv)
    # several ranks: join the job torchrun describes (one process: a
    # no-op); --mesh_devices must be its size
    init_distributed(backend='gloo' if device is not None and torch.device(
        device).type == 'cpu' else None)
    mesh = make_mesh(args.mesh_devices or None)
    rank0 = mesh.rank == 0
    device = resolve_device(device)
    gen_kwargs = apply_entry(args)
    if args.mix_framecodes:
        gen_kwargs['mix_framecodes'] = True  # consumed by load_interpolate
    from .eval.metrics import evaluate_images
    from .render.renderer import ImageRenderer
    from .utils.logging import save_images, save_video

    cfg, rc, params, state, step, pose_params, dataset, data_attrs = \
        load_everything(args)
    outdir = os.path.join(args.outputdir, args.runname)
    if rank0:
        os.makedirs(outdir, exist_ok=True)

    rest_pose = np.asarray(data_attrs['rest_pose'], np.float32)
    kps, bones = get_poses(args, cfg, data_attrs, pose_params)
    H, W, focals = data_attrs['hwf']
    Hs = int(np.atleast_1d(H)[0])
    Ws = int(np.atleast_1d(W)[0])
    if args.render_res is not None:
        scale = args.render_res[0] / Hs
        Hs, Ws = args.render_res
        focals = np.asarray(focals) * scale
    f0 = float(np.atleast_1d(focals)[0])
    sel = np.asarray(args.selected_idxs)
    if args.idx_map is not None:
        from .render.catalog import find_idxs_with_map
        sel = find_idxs_with_map(sel, args.idx_map)

    renderer = ImageRenderer(rc, params, state,
                             chunk=args.chunk or cfg.chunk,
                             near=0., far=1., white_bkgd=args.white_bkgd,
                             device=device, mesh=mesh)

    if args.render_type == 'mesh':
        return {'outdir': outdir, 'renderer': renderer,
                'meshes': _meshes(args, rc, renderer, kps, bones,
                                  rest_pose, sel, outdir) if rank0 else []}

    render_data = _render_data(args, gen_kwargs, dataset, data_attrs, kps,
                               bones, rest_pose, sel)
    n = len(render_data['c2ws'])
    if 'hwf' not in render_data:
        render_data['hwf'] = (np.full(n, Hs), np.full(n, Ws),
                              np.asarray(render_data.get('focals', f0)))
    out = renderer.render_path(render_data, ext_scale=cfg.ext_scale,
                               render_factor=args.render_factor,
                               verbose=rank0)
    if not rank0:
        return dict(out, outdir=outdir, renderer=renderer,
                    render_data=render_data)
    save_images(outdir, out['rgbs'])
    save_video(os.path.join(outdir, f'{args.render_type}.mp4'),
               out['rgbs'], fps=args.fps)
    print(f'rendered {len(out["rgbs"])} frames to {outdir}')

    if args.eval and render_data.get('imgs') is not None:
        m = evaluate_images(out['rgbs'], render_data['imgs'],
                            fgs=render_data.get('fgs'),
                            bboxes=out['bboxes'])
        np.save(os.path.join(outdir, 'scores.npy'), m)
        with open(os.path.join(outdir, 'score_final.txt'), 'w') as f:
            for k, v in m.items():
                f.write(f'{k}: {np.nanmean(v):.4f}\n')
        print({k: float(np.nanmean(v)) for k, v in m.items()})
    return dict(out, outdir=outdir, renderer=renderer,
                render_data=render_data)


if __name__ == '__main__':
    main(sys.argv[1:])
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
