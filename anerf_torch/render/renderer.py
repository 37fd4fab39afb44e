"""Full-image rendering: valid-ray selection and padded fixed-size chunks.

Port of ``anerf_tpu/render/renderer.py`` (reference run_nerf.py:27-145
``render_path``, core/trainer.py:64-145 ``render``/``batchify_rays``,
core/utils/ray_utils.py:83-136 ``kp_to_valid_rays``), single device.

Each image's valid rays (inside the projected cylinder box) are padded
to a multiple of the chunk size and rendered chunk by chunk, as the JAX
renderer does: rays that miss the cylinder take their chunk's mean
near/far, so the chunking is part of the result.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..interop import params_to
from ..models.raycaster import RayCastConfig, render_rays
from ..ops.cylinder import (cylinder_to_box_2d, get_kp_bounding_cylinder,
                            nerf_c2w_to_extrinsic)
from ..ops.rays import get_rays_np
from ..utils.device import resolve_device  # noqa: F401 (re-export)
from ..utils.image import bilinear_resize


def kp_to_valid_rays(c2ws, H, W, focals, kps=None, cylinder_params=None,
                     centers=None, ext_scale=0.00035
                     ) -> Tuple[List, List, np.ndarray, List]:
    """Rays restricted to the projected cylinder box per pose
    (reference ray_utils.py:83-136).  Returns (rays list of (rays_o,
    rays_d), valid_idxs list, cylinder params, bboxes)."""
    if cylinder_params is None:
        assert kps is not None
        cylinder_params = get_kp_bounding_cylinder(
            np.asarray(kps), ext_scale=ext_scale, extend_mm=250,
            top_expand_ratio=1.60, bot_expand_ratio=1.10, head='-y')

    rays, valid_idxs, bboxes = [], [], []
    for i, c2w in enumerate(c2ws):
        cyl = cylinder_params[i % len(cylinder_params)]
        f = focals if np.isscalar(focals) else focals[i]
        h = H if np.isscalar(H) else H[i]
        w = W if np.isscalar(W) else W[i]
        center = None if centers is None else centers[i]

        ray_o, ray_d = get_rays_np(int(h), int(w), float(f) if np.isscalar(f)
                                   else f, np.asarray(c2w), center=center)
        w2c = nerf_c2w_to_extrinsic(np.asarray(c2w))
        tl, br, _ = cylinder_to_box_2d(cyl, [int(h), int(w), f], w2c,
                                       center=center)
        hh, ww = np.meshgrid(np.arange(tl[1], br[1]),
                             np.arange(tl[0], br[0]), indexing='ij')
        valid = (hh * int(w) + ww).reshape(-1)
        rays.append((ray_o.reshape(-1, 3)[valid],
                     ray_d.reshape(-1, 3)[valid]))
        valid_idxs.append(valid)
        bboxes.append((tl, br))
    return rays, valid_idxs, cylinder_params, bboxes


class ImageRenderer:
    """Chunked full-image renderer on one device.

    ``device=None`` renders on the GPU and raises when there is none;
    pass ``device='cpu'`` to render on the CPU (the kernels' plain twins
    then stand in for them).
    """

    def __init__(self, rc: RayCastConfig, params, state: Dict[str, Any],
                 chunk: int = 4096, near: float = 0., far: float = 1.,
                 white_bkgd: bool = False, device=None):
        self.device = resolve_device(device)
        self.rc = rc.eval_variant()
        self.params = params_to(params, self.device)
        self.state = {k: None if v is None else torch.as_tensor(
            v, dtype=torch.float32, device=self.device)
            for k, v in state.items()}
        self.chunk = chunk
        self.near = near
        self.far = far
        self.white_bkgd = white_bkgd

    def _render_chunk(self, rays_o, rays_d, pose, cam_idxs):
        with torch.inference_mode():
            out = render_rays(self.rc, self.params, rays_o, rays_d,
                              self.near, self.far, pose, self.state,
                              cam_idxs=cam_idxs)
        return {'rgb_map': out['rgb_map'], 'disp_map': out['disp_map'],
                'acc_map': out['acc_map']}

    def render_rays_np(self, rays_o: np.ndarray, rays_d: np.ndarray,
                       kp: np.ndarray, skt: np.ndarray, bone: np.ndarray,
                       cyl: np.ndarray, cam_idx=-1) -> Dict[str, np.ndarray]:
        """Render any number of rays for one pose; the tail chunk is
        padded with copies of the last ray."""
        n = rays_o.shape[0]
        C = self.chunk
        n_pad = (n + C - 1) // C * C
        pad = n_pad - n
        ro = np.concatenate([rays_o, np.repeat(rays_o[-1:], pad, 0)], 0)
        rd = np.concatenate([rays_d, np.repeat(rays_d[-1:], pad, 0)], 0)
        dev = self.device
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        pose = {
            'kps': t(kp).expand(C, 24, 3),
            'skts': t(skt).expand(C, 24, 4, 4),
            'bones': t(bone).expand((C,) + tuple(np.shape(bone)[-2:])),
            'cyls': t(cyl).expand(C, 5),
        }
        # cam_idx: int frame index, or a length-3 [idx_a, idx_b, w]
        # framecode-mixing row (models.nerf_mlp.framecode_select)
        if np.ndim(cam_idx) == 1:
            cam = t(cam_idx).expand(C, 3)
        else:
            cam = torch.full((C,), int(cam_idx), dtype=torch.long,
                             device=dev)
        ro_t, rd_t = t(ro), t(rd)
        # every chunk is queued before any result comes back to the host
        rets = [self._render_chunk(ro_t[s:s + C], rd_t[s:s + C], pose, cam)
                for s in range(0, n_pad, C)]
        return {k: torch.cat([r[k] for r in rets]).cpu().numpy()[:n]
                for k in ('rgb_map', 'disp_map', 'acc_map')}

    def render_image(self, H: int, W: int, focal, c2w,
                     kp, skt, bone, cyl=None, center=None, cam_idx=-1,
                     bg: Optional[np.ndarray] = None,
                     ext_scale: float = 0.001) -> Dict[str, np.ndarray]:
        """Render a full image, casting only rays inside the projected
        cylinder box and compositing onto the background (reference
        render_path, run_nerf.py:27-145)."""
        if cyl is None:
            cyl = get_kp_bounding_cylinder(kp[None], ext_scale=ext_scale,
                                           extend_mm=250,
                                           top_expand_ratio=1.60,
                                           bot_expand_ratio=1.10,
                                           head='-y')[0]
        rays, valid_idxs, _, bboxes = kp_to_valid_rays(
            [c2w], H, W, focal, cylinder_params=cyl[None],
            centers=None if center is None else [center])
        rays_o, rays_d = rays[0]
        valid = valid_idxs[0]

        if bg is not None:
            rgb = bg.reshape(H * W, 3).astype(np.float32).copy()
        elif self.white_bkgd:
            rgb = np.ones((H * W, 3), np.float32)
        else:
            rgb = np.zeros((H * W, 3), np.float32)
        disp = np.zeros((H * W,), np.float32)
        acc = np.zeros((H * W,), np.float32)

        if len(valid) > 0:
            ret = self.render_rays_np(rays_o, rays_d, kp, skt, bone, cyl,
                                      cam_idx)
            base = rgb[valid]
            rgb[valid] = ret['rgb_map'] + (1. - ret['acc_map'][:, None]) \
                * base
            disp[valid] = np.nan_to_num(ret['disp_map'])
            acc[valid] = ret['acc_map']

        return {'rgb': rgb.reshape(H, W, 3),
                'disp': disp.reshape(H, W),
                'acc': acc.reshape(H, W),
                'bbox': bboxes[0]}

    def render_path(self, render_data: Dict[str, Any],
                    ext_scale: float = 0.001,
                    render_factor: int = 0,
                    verbose: bool = False) -> Dict[str, np.ndarray]:
        """Render a sequence of poses (reference run_nerf.py:27-145).
        ``render_factor`` > 0 renders at (H//f, W//f) with focal and
        centers scaled to match."""
        H, W, focals = render_data['hwf']
        c2ws = render_data['c2ws']
        kps = render_data['kp3d']
        skts = render_data['skts']
        bones = render_data['bones']
        cyls = render_data.get('cyls')
        centers = render_data.get('center')
        cam_idxs = render_data.get('cam_idxs')
        bgs = render_data.get('bgs')
        bg_idxs = render_data.get('bg_idxs')

        rgbs, disps, accs, bboxes = [], [], [], []
        for i in range(len(c2ws)):
            t0 = time.time()
            h = int(H if np.isscalar(H) else H[i])
            w = int(W if np.isscalar(W) else W[i])
            f = focals if np.isscalar(focals) else focals[i]
            center = None if centers is None else np.asarray(centers[i])
            if render_factor:
                h, w = h // render_factor, w // render_factor
                f = f / render_factor
                if center is not None:
                    center = center / render_factor
            kp_i = kps[i % len(kps)]
            bg = None
            if bgs is not None:
                bg = bgs[bg_idxs[i] if bg_idxs is not None else 0]
                if bg.shape[:2] != (h, w):
                    bg = bilinear_resize(np.asarray(bg, np.float32), h, w)
            out = self.render_image(
                h, w, f, c2ws[i], kp_i, skts[i % len(skts)],
                bones[i % len(bones)],
                cyl=None if cyls is None else cyls[i % len(cyls)],
                center=center,
                cam_idx=(-1 if cam_idxs is None else
                         np.asarray(cam_idxs[i], np.float32)
                         if np.ndim(cam_idxs[i]) == 1 else int(cam_idxs[i])),
                bg=bg, ext_scale=ext_scale)
            rgbs.append(out['rgb'])
            disps.append(out['disp'])
            accs.append(out['acc'])
            bboxes.append(out['bbox'])
            if verbose:
                print(f'render {i}: {time.time() - t0:.3f}s')
        return {'rgbs': np.stack(rgbs), 'disps': np.stack(disps),
                'accs': np.stack(accs), 'bboxes': bboxes}
