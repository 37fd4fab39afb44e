"""Store-backed ray dataset: per-image pixel sampling -> flat ray batches.

Port of ``anerf_tpu/data/dataset.py`` (reference core/dataset.py) over
a numpy data store (``data/store.py``) in place of HDF5: every array is
a read-only memmap, so pixel gathers read through the page cache.  The
sampling is anerf_tpu's, draw for draw: for the same
``numpy.random.Generator`` the port's batches equal anerf_tpu's
(with its numpy loader, ``ANERF_NO_NATIVE=1``) bit for bit.  anerf_tpu's
native gather (``data/native/gather.cc``) is not ported: the distinct
pixel draw is its numpy fallback's partial Fisher-Yates, vectorized
over the batch's images.

Batch arrays keep fixed shapes (N_rand rays), with the index arrays
(``kp_idx``, ``cam_idxs``, ``subject_idxs``) int32;
``pipeline.DeviceFeeder`` moves them to the device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..ops.cylinder import cylinder_to_box_2d, nerf_c2w_to_extrinsic
from ..skeleton import SMPLSkeleton, get_per_joint_coords
from .store import open_store


def sample_distinct(valid_lists, u: np.ndarray) -> np.ndarray:
    """Distinct draw per row: row r picks ``u.shape[1]`` distinct entries
    of ``valid_lists[r]``, uniformly without replacement, driven by the
    uniforms ``u[r]``: anerf_tpu's partial Fisher-Yates
    (``data/native/__init__.py`` ``sample_distinct``), whose swap map
    is here an array of the (key, value) pairs set so far, read at the
    last pair with the key, for all rows at once.  Returns (rows, k)
    int32."""
    rows, k = u.shape
    lens = np.array([len(v) for v in valid_lists], np.int64)
    keys = np.empty((rows, k), np.int64)
    vals = np.empty((rows, k), np.int64)
    picks = np.empty((rows, k), np.int64)
    ar = np.arange(rows)

    def lookup(x, n):      # swap.get(x, x) over the first n pairs
        if n == 0:
            return x
        hit = keys[:, :n] == x[:, None]
        last = n - 1 - np.argmax(hit[:, ::-1], axis=1)
        return np.where(hit.any(1), vals[ar, last], x)

    for i in range(k):
        j = np.minimum(i + (u[:, i] * (lens - i)).astype(np.int64), lens - 1)
        picks[:, i] = lookup(j, i)
        vals[:, i] = lookup(np.full(rows, i, np.int64), i)
        keys[:, i] = j
    out = np.empty((rows, k), np.int32)
    for r in range(rows):
        out[r] = valid_lists[r][picks[r]]
    return out


def _gather_f32(row: np.ndarray, idxs: np.ndarray,
                scale: float = 1.0) -> np.ndarray:
    """``row[idxs].astype(float32) * scale``."""
    out = np.asarray(row)[idxs].astype(np.float32)
    if scale != 1.0:
        out *= np.float32(scale)
    return out


class BaseDataset:
    """Per-``get_item`` returns one image's ray batch (reference
    BaseH5Dataset.__getitem__, dataset.py:57-105); ``get_batch`` a whole
    batch of images at once."""

    render_skip = 1
    N_render = 15

    def __init__(self, path: str, N_samples: int = 96, patch_size: int = 1,
                 split: str = 'full', N_nms: float = 0, subject: str = None,
                 mask_img: bool = False, multiview: bool = False):
        self.path = path
        self.split = split
        self.dataset = None  # the store's memmaps, opened on first use
        # sampling masks are static per run, so each image's valid-pixel
        # index list is computed once and reused (FIFO-capped: 1024
        # entries are ~160 MB at worst at 512x512)
        self._valid_cache: Dict[int, np.ndarray] = {}
        self._valid_cache_max = 1024
        # with the pose bank on the device (trainer.get_batch_pose) the
        # per-ray kps/skts/bones are dead weight; load_data turns them
        # off through set_pose_per_ray
        self.pose_per_ray = True
        self.subject = subject
        self.mask_img = mask_img
        self.multiview = multiview

        self.N_samples = N_samples
        self.patch_size = patch_size
        self.N_nms = int(math.floor(N_nms)) if N_nms >= 1.0 else float(N_nms)
        self._idx_map = None
        self._render_idx_map = None

        self.init_meta()
        self.init_len()
        self.box2d = None
        if self.N_nms > 0.0:
            self.init_box2d()

    # --- setup -----------------------------------------------------------

    def init_len(self):
        if self._idx_map is not None:
            self.data_len = len(self._idx_map)
        else:
            self.data_len = len(open_store(self.path)['imgs'])

    def __len__(self):
        return self.data_len

    def init_dataset(self):
        if self.dataset is None:
            self.dataset = open_store(self.path)

    def _valid_pixels(self, idx: int) -> np.ndarray:
        """Cached valid-pixel indices of one image's sampling mask."""
        v = self._valid_cache.get(idx)
        if v is None:
            sm = np.asarray(self._read_row('sampling_masks', idx)).reshape(-1)
            v = np.where(sm > 0)[0]
            v = v.astype(np.int32) if len(v) else \
                np.arange(sm.shape[0], dtype=np.int32)
            if len(self._valid_cache) >= self._valid_cache_max:
                try:  # concurrent workers may race the eviction
                    self._valid_cache.pop(next(iter(self._valid_cache)))
                except (KeyError, StopIteration):
                    pass
            self._valid_cache[idx] = v
        return v

    def _read_row(self, key: str, idx: int) -> np.ndarray:
        """One image's flattened pixel row (a memmap view)."""
        return self.dataset[key][idx]

    def init_meta(self):
        """Load the small arrays into memory; precompute the
        pixel-direction mesh (reference dataset.py:125-182)."""
        ds = open_store(self.path)
        self.dataset_keys = list(ds.keys())
        self.has_bg = 'bkgds' in self.dataset_keys
        self.centers = np.array(ds['centers']) if 'centers' in ds else None

        img_shape = np.array(ds['img_shape'])
        self._N_total_img = img_shape[0]
        self.HW = tuple(int(x) for x in img_shape[1:3])
        H, W = self.HW

        i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                           np.arange(H, dtype=np.float32), indexing='xy')
        i, j = i.reshape(-1), j.reshape(-1)
        if self.centers is None:
            off_x, off_y = W * 0.5, H * 0.5
        else:
            off_x = off_y = 0.
        self._dirs = np.stack([i - off_x, -(j - off_y), -np.ones_like(i)], -1)
        self._pixel_idxs = np.arange(H * W).reshape(H, W)

        self.gt_kp3d = np.array(ds['gt_kp3d']) \
            if 'gt_kp3d' in self.dataset_keys else None
        self.kp_map, self.kp_uidxs = None, None
        self.kp3d, self.bones, self.skts, self.cyls = self._load_pose_data(ds)
        self.focals, self.c2ws = self._load_camera_data(ds)
        self.temp_validity = self.init_temporal_validity()

        if self.has_bg:
            self.bgs = np.array(ds['bkgds']).reshape(-1, H * W, 3)
            self.bg_idxs = np.array(ds['bkgd_idxs']).astype(np.int64)

        self.skel_type = SMPLSkeleton

    def _load_pose_data(self, ds):
        kp3d, bones = np.array(ds['kp3d']), np.array(ds['bones'])
        skts, cyls = np.array(ds['skts']), np.array(ds['cyls'])
        if self.multiview:
            return self._load_multiview_pose(ds, kp3d, bones, skts, cyls)
        return kp3d, bones, skts, cyls

    def _load_multiview_pose(self, ds, kp3d, bones, skts, cyls):
        raise NotImplementedError

    def _load_camera_data(self, ds):
        return np.array(ds['focals']), np.array(ds['c2ws'])

    def init_temporal_validity(self):
        return None

    def init_box2d(self):
        """Per-image 2D boxes for out-of-mask sampling (reference
        dataset.py:207-233)."""
        H, W = self.HW
        box2d = []
        for i in range(len(open_store(self.path)['imgs'])):
            c2w, focal, center, _ = self.get_camera_data(i, i, 1)
            _, _, _, _, cyls = self.get_pose_data(i, i, 1)
            tl, br, _ = cylinder_to_box_2d(cyls[0], [H, W, focal],
                                           nerf_c2w_to_extrinsic(c2w),
                                           center=center, scale=1.3)
            box2d.append((tl, br))
        self.box2d = np.array(box2d)

    # --- per-image sampling ---------------------------------------------

    def get_item(self, q_idx: int,
                 rng: Optional[np.random.Generator] = None,
                 host_slice=None) -> Dict[str, np.ndarray]:
        """One image's sampled rays (reference __getitem__);
        ``host_slice`` as in ``sample_pixels``."""
        rng = rng or np.random.default_rng()
        idx = self._idx_map[q_idx] if self._idx_map is not None else q_idx
        self.init_dataset()

        c2w, focal, center, cam_idxs = self.get_camera_data(
            idx, q_idx, self.N_samples)
        kp_idxs, kps, bones, skts, cyls = self.get_pose_data(
            idx, q_idx, self.N_samples, full=self.pose_per_ray)
        pixel_idxs = self.sample_pixels(idx, q_idx, rng,
                                        host_slice=host_slice)
        rays_o, rays_d = self.get_rays(c2w, focal, pixel_idxs, center)
        rays_rgb, fg, bg = self.get_img_data(idx, pixel_idxs)

        out = {'rays_o': rays_o.astype(np.float32),
               'rays_d': rays_d.astype(np.float32),
               'target_s': rays_rgb,
               'kp_idx': kp_idxs.astype(np.int64),
               'cyls': cyls,
               'cam_idxs': cam_idxs.astype(np.int64),
               'fgs': fg}
        if self.pose_per_ray:
            out.update({'kp3d': kps, 'bones': bones, 'skts': skts})
        if bg is not None:
            out['bgs'] = bg
        return out

    def get_batch(self, q_idxs, rng: np.random.Generator,
                  host_slice=None) -> Optional[Dict[str, np.ndarray]]:
        """``[get_item(q) for q in q_idxs]`` + collate in one numpy pass
        over the batch: a uniform draw without replacement per image
        from its sampling mask, rays from the precomputed direction
        mesh.  Its random stream differs from the per-image path's but
        is as deterministic.  ``host_slice=(process_index,
        process_count)``: one shared draw of ``N * process_count``
        distinct pixels per image (the uniforms are the same on every
        rank), of which rank p keeps block p.  Returns None for the
        modes it does not cover (patch sampling, NMS), where the caller
        falls back to the per-image path."""
        if self.patch_size > 1:
            return None
        if (self.N_nms > 0 if isinstance(self.N_nms, int)
                else self.N_nms > 0.0):
            return None
        # a subclass that customizes the per-item hooks must get the
        # per-item path, not this vectorized bypass of those hooks
        cls = type(self)
        if (cls.sample_pixels is not BaseDataset.sample_pixels
                or cls.get_rays is not BaseDataset.get_rays
                or cls.get_img_data is not BaseDataset.get_img_data):
            return None
        self.init_dataset()
        q_idxs = np.asarray(q_idxs, dtype=np.int64)
        idxs = self._idx_map[q_idxs] if self._idx_map is not None else q_idxs
        n_img, N = len(q_idxs), self.N_samples
        pidx, pcnt = host_slice if host_slice is not None else (0, 1)
        block = slice(pidx * N, (pidx + 1) * N)

        # --- pixel sampling: one shared draw per image ----------------
        valid = [self._valid_pixels(int(i)) for i in idxs]
        lens = np.array([len(v) for v in valid], np.int64)
        n_draw = N * pcnt
        u = rng.random((n_img, n_draw))  # the same on every rank
        ok = lens >= n_draw
        pix = np.empty((n_img, N), np.int64)
        if ok.all():
            pix[:] = sample_distinct(valid, u)[:, block]
        else:
            if ok.any():
                rows = np.where(ok)[0]
                pix[rows] = sample_distinct([valid[r] for r in rows],
                                            u[rows])[:, block]
            # too few distinct pixels to partition: the rank's own
            # stream, with replacement where needed, the rule of
            # sample_pixels
            host_rng = rng.spawn(pcnt)[pidx] if pcnt > 1 else rng
            for r in np.where(~ok)[0]:
                v = valid[r]
                pix[r] = host_rng.choice(v, N, replace=len(v) < N)
        pix.sort(axis=1)

        # --- camera + rays (batched get_rays) --------------------------
        c_real, cam_idx = self.get_cam_idx(idxs, q_idxs)
        c_real = np.asarray(c_real, np.int64)
        c2ws = self.c2ws[c_real].astype(np.float32)       # (B, 4, 4)
        focals = np.asarray(self.focals)[c_real].astype(np.float32) \
            if not np.isscalar(self.focals) else \
            np.full(n_img, self.focals, np.float32)
        dirs = self._dirs[pix]                            # (B, N, 3)
        if self.centers is not None:
            ctr = self.centers[c_real].astype(np.float32).copy()
            ctr[:, 1] *= -1
            dirs = dirs - np.concatenate(
                [ctr, np.zeros((n_img, 1), np.float32)], -1)[:, None, :]
        else:
            dirs = dirs.copy()
        dirs[..., :2] /= focals[:, None, None]
        rays_d = np.einsum('bnj,bij->bni', dirs, c2ws[:, :3, :3])
        rays_o = np.broadcast_to(c2ws[:, None, :3, -1], rays_d.shape)

        # --- image data (batched pixel gather) -------------------------
        rgb = self._gather_pixels('imgs', idxs, pix, scale=1. / 255.)
        fg = self._gather_pixels('masks', idxs, pix)
        bg = None
        if self.has_bg:
            bg = self.bgs[self.bg_idxs[idxs][:, None],
                          pix].astype(np.float32) / 255.
            if self.mask_img:
                rgb = rgb * fg + (1. - fg) * bg

        # --- pose ------------------------------------------------------
        k_real, kp_idx = self.get_kp_idx(idxs, q_idxs)
        k_real = np.asarray(k_real, np.int64)
        rep = lambda x: np.repeat(x[k_real].astype(np.float32), N, axis=0)
        flat = lambda x: np.ascontiguousarray(x).reshape(
            (n_img * N,) + x.shape[2:])

        out = {'rays_o': flat(rays_o).astype(np.float32),
               'rays_d': flat(rays_d).astype(np.float32),
               'target_s': flat(rgb),
               'kp_idx': np.repeat(np.asarray(kp_idx, np.int64), N).astype(
                   np.int32),
               'cyls': rep(self.cyls),
               'cam_idxs': np.repeat(np.asarray(cam_idx, np.int64), N).astype(
                   np.int32),
               'fgs': flat(fg)}
        if self.pose_per_ray:
            out.update({'kps': rep(self.kp3d), 'bones': rep(self.bones),
                        'skts': rep(self.skts)})
        if bg is not None:
            out['bgs'] = flat(bg)
        return out

    def _gather_pixels(self, key: str, idxs: np.ndarray,
                       pix: np.ndarray, scale: float = 1.0) -> np.ndarray:
        """(B, N, C) float32 gather of per-image pixels: one fancy-index
        pass on the memmap."""
        out = self.dataset[key][idxs[:, None], pix].astype(np.float32)
        if scale != 1.0:
            out *= np.float32(scale)
        return out

    def get_camera_data(self, idx, q_idx, N_samples):
        real_idx, cam_idx = self.get_cam_idx(idx, q_idx)
        focal = self.focals[real_idx]
        c2w = self.c2ws[real_idx].astype(np.float32)
        center = self.centers[real_idx] if self.centers is not None else None
        cam_idx = np.array(cam_idx).reshape(-1, 1).repeat(N_samples, 1)
        return c2w, focal, center, cam_idx.reshape(-1)

    def get_img_data(self, idx, pixel_idxs):
        fg = _gather_f32(self._read_row('masks', idx), pixel_idxs)
        img = _gather_f32(self._read_row('imgs', idx), pixel_idxs,
                          scale=1. / 255.)
        bg = None
        if self.has_bg:
            bg = self.bgs[self.bg_idxs[idx], pixel_idxs].astype(
                np.float32) / 255.
            if self.mask_img:
                img = img * fg + (1. - fg) * bg
        return img, fg, bg

    def sample_pixels(self, idx, q_idx, rng: np.random.Generator,
                      host_slice=None):
        """Sample N_samples pixel indices from the sampling mask, with
        optional patch sampling and out-of-mask (NMS) replacement
        (reference dataset.py:277-322).

        ``host_slice=(process_index, process_count)`` makes the ranks'
        pixels disjoint by construction: every rank holds the same
        ``rng``, draws one ``N_rand * process_count`` sample without
        replacement and keeps its own block.  The rank's own randomness
        (NMS, the too-few-pixels fallback) comes from its spawned child
        stream, so the shared stream stays aligned across ranks."""
        p = self.patch_size
        N_rand = self.N_samples // int(p ** 2)
        valid_idxs = self._valid_pixels(idx)
        pidx, pcnt = host_slice if host_slice is not None else (0, 1)
        if pcnt > 1:
            host_rng = rng.spawn(pcnt)[pidx]
            if len(valid_idxs) >= N_rand * pcnt:
                draw = rng.choice(valid_idxs, N_rand * pcnt, replace=False)
                sampled_idxs = draw[pidx * N_rand:(pidx + 1) * N_rand]
            else:
                # too few distinct pixels to partition: the rank's own
                # stream (collisions between ranks possible)
                sampled_idxs = host_rng.choice(
                    valid_idxs, N_rand, replace=len(valid_idxs) < N_rand)
            rng = host_rng
        else:
            sampled_idxs = rng.choice(valid_idxs, N_rand,
                                      replace=len(valid_idxs) < N_rand)
        if p > 1:
            H, W = self.HW
            hs = np.clip(sampled_idxs // W, 0, H - p)
            ws = np.clip(sampled_idxs % W, 0, W - p)
            patches = [self._pixel_idxs[h:h + p, w:w + p].reshape(-1)
                       for h, w in zip(hs, ws)]
            sampled_idxs = np.array(patches).reshape(-1)

        if isinstance(self.N_nms, int):
            N_nms = self.N_nms
        else:
            N_nms = int(self.N_nms > rng.random())
        if N_nms > 0:
            sampling_mask = np.asarray(
                self._read_row('sampling_masks', idx)).reshape(-1)
            nms_idxs = self._sample_in_box2d(idx, q_idx, sampling_mask,
                                             N_nms, rng)
            sampled_idxs = np.sort(sampled_idxs)
            sampled_idxs[rng.choice(len(sampled_idxs), size=(N_nms,),
                                    replace=False)] = nms_idxs
        return np.sort(sampled_idxs)

    def _sample_in_box2d(self, idx, q_idx, fg, N_samples,
                         rng: np.random.Generator):
        H, W = self.HW
        real_idx, _ = self.get_cam_idx(idx, q_idx)
        tl, br = self.box2d[real_idx].copy()
        fg = fg.reshape(H, W)
        cropped = fg[tl[1]:br[1], tl[0]:br[0]]
        vy, vx = np.where(cropped < 1)
        idxs = (vy + tl[1]) * W + (vx + tl[0])
        return rng.choice(idxs, size=(N_samples,), replace=False)

    def get_rays(self, c2w, focal, pixel_idxs, center=None):
        """Rays from the precomputed direction mesh
        (reference dataset.py:346-364)."""
        dirs = self._dirs[pixel_idxs].copy()
        if center is not None:
            center = center.copy()
            center[1] *= -1
            dirs[..., :2] -= center
        dirs[:, :2] /= focal
        R = c2w[:3, :3]
        if R[0, 0] == 1. and R[1, 1] == 1. and R[2, 2] == 1. and \
                (R == np.eye(3, dtype=R.dtype)).all():
            rays_d = dirs
        else:
            rays_d = np.sum(dirs[..., None, :] * c2w[:3, :3], -1)
        rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
        return rays_o.copy(), rays_d.copy()

    def get_pose_data(self, idx, q_idx, N_samples, full=True):
        real_idx, kp_idx = self.get_kp_idx(idx, q_idx)
        rep = lambda x: x[real_idx:real_idx + 1].astype(np.float32).repeat(
            N_samples, 0)
        kp_idxs = np.array([kp_idx]).repeat(N_samples, 0)
        if not full:  # pose comes from the trainer's pose bank
            return kp_idxs, None, None, None, rep(self.cyls)
        return (kp_idxs, rep(self.kp3d), rep(self.bones), rep(self.skts),
                rep(self.cyls))

    def get_kp_idx(self, idx, q_idx):
        return idx, q_idx

    def get_cam_idx(self, idx, q_idx):
        return idx, q_idx

    # --- metadata / render data -----------------------------------------

    def _get_subset_idxs(self, render=False):
        if self._idx_map is not None:
            i_idxs = self._idx_map
            _k = _c = self._idx_map
            _kq = _cq = np.arange(len(self._idx_map))
        else:
            i_idxs = np.arange(self._N_total_img)
            _k = _kq = np.arange(len(self.kp3d))
            _c = _cq = np.arange(len(self.c2ws))
        k_idxs, kq_idxs = self.get_kp_idx(_k, _kq)
        c_idxs, cq_idxs = self.get_cam_idx(_c, _cq)
        return k_idxs, c_idxs, i_idxs, kq_idxs, cq_idxs

    def get_meta(self) -> Dict[str, Any]:
        """Data attributes for model/trainer construction
        (reference dataset.py:436-488)."""
        ds = open_store(self.path)
        rest_pose = np.array(ds['rest_pose'])
        betas = np.array(ds['betas']) if 'betas' in ds else np.zeros((1, 10))

        k_idxs, c_idxs, i_idxs, kq_idxs, cq_idxs = self._get_subset_idxs()
        H, W = self.HW
        if not np.isscalar(self.focals):
            H = np.repeat([H], len(c_idxs), 0)
            W = np.repeat([W], len(c_idxs), 0)
        if len(betas) > 1:
            betas = betas[k_idxs]
        betas = betas.mean(0, keepdims=True).repeat(len(betas), 0)

        return {
            'hwf': (H, W, self.focals[c_idxs]),
            'center': (self.centers[c_idxs].copy()
                       if self.centers is not None else None),
            'c2ws': self.c2ws[c_idxs],
            'near': 60., 'far': 100.,  # overridden by cylinder clipping
            'n_views': self.data_len,
            'skel_type': self.skel_type,
            'joint_coords': get_per_joint_coords(rest_pose, self.skel_type),
            'rest_pose': rest_pose,
            'gt_kp3d': (self.gt_kp3d[k_idxs]
                        if self.gt_kp3d is not None else None),
            'kp3d': self.kp3d[k_idxs],
            'skts': self.skts[k_idxs],
            'bones': self.bones[k_idxs],
            'betas': betas,
            'kp_map': self.kp_map,
            'kp_uidxs': self.kp_uidxs,
        }

    def get_render_data(self, selected_idxs=None) -> Dict[str, Any]:
        """Held-out images + cameras for validation rendering
        (reference dataset.py:490-542).  ``selected_idxs`` (positions
        into the render subset) overrides the default skip/N_render
        decimation."""
        ds = open_store(self.path)
        k_idxs, c_idxs, i_idxs, kq_idxs, cq_idxs = \
            self._get_subset_idxs(render=True)
        if selected_idxs is not None:
            pick = np.asarray(selected_idxs)
            pick = pick[pick < len(i_idxs)]
        else:
            pick = np.arange(len(i_idxs))[::self.render_skip]
            pick = pick[:self.N_render]
        i_idxs = i_idxs[pick]
        k_idxs = k_idxs[pick]
        c_idxs = c_idxs[pick]

        H, W = self.HW
        imgs = ds['imgs'][i_idxs].reshape(-1, H, W, 3).astype(
            np.float32) / 255.
        fgs = np.array(ds['masks'][i_idxs]).reshape(-1, H, W, 1)
        bgs = (self.bgs.reshape(-1, H, W, 3).astype(np.float32) / 255.
               if self.has_bg else None)
        Ha = np.repeat([H], len(c_idxs), 0)
        Wa = np.repeat([W], len(c_idxs), 0)
        return {
            'imgs': imgs, 'fgs': fgs, 'bgs': bgs,
            'bg_idxs': self.bg_idxs[i_idxs] if self.has_bg else None,
            'bg_idxs_len': len(self.bgs) if self.has_bg else 0,
            'cam_idxs': c_idxs, 'cam_idxs_len': len(self.c2ws),
            'c2ws': self.c2ws[c_idxs],
            'hwf': (Ha, Wa, self.focals[c_idxs]),
            'center': (self.centers[c_idxs].copy()
                       if self.centers is not None else None),
            'kp_idxs': k_idxs, 'kp_idxs_len': len(self.kp3d),
            'kp3d': self.kp3d[k_idxs],
            'skts': self.skts[k_idxs],
            'bones': self.bones[k_idxs],
        }


def set_pose_per_ray(dataset, flag: bool) -> None:
    """Toggle per-ray kps/skts/bones batch arrays on every underlying
    dataset (unwraps Concat/Temporal wrappers).  ``load_data`` turns
    them off when ``opt_pose`` is on: the step rebuilds pose from the
    pose bank on the device (trainer.get_batch_pose)."""
    if hasattr(dataset, 'datasets'):
        for d in dataset.datasets:
            set_pose_per_ray(d, flag)
    elif hasattr(dataset, '_dataset'):
        set_pose_per_ray(dataset._dataset, flag)
    else:
        dataset.pose_per_ray = flag


class PoseRefinedDataset(BaseDataset):
    """Loads refined poses from a pose checkpoint instead of the store
    (reference dataset.py:544-568).  ``refined_paths`` maps subject ->
    (checkpoint path, legacy flag); a checkpoint may be the port's
    (``.pt``) or the reference's torch ``.tar``."""

    refined_paths: Dict[str, Tuple[str, bool]] = {}

    def __init__(self, *args, load_refined: bool = False, **kwargs):
        self.load_refined = load_refined
        super().__init__(*args, **kwargs)

    def _load_pose_data(self, ds):
        if not self.load_refined:
            return super()._load_pose_data(ds)
        if self.subject not in self.refined_paths:
            raise KeyError(f'no refined pose path for subject {self.subject}')
        refined_path, legacy = self.refined_paths[self.subject]
        from ..training.checkpoint import load_refined_pose_data
        kp3d, bones, skts, cyls = load_refined_pose_data(
            refined_path, legacy=legacy)[:4]
        if self.multiview:
            return self._load_multiview_pose(ds, kp3d, bones, skts, cyls)
        return kp3d, bones, skts, cyls


class ConcatDataset:
    """Multi-subject training (reference dataset.py:570-641): offsets
    cam/kp indices per sub-dataset and adds ``subject_idxs``."""

    def __init__(self, datasets: List[BaseDataset]):
        self.datasets = datasets
        self.cumulative_sizes = np.cumsum([len(d) for d in datasets])
        metas = [d.get_meta() for d in datasets]
        self.cumulative_views = np.cumsum([m['n_views'] for m in metas])
        self.cumulative_kps = np.cumsum([len(m['kp3d']) for m in metas])

    def __len__(self):
        return int(self.cumulative_sizes[-1])

    def get_item(self, idx, rng=None, host_slice=None):
        d_idx = int(np.searchsorted(self.cumulative_sizes, idx, side='right'))
        s_idx = idx if d_idx == 0 else idx - self.cumulative_sizes[d_idx - 1]
        ret = self.datasets[d_idx].get_item(int(s_idx), rng,
                                            host_slice=host_slice)
        if d_idx != 0:
            ret['cam_idxs'] = ret['cam_idxs'] + self.cumulative_views[d_idx - 1]
            ret['kp_idx'] = ret['kp_idx'] + self.cumulative_kps[d_idx - 1]
        ret['subject_idxs'] = np.array([d_idx]).repeat(
            len(ret['cam_idxs']), 0)
        return ret

    def get_batch(self, q_idxs, rng=None, host_slice=None):
        """Vectorized multi-subject batch: q_idxs arrive sorted, so the
        per-sub-dataset groups are contiguous slices; each group goes
        through its dataset's batched path, then cam/kp offsets and
        subject_idxs are applied to the concatenated result."""
        q_idxs = np.asarray(q_idxs, dtype=np.int64)
        # grouping by subject keeps the row order only for sorted
        # q_idxs (RayImageSampler always yields sorted batches)
        if not (np.diff(q_idxs) >= 0).all():
            raise ValueError('ConcatDataset.get_batch requires sorted q_idxs')
        d_idxs = np.searchsorted(self.cumulative_sizes, q_idxs, side='right')
        parts = []
        for d in np.unique(d_idxs):
            sel = q_idxs[d_idxs == d]
            base = 0 if d == 0 else self.cumulative_sizes[d - 1]
            gb = getattr(self.datasets[d], 'get_batch', None)
            part = gb(sel - base, rng, host_slice=host_slice) \
                if gb is not None else None
            if part is None:
                return None
            if d != 0:
                part['cam_idxs'] = (part['cam_idxs']
                                    + self.cumulative_views[d - 1]).astype(
                                        np.int32)
                part['kp_idx'] = (part['kp_idx']
                                  + self.cumulative_kps[d - 1]).astype(
                                      np.int32)
            part['subject_idxs'] = np.full(len(part['cam_idxs']), d,
                                           np.int32)
            parts.append(part)
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts])
                for k in parts[0]}

    def get_meta(self):
        metas = [d.get_meta() for d in self.datasets]
        merged = {}
        H = np.concatenate([np.atleast_1d(m['hwf'][0]) for m in metas])
        W = np.concatenate([np.atleast_1d(m['hwf'][1]) for m in metas])
        focals = np.concatenate([np.atleast_1d(m['hwf'][2]) for m in metas])
        merged['hwf'] = (H, W, focals)
        merged['near'] = metas[0]['near']
        merged['far'] = metas[0]['far']
        merged['n_views'] = int(np.sum([m['n_views'] for m in metas]))
        merged['skel_type'] = metas[0]['skel_type']
        for k in ['joint_coords', 'rest_pose']:
            merged[k] = np.stack([m[k] for m in metas], axis=0)
        has_gt = all(m.get('gt_kp3d') is not None for m in metas)
        for k in ['gt_kp3d', 'kp3d', 'bones', 'betas']:
            if k == 'gt_kp3d' and not has_gt:
                continue
            merged[k] = np.concatenate([m[k] for m in metas])
        merged['skts'] = np.concatenate([m['skts'] for m in metas])
        kp_lens = np.cumsum([len(m['kp3d']) for m in metas])
        merged['rest_pose_idxs'] = np.searchsorted(
            kp_lens, np.arange(len(merged['kp3d'])), side='right')
        merged['n_subjects'] = len(self.datasets)
        merged['kp_map'] = merged['kp_uidxs'] = None
        merged['center'] = None
        return merged

    def get_render_data(self, selected_idxs=None):
        return self.datasets[0].get_render_data(selected_idxs)


class TemporalDatasetWrapper:
    """Adds ``temp_val`` validity for the temporal loss
    (reference dataset.py:713-728)."""

    def __init__(self, dataset):
        self._dataset = dataset
        if getattr(dataset, 'temp_validity', None) is None:
            raise ValueError(f'{type(dataset)} does not support temporal '
                             'loss')

    def __len__(self):
        return len(self._dataset)

    def __getattr__(self, name):
        return getattr(self._dataset, name)

    def get_item(self, idx, rng=None, host_slice=None):
        ret = self._dataset.get_item(idx, rng, host_slice=host_slice)
        tv = self._dataset.temp_validity
        next_idx = (idx + 1) % len(tv)
        temp_val = (tv[idx] + tv[next_idx]) // 2
        ret['temp_val'] = np.repeat(np.float32(temp_val),
                                    ret['kp_idx'].shape[0], 0)
        return ret

    def get_batch(self, q_idxs, rng=None, host_slice=None):
        gb = getattr(self._dataset, 'get_batch', None)
        ret = gb(q_idxs, rng, host_slice=host_slice) \
            if gb is not None else None
        if ret is None:
            return None
        tv = np.asarray(self._dataset.temp_validity)
        q = np.asarray(q_idxs, dtype=np.int64)
        temp_val = ((tv[q] + tv[(q + 1) % len(tv)]) // 2).astype(np.float32)
        N = ret['kp_idx'].shape[0] // len(q)
        ret['temp_val'] = np.repeat(temp_val, N)
        return ret

    def get_meta(self):
        return self._dataset.get_meta()

    def get_render_data(self, selected_idxs=None):
        return self._dataset.get_render_data(selected_idxs)
