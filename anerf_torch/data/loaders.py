"""The dataset classes of each ``dataset_type`` and ``load_data``.

Port of ``anerf_tpu/data/loaders.py`` (reference
core/load_{surreal,h36m,mixamo,perfcap,zju}.py dataset classes and
core/load_data.py:71-143) over data stores: ``DATASET_CATALOG`` keeps
anerf_tpu's paths with ``.npstore`` in place of ``.h5``
(``python -m anerf_torch.data.store`` converts a file).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from .dataset import (BaseDataset, ConcatDataset, PoseRefinedDataset,
                      TemporalDatasetWrapper, set_pose_per_ray)
from .pipeline import Prefetcher
from .store import is_store, open_store


def _synthetic_path(data_path: str, subject: str) -> str:
    """A synthetic dataset's store: ``data_path`` itself when it is a
    store, else ``<data_path>/<subject>.npstore`` (so that several
    synthetic subjects can sit side by side)."""
    if is_store(data_path):
        return data_path
    return os.path.join(data_path, f'{subject}.npstore')


DATASET_CATALOG = {
    'surreal': lambda data_path, subject:
        os.path.join(data_path, 'surreal', 'surreal_train_h5py.npstore'),
    'h36m': lambda data_path, subject:
        os.path.join(data_path, 'h36m', f'{subject}_processed.npstore'),
    'mixamo': lambda data_path, subject:
        os.path.join(data_path, 'mixamo', f'{subject}_processed_h5py.npstore'),
    'perfcap': lambda data_path, subject:
        os.path.join(data_path, 'MonoPerfCap', subject,
                     f'{subject}_processed_h5py.npstore'),
    'zju': lambda data_path, subject:
        os.path.join(data_path, 'zju_mocap', f'{subject}_train_h5py.npstore'),
    'zju_h36m': lambda data_path, subject:
        os.path.join(data_path, 'zju_h36m', f'{subject}_train_h5py.npstore'),
    'synthetic': _synthetic_path,
}


class SurrealDataset(BaseDataset):
    """Images laid out (N_cams, N_kps): kp id = idx % N_kps, cam id =
    idx // N_kps (reference load_surreal.py:302-387)."""

    render_skip = 1
    N_render = 15

    def __init__(self, *args, N_rand_kps=None, N_cams=None, **kwargs):
        self._N_rand_kps = N_rand_kps
        self._N_kps = int(N_rand_kps.split('_')[-1]) if N_rand_kps else None
        self._N_cams = N_cams
        super().__init__(*args, **kwargs)

    def init_meta(self):
        if self.split == 'val':
            self.path = self.path.replace('train_h5py', 'val_h5py')
        super().init_meta()
        N_total_cams = len(self.c2ws) // len(self.kp3d)
        N_total_kps = len(self.kp3d)
        if self._N_kps is None:
            self._N_kps = N_total_kps
        if self._N_cams is None:
            self._N_cams = N_total_cams
        if self._N_kps == N_total_kps and self._N_cams == N_total_cams:
            return
        selected_kps = np.arange(self._N_kps)
        selected_cams = np.arange(self._N_cams)
        self._idx_map = np.concatenate(
            [selected_kps + N_total_kps * c for c in selected_cams])

    def get_kp_idx(self, idx, q_idx):
        return idx % len(self.kp3d), q_idx % self._N_kps

    def get_cam_idx(self, idx, q_idx):
        return idx, q_idx // self._N_kps

    def get_meta(self):
        attrs = super().get_meta()
        attrs['n_views'] = self._N_cams
        return attrs


class MixamoDataset(PoseRefinedDataset):
    """Selected-frame subset, white background, temporal validity from
    consecutive frame paths (reference load_mixamo.py:161-199)."""

    render_skip = 40
    N_render = 15
    refined_paths: Dict[str, Tuple[str, bool]] = {}

    def init_meta(self):
        ds = open_store(self.path)
        sel_path = self.path.replace('processed_h5py.npstore', 'selected.npy')
        if os.path.exists(sel_path):
            self._idx_map = np.array(sorted(np.load(sel_path)))
        n_imgs = ds['imgs'].shape[0]
        img_paths = np.array(ds['img_paths']) if 'img_paths' in ds else None
        super().init_meta()
        # white background
        self.bgs = np.ones((1, int(np.prod(self.HW)), 3), np.uint8) * 255
        self.bg_idxs = np.zeros((n_imgs,), np.int64)
        self.has_bg = True
        if img_paths is not None and self._idx_map is not None:
            self.temp_validity = temporal_validity_from_paths(
                img_paths[self._idx_map])
        else:
            self.temp_validity = np.ones(len(self), np.int64)
            self.temp_validity[0] = 0


class MonoPerfCapDataset(PoseRefinedDataset):
    """Last-N validation split + the reference's c2w/1.05 scale fix
    (reference load_perfcap.py:54-89)."""

    n_vals = {'weipeng': 230, 'nadia': 327}
    render_skip = 10
    N_render = 15
    refined_paths: Dict[str, Tuple[str, bool]] = {}

    def init_meta(self):
        train_idxs = np.arange(len(open_store(self.path)['imgs']))
        self._idx_map = None
        if self.split != 'full':
            n_val = self.n_vals.get(self.subject, max(1, len(train_idxs)//10))
            val_idxs = train_idxs[-n_val:]
            train_idxs = train_idxs[:-n_val]
            self._idx_map = train_idxs if self.split == 'train' else val_idxs
        self.temp_validity = np.ones(len(train_idxs))
        self.temp_validity[0] = 0
        super().init_meta()
        self.c2ws = self.c2ws.copy()
        self.c2ws[..., :3, -1] /= 1.05


class H36MDataset(PoseRefinedDataset):
    """Sequence-name val split + multiview pose sharing
    (reference load_h36m.py:369-431)."""

    render_skip = 80
    N_render = 15
    refined_paths: Dict[str, Tuple[str, bool]] = {}
    val_sets = ('Greeting-', 'Walking-', 'Posing-')

    def init_meta(self):
        ds = open_store(self.path)
        img_paths = np.array(ds['img_paths']) if 'img_paths' in ds else None
        self._idx_map = None
        if img_paths is not None and self.split != 'full':
            train_idxs, val_idxs = [], []
            for i, p in enumerate(img_paths):
                seq = p.decode().split('/')[1] if b'/' in p else ''
                is_val = any(seq.startswith(v) for v in self.val_sets)
                (val_idxs if is_val else train_idxs).append(i)
            self._idx_map = np.array(
                train_idxs if self.split == 'train' else val_idxs)
        super().init_meta()

    def _load_multiview_pose(self, ds, kp3d, bones, skts, cyls):
        img_paths = np.array(ds['img_paths'])
        rest_pose = np.array(ds['rest_pose'])
        kp_map, kp_uidxs, kp3d, bones, skts = map_data_to_n_views(
            img_paths, kp3d, bones, rest_pose, skts)
        self.kp_map, self.kp_uidxs = kp_map, kp_uidxs
        return kp3d, bones, skts, cyls


class ZJUMocapDataset(BaseDataset):
    """ZJU-MoCap: multi-camera capture where image->pose and
    image->camera mappings come from lookup arrays in the store
    (``kp_idxs`` / ``img_pose_indices``), since several cameras see the
    same pose (reference load_zju.py:536-588)."""

    render_skip = 63
    N_render = 15

    def init_meta(self):
        if self.split == 'test':
            self.path = self.path.replace('train', 'test')
        super().init_meta()
        ds = open_store(self.path)
        self.kp_idxs_lut = np.array(ds['kp_idxs'])
        self.cam_idxs_lut = np.array(ds['img_pose_indices'])
        if self.split == 'test':
            n_unique_cam = len(np.unique(self.cam_idxs_lut))
            self.kp_idxs_lut = self.kp_idxs_lut // n_unique_cam

    def get_kp_idx(self, idx, q_idx):
        return self.kp_idxs_lut[idx], q_idx

    def get_cam_idx(self, idx, q_idx):
        return self.cam_idxs_lut[idx], q_idx

    def _get_subset_idxs(self, render=False):
        # kp/cam indices run over *images* (then through the LUTs), not
        # over the pose/camera banks like the base class assumes
        # (reference load_zju.py:580-600)
        if self._idx_map is not None:
            i_idxs = _k = _c = self._idx_map
            _kq = _cq = np.arange(len(self._idx_map))
        else:
            i_idxs = np.arange(self._N_total_img)
            _k = _kq = np.arange(self._N_total_img)
            _c = _cq = np.arange(self._N_total_img)
        k_idxs, kq_idxs = self.get_kp_idx(_k, _kq)
        c_idxs, cq_idxs = self.get_cam_idx(_c, _cq)
        return k_idxs, c_idxs, i_idxs, kq_idxs, cq_idxs


class ZJUH36MDataset(ZJUMocapDataset):
    """H36M packaged in the ZJU layout, last-30-frames validation split
    (reference load_zju.py:602-644)."""

    render_skip = 1
    N_render = 30

    def init_meta(self):
        super().init_meta()
        idxs = np.arange(len(self.kp_idxs_lut))
        if self.split == 'train':
            self._idx_map = idxs[:-30]
        elif self.split == 'val':
            self._idx_map = idxs[-30:]


class SyntheticDataset(BaseDataset):
    """A plain store at an explicit path (tests, custom data)."""
    render_skip = 1
    N_render = 4


def temporal_validity_from_paths(img_paths) -> np.ndarray:
    """Frame i valid iff frame i-1 is the consecutive previous frame in
    the same directory (reference load_mixamo.py:129-159)."""
    def num(p):
        p = p.decode() if isinstance(p, bytes) else str(p)
        stem = os.path.splitext(os.path.basename(p))[0]
        digits = ''.join(c for c in stem if c.isdigit())
        return int(digits) if digits else 0

    def dirname(p):
        p = p.decode() if isinstance(p, bytes) else str(p)
        return os.path.dirname(p)

    valid = np.ones(len(img_paths), np.int64)
    valid[0] = 0
    for i in range(1, len(img_paths)):
        if dirname(img_paths[i]) != dirname(img_paths[i - 1]) or \
                abs(num(img_paths[i]) - num(img_paths[i - 1])) > 1:
            valid[i] = 0
    return valid


def map_data_to_n_views(img_paths, kp3d, bones, rest_pose, skts):
    """Group frames captured by multiple cameras at the same time so
    non-root bones are shared (reference load_h36m.py multiview path).
    Frames are keyed by their basename (frame number); each unique key
    becomes one shared bone row."""
    keys = []
    for p in img_paths:
        p = p.decode() if isinstance(p, bytes) else str(p)
        parts = p.split('/')
        seq = parts[1].split('.')[0] if len(parts) > 1 else ''
        frame = os.path.basename(p)
        keys.append(f'{seq}:{frame}')
    uniq, kp_map, counts = np.unique(keys, return_inverse=True,
                                     return_counts=True)
    kp_uidxs = np.array([np.where(kp_map == u)[0][0]
                         for u in range(len(uniq))])
    return kp_map, kp_uidxs, kp3d, bones, skts


def get_dataset(cfg, data_path: Optional[str] = None,
                h5_override: Optional[str] = None, process_count: int = 1):
    """Build the (possibly concatenated / temporal) dataset
    (reference load_data.py:87-143).  ``h5_override`` (the name
    anerf_tpu gives it) is a data store that every subject reads in
    place of its ``DATASET_CATALOG`` path, as a render catalog entry
    names one.  With ``process_count > 1`` each rank's dataset samples
    its 1/process_count block of the per-image ray budget; the global
    batch stays ``N_rand``."""
    data_path = data_path or cfg.datadir
    subjects, dataset_types = list(cfg.subject), list(cfg.dataset_type)
    if len(subjects) > len(dataset_types):
        if len(dataset_types) != 1:
            raise ValueError('subject and dataset_type lists disagree')
        dataset_types = dataset_types * len(subjects)

    per_img = cfg.N_rand // cfg.N_sample_images
    if per_img % process_count:
        raise ValueError(f'N_rand / N_sample_images = {per_img} rays per '
                         f'image do not split over {process_count} ranks')
    N_samples = per_img // process_count
    N_nms = N_samples * cfg.P_nms

    split = 'full' if not cfg.use_val else 'train'
    shared = dict(N_samples=N_samples, split=split, mask_img=cfg.mask_image,
                  patch_size=cfg.patch_size, N_nms=N_nms,
                  multiview=cfg.multiview)

    datasets = []
    for dtype, subj in zip(dataset_types, subjects):
        path = h5_override or DATASET_CATALOG[dtype](data_path, subj)
        if dtype == 'h36m':
            d = H36MDataset(path, subject=subj, load_refined=cfg.load_refined,
                            **shared)
        elif dtype == 'perfcap':
            d = MonoPerfCapDataset(path, subject=subj,
                                   load_refined=cfg.load_refined, **shared)
        elif dtype == 'mixamo':
            d = MixamoDataset(path, subject=subj,
                              load_refined=cfg.load_refined, **shared)
        elif dtype == 'surreal':
            shared_s = dict(shared, split='train')
            d = SurrealDataset(path, subject=subj, N_cams=cfg.N_cams,
                               N_rand_kps=cfg.rand_train_kps, **shared_s)
        elif dtype == 'zju':
            d = ZJUMocapDataset(path, subject=subj, **shared)
        elif dtype == 'zju_h36m':
            d = ZJUH36MDataset(path, subject=subj, **shared)
        elif dtype == 'synthetic':
            d = SyntheticDataset(path, subject=subj, **shared)
        else:
            raise NotImplementedError(f'dataset {dtype} is not implemented')
        datasets.append(d)

    dataset = datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)
    if cfg.use_temp_loss:
        dataset = TemporalDatasetWrapper(dataset)
    return dataset


def load_data(cfg, data_path: Optional[str] = None,
              process_index: int = 0, process_count: int = 1):
    """(prefetcher, render_data, data_attrs): the trainer's data entry
    point (reference load_data.py:71-84).  ``process_index`` /
    ``process_count``: the prefetcher yields this rank's block of each
    global batch."""
    dataset = get_dataset(cfg, data_path, process_count=process_count)
    if cfg.opt_pose:
        # pose comes from the pose bank on the device: the batches carry
        # no per-ray kps/skts/bones
        set_pose_per_ray(dataset, False)
    prefetcher = Prefetcher(dataset, N_images=cfg.N_sample_images,
                            n_workers=min(cfg.num_workers, 8),
                            seed=cfg.seed, N_iter=cfg.n_iters + 10,
                            process_index=process_index,
                            process_count=process_count)
    data_attrs = dataset.get_meta()
    render_data = dataset.get_render_data()
    return prefetcher, render_data, data_attrs
