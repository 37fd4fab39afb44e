"""Per-dataset curated render entries (the reference's ``init_catalog``,
run_render.py:301-471): for each trained subject, where its processed
data and refined-pose checkpoint live, plus the selected frame idxs and
generator parameters for every render type — so the paper renders are a
single ``--entry dataset/subject`` command.

Copy of ``anerf_tpu/render/catalog.py`` with one change: an entry's
``data_h5`` names the data store beside the reference's HDF5 file
(``<stem>.npstore``, as ``data.loaders.DATASET_CATALOG`` maps the
datasets; ``python -m anerf_torch.data.store`` converts a file).

Entries resolve lazily against a data root; missing index .npy files
degrade to empty selections with a warning, matching the reference's
``load_idxs`` behavior (run_render.py:312-316).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np


def _load_idxs(path: str) -> np.ndarray:
    if not os.path.exists(path):
        print(f'Index file {path} does not exist.')
        return np.array([], dtype=np.int64)
    return np.load(path)


def _store(h5_path: str) -> str:
    """The data store that stands for an HDF5 file: ``<stem>.npstore``."""
    return os.path.splitext(h5_path)[0] + '.npstore'


def _set(selected_idxs, **kwargs) -> Dict[str, Any]:
    return {'selected_idxs': np.asarray(selected_idxs), **kwargs}


def find_idxs_with_map(selected_idxs, idx_map) -> np.ndarray:
    """Original frame ids -> positions in a subset selection array
    (reference run_render.py:473-482, e.g. the Mixamo *_selected.npy
    maps).  Ids absent from the map are dropped."""
    if idx_map is None:
        return np.asarray(selected_idxs)
    idx_map = np.asarray(idx_map)
    sel = np.asarray(selected_idxs)
    # vectorized first-match lookup
    eq = idx_map[None, :] == sel[:, None]          # (n_sel, n_map)
    has = eq.any(1)
    return np.where(has, eq.argmax(1), -1)[has]


def init_catalog(data_root: str = 'data',
                 ckpt_root: str = 'neurips21_ckpt/trained/ours',
                 n_bullet: int = 10) -> Dict[str, Dict[str, Any]]:
    """Build the full render catalog (reference run_render.py:301-471).

    Returns {dataset: {entry: {'data_h5', 'refined'?, 'idx_map'?,
    <render_type>: kwargs...}}}.
    """
    j = os.path.join

    # --- H36M (reference :320-352) -------------------------------------
    s9_idx = [121, 500, 1000, 1059, 1300, 1600, 1815, 2400, 3014, 3702,
              4980]
    h36m_s9 = {
        'data_h5': _store(j(data_root, 'h36m/S9_processed.h5')),
        'refined': j(ckpt_root, 'h36m/s9_sub64_500k.tar'),
        'retarget': _set(s9_idx, length=5),
        'bullet': _set([0], n_bullet=n_bullet, undo_rot=False,
                       center_cam=True),
        'interpolate': _set(s9_idx, n_step=10, undo_rot=True,
                            center_cam=True),
        'correction': _set(
            _load_idxs(j(data_root, 'h36m/S9_top50_refined.npy'))[:1],
            n_step=30),
        'animate': _set([1000, 1059, 2400], n_step=10, center_cam=True,
                        center_kps=True, joints=[17, 19, 21, 23]),
        'bubble': _set(s9_idx, n_step=30),
        'poserot': _set([1000]),
        'val': _set(_load_idxs(j(data_root, 'h36m/S9_val_idxs.npy')),
                    length=1, skip=1),
    }
    s11_idx = [213, 656, 904, 1559, 1815, 2200, 2611, 2700, 3110, 3440,
               3605]
    h36m_s11 = {
        'data_h5': _store(j(data_root, 'h36m/S11_processed.h5')),
        'refined': j(ckpt_root, 'h36m/s11_sub64_500k.tar'),
        'retarget': _set(s11_idx, length=5),
        'bullet': _set(s11_idx, n_bullet=n_bullet, undo_rot=True,
                       center_cam=True),
        'interpolate': _set(s11_idx, n_step=10, undo_rot=True,
                            center_cam=True),
        'correction': _set(
            _load_idxs(j(data_root, 'h36m/S11_top50_refined.npy'))[:1],
            n_step=30),
        'animate': _set([2507, 700, 900], n_step=10, center_cam=True,
                        center_kps=True, joints=[3, 6, 9, 12, 15, 16, 18]),
        'bubble': _set(s11_idx, n_step=30),
        'val': _set(_load_idxs(j(data_root, 'h36m/S11_val_idxs.npy')),
                    length=1, skip=1),
    }

    # --- SURREAL (reference :354-377) ----------------------------------
    easy_idx = [10, 70, 350, 420, 490, 910, 980, 1050]
    surreal_val = {
        'data_h5': _store(j(data_root, 'surreal/surreal_val_h5py.h5')),
        'val': _set(_load_idxs(j(data_root,
                                 'surreal/surreal_val_idxs.npy')),
                    length=1, skip=1),
        'val2': _set(_load_idxs(j(data_root,
                                  'surreal/surreal_val_idxs.npy'))[:300],
                     length=1, skip=1),
    }
    surreal_easy = {
        'data_h5': _store(j(data_root,
                            'surreal/surreal_train_h5py.h5')),
        'retarget': _set(easy_idx, length=25, skip=2, center_kps=True),
        'bullet': _set(easy_idx, n_bullet=n_bullet),
        'bubble': _set(easy_idx, n_step=30),
    }
    hard_idx = [140, 210, 280, 490, 560, 630, 700, 770, 840, 910]
    surreal_hard = {
        'data_h5': _store(j(data_root,
                            'surreal/surreal_train_h5py.h5')),
        'retarget': _set(hard_idx, length=60, skip=5, center_kps=True),
        'bullet': _set([190, 210, 230, 490, 510, 530, 790, 810, 830, 910,
                        930, 950, 1090, 1110, 1130],
                       n_bullet=n_bullet, center_kps=True,
                       center_cam=False),
        'bubble': _set(hard_idx, n_step=30),
        'val': _set(np.array([1200 * i + np.arange(420, 700)[::5]
                              for i in range(0, 9, 2)]).reshape(-1),
                    length=1, skip=1),
        'mesh': _set([930], length=1, skip=1),
    }

    # --- MonoPerfCap (reference :379-410) -------------------------------
    weipeng_idx = [0, 50, 100, 150, 200, 250, 300, 350, 430, 480, 560,
                   600, 630, 660, 690, 720, 760, 810, 850, 900, 950,
                   1030, 1080, 1120]
    perfcap_weipeng = {
        'data_h5': _store(j(data_root,
                            'MonoPerfCap/Weipeng_outdoor/'
                            'Weipeng_outdoor_processed_h5py.h5')),
        'refined': j(ckpt_root, 'perfcap/weipeng_tv_500k.tar'),
        'retarget': _set(weipeng_idx, length=30, skip=2),
        'bullet': _set(weipeng_idx, n_bullet=n_bullet),
        'interpolate': _set(weipeng_idx, n_step=10, undo_rot=True,
                            center_cam=True),
        'bubble': _set(weipeng_idx, n_step=30),
        'val': _set(np.arange(1151)[-230:], length=1, skip=1),
        'animate': _set([300, 480, 700], n_step=10, center_cam=True,
                        center_kps=True,
                        joints=[1, 4, 7, 10, 17, 19, 21, 23]),
    }
    nadia_idx = [0, 65, 100, 125, 230, 280, 410, 560, 600, 630, 730, 770,
                 830, 910, 1010, 1040, 1070, 1100, 1285, 1370, 1450, 1495,
                 1560, 1595]
    perfcap_nadia = {
        'data_h5': _store(j(data_root,
                            'MonoPerfCap/Nadia_outdoor/'
                            'Nadia_outdoor_processed_h5py.h5')),
        'refined': j(ckpt_root, 'perfcap/nadia_tv_500k.tar'),
        'retarget': _set(nadia_idx, length=30, skip=2),
        'bullet': _set(nadia_idx, n_bullet=n_bullet),
        'interpolate': _set(nadia_idx, n_step=10, undo_rot=True,
                            center_cam=True, center_kps=True),
        'bubble': _set(nadia_idx, n_step=30),
        'animate': _set([280, 410, 1040], n_step=10, center_cam=True,
                        center_kps=True,
                        joints=[1, 2, 4, 5, 7, 8, 10, 11]),
        'val': _set(np.arange(1635)[-327:], length=1, skip=1),
    }

    # --- Mixamo (reference :412-441) ------------------------------------
    james_idx = [20, 78, 138, 118, 1149, 333, 3401, 2221, 4544]
    mixamo_james = {
        'data_h5': _store(j(data_root,
                            'mixamo/James_processed_h5py.h5')),
        'idx_map': _load_idxs(j(data_root, 'mixamo/James_selected.npy')),
        'refined': j(ckpt_root, 'mixamo/james_tv_500k.tar'),
        'retarget': _set(james_idx, length=30, skip=2),
        'bullet': _set(james_idx, n_bullet=n_bullet, center_cam=True,
                       center_kps=True),
        'interpolate': _set(james_idx, n_step=10, undo_rot=True,
                            center_cam=True),
        'bubble': _set(james_idx, n_step=30),
        'animate': _set([3401, 1149, 4544], n_step=10, center_cam=True,
                        center_kps=True, joints=[18, 19, 20, 21, 22, 23]),
        'mesh': _set([20, 78], length=1, undo_rot=False),
    }
    archer_idx = [158, 672, 374, 414, 1886, 2586, 2797, 4147, 4465]
    mixamo_archer = {
        'data_h5': _store(j(data_root,
                            'mixamo/Archer_processed_h5py.h5')),
        'idx_map': _load_idxs(j(data_root, 'mixamo/Archer_selected.npy')),
        'refined': j(ckpt_root, 'mixamo/archer_tv_500k.tar'),
        'retarget': _set(archer_idx, length=30, skip=2),
        'bullet': _set(archer_idx, n_bullet=n_bullet, center_cam=True,
                       center_kps=True),
        'interpolate': _set(archer_idx, n_step=10, undo_rot=True,
                            center_cam=True),
        'bubble': _set(archer_idx, n_step=30),
        'animate': _set([1886, 2586, 4465], n_step=10, center_cam=True,
                        center_kps=True, joints=[18, 19, 20, 21, 22, 23]),
    }

    # --- NeuralBody / ZJU-MoCap (reference :443-449) --------------------
    nb_subjects = ['315', '377', '386', '387', '390', '392', '393', '394']
    nb_idxs = np.arange(
        len(np.concatenate([np.arange(1, 31), np.arange(400, 601)])) * 6)

    def nb_dict(subject):
        return {'data_h5': _store(j(data_root,
                                    f'zju_mocap/{subject}_test_h5py.h5')),
                'val': _set(nb_idxs, length=1, skip=1)}

    return {
        'h36m': {'S9': h36m_s9, 'S11': h36m_s11,
                 'gt_to_mask_map': ('imageSequence', 'Mask')},
        'surreal': {'val': surreal_val, 'easy': surreal_easy,
                    'hard': surreal_hard},
        'perfcap': {'weipeng': perfcap_weipeng, 'nadia': perfcap_nadia,
                    'gt_to_mask_map': ('images', 'masks')},
        'mixamo': {'james': mixamo_james, 'archer': mixamo_archer},
        'neuralbody': {s: nb_dict(s) for s in nb_subjects},
    }


def resolve_entry(entry_spec: str, render_type: str,
                  data_root: str = 'data',
                  ckpt_root: str = 'neurips21_ckpt/trained/ours',
                  catalog: Optional[Dict[str, Any]] = None,
                  ) -> Dict[str, Any]:
    """Look up ``dataset/entry`` and flatten it for one render type.

    Returns {'data_h5', 'refined'?, 'idx_map'?, 'selected_idxs',
    **generator_kwargs} — unknown dataset/entry/type raise KeyError with
    the available choices spelled out.
    """
    cat = catalog if catalog is not None else init_catalog(
        data_root=data_root, ckpt_root=ckpt_root)
    try:
        ds_name, entry_name = entry_spec.split('/')
    except ValueError:
        raise KeyError(
            f"--entry must be 'dataset/entry', got {entry_spec!r}; "
            f"datasets: {sorted(cat)}")
    if ds_name not in cat:
        raise KeyError(f'unknown dataset {ds_name!r}; have {sorted(cat)}')
    entries = {k: v for k, v in cat[ds_name].items()
               if k != 'gt_to_mask_map'}
    if entry_name not in entries:
        raise KeyError(f'unknown entry {entry_name!r} for {ds_name}; '
                       f'have {sorted(entries)}')
    entry = entries[entry_name]
    if render_type not in entry:
        avail = [k for k in entry
                 if k not in ('data_h5', 'refined', 'idx_map')]
        raise KeyError(f'{entry_spec} has no {render_type!r} entry; '
                       f'have {sorted(avail)}')
    out = {'data_h5': entry['data_h5']}
    for k in ('refined', 'idx_map'):
        if k in entry:
            out[k] = entry[k]
    out.update(entry[render_type])
    return out
