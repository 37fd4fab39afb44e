"""The numpy data store: the HDF5 schema of anerf_tpu as ``.npy`` files.

A store is a directory ``<name>.npstore/`` with one ``<key>.npy`` per
dataset of the HDF5 schema (``anerf_tpu/data/dataset.py``: imgs, masks
and sampling_masks flattened to (N, H*W, C), bkgds, bkgd_idxs, kp3d,
gt_kp3d, bones, skts, cyls, rest_pose, betas, c2ws, focals, img_shape,
centers, img_paths, ext_scale ...): the same names, shapes and dtypes,
scalars as 0-d arrays and ``img_paths`` as a bytes (``S``) array.
``meta.json`` lists the keys.  The reader opens every array with
``np.load(..., mmap_mode='r')``, so pixel gathers read through the page
cache with no copy, and the store needs nothing beyond numpy.

HDF5 files come in through ``h5_to_store`` (h5py imported inside it, so
it runs where h5py is installed), which copies every dataset bit for
bit:

    python -m anerf_torch.data.store data/mixamo/james_processed_h5py.h5 \\
        data/mixamo/james_processed_h5py.npstore
"""
from __future__ import annotations

import json
import os
import sys
from typing import Dict, Optional

import numpy as np

IMG_KEYS = ('imgs', 'masks', 'sampling_masks', 'bkgds')
META = 'meta.json'


def _write_arrays(store_dir: str, arrays: Dict[str, np.ndarray]) -> str:
    """Each array to ``<key>.npy``, then ``meta.json`` (written last, so
    a store that has it is whole)."""
    os.makedirs(store_dir, exist_ok=True)
    meta = {}
    for k, v in arrays.items():
        np.save(os.path.join(store_dir, f'{k}.npy'), v, allow_pickle=False)
        meta[k] = {'shape': list(v.shape), 'dtype': v.dtype.str}
    with open(os.path.join(store_dir, META), 'w') as f:
        json.dump({'keys': sorted(meta), 'arrays': meta}, f, indent=1)
    return store_dir


def write_store(store_dir: str, data: Dict[str, Optional[np.ndarray]]
                ) -> str:
    """Write a dataset dict as a store: the counterpart of
    ``anerf_tpu.data.h5_writer.write_to_h5py``, which flattens the
    (N, H, W, C) image arrays to (N, H*W, C) and adds ``img_shape``."""
    arrays = {}
    for k, v in data.items():
        if v is None:
            continue
        v = np.asarray(v)
        if k in IMG_KEYS and v.ndim == 4:
            n, h, w, c = v.shape
            v = v.reshape(n, h * w, c)
        arrays[k] = v
    if 'imgs' in data and 'img_shape' not in data:
        arrays['img_shape'] = np.array(np.asarray(data['imgs']).shape)
    return _write_arrays(store_dir, arrays)


def is_store(path: str) -> bool:
    return os.path.isfile(os.path.join(path, META))


def store_keys(store_dir: str) -> list:
    with open(os.path.join(store_dir, META)) as f:
        return list(json.load(f)['keys'])


def open_store(store_dir: str) -> Dict[str, np.ndarray]:
    """Every array of the store as a read-only memmap, by key."""
    if not is_store(store_dir):
        raise FileNotFoundError(f'{store_dir} is not a data store '
                                f'(no {META})')
    return {k: np.load(os.path.join(store_dir, f'{k}.npy'), mmap_mode='r')
            for k in store_keys(store_dir)}


def h5_to_store(h5_path: str, store_dir: str) -> str:
    """Copy every dataset of an HDF5 file into a store, bit for bit
    (same names, shapes and dtypes).  Needs h5py, which the function
    imports itself."""
    import h5py
    with h5py.File(h5_path, 'r') as f:
        arrays = {k: np.asarray(f[k][()]) for k in f.keys()
                  if isinstance(f[k], h5py.Dataset)}
    # h5py tags string dtypes with metadata that .npy cannot hold: the
    # same bytes under the plain dtype
    arrays = {k: v.view(np.dtype(v.dtype.str)) for k, v in arrays.items()}
    return _write_arrays(store_dir, arrays)


def main(argv) -> int:
    if len(argv) != 2:
        print('usage: python -m anerf_torch.data.store IN.h5 OUT.npstore',
              file=sys.stderr)
        return 2
    print(h5_to_store(argv[0], argv[1]))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
