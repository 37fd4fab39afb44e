"""The port's data layer against anerf_tpu's on the same synthetic data.

``make_synthetic_store`` must write the arrays ``make_synthetic_h5``
writes, ``h5_to_store`` must copy an HDF5 file bit for bit, and for the
same seed the port's batches from a store must equal anerf_tpu's from
the HDF5 bit for bit, with anerf_tpu on its numpy loader
(``ANERF_NO_NATIVE=1``): ``get_batch``, the per-image path, and the
``Prefetcher``'s first batches at one and three workers, for a plain
dataset, with the temporal wrapper, and for two subjects.
"""
import os

import h5py
import numpy as np
import pytest

from anerf_tpu.data import dataset as JD
from anerf_tpu.data import loaders as JL
from anerf_tpu.data import native
from anerf_tpu.data import pipeline as JPL
from anerf_tpu.data.h5_writer import make_synthetic_h5

from anerf_torch.data import dataset as TD
from anerf_torch.data import loaders as TL
from anerf_torch.data import pipeline as TPL
from anerf_torch.data.store import h5_to_store, open_store, store_keys
from anerf_torch.data.writer import make_synthetic_store

from test_torch_threads import one_torch_thread  # noqa: F401

H = W = 24


@pytest.fixture(autouse=True)
def numpy_loader(monkeypatch):
    """anerf_tpu's loader on its numpy fallbacks (ANERF_NO_NATIVE=1)."""
    monkeypatch.setenv('ANERF_NO_NATIVE', '1')
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_tried', False)


def _pair(tmp, name, **kw):
    h5 = make_synthetic_h5(str(tmp / f'{name}.h5'), H=H, W=W, **kw)
    st = make_synthetic_store(str(tmp / f'{name}.npstore'), H=H, W=W, **kw)
    return h5, st


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('torch_data')
    return {'frames': _pair(tmp, 'a', n_frames=6),
            'subject2': _pair(tmp, 'b', n_frames=5, body_scale=2.0, seed=3),
            'surreal': _pair(tmp, 'surreal_train_h5py', n_frames=4, n_cams=3,
                             layout='surreal')}


def _h5_arrays(path):
    with h5py.File(path, 'r') as f:
        return {k: f[k][()] for k in f.keys()}


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert np.array_equal(a, b)


@pytest.mark.parametrize('layout', ['frames', 'surreal'])
def test_synthetic_store_equals_synthetic_h5(data, layout):
    h5, st = data['surreal' if layout == 'surreal' else 'frames']
    ref = _h5_arrays(h5)
    got = open_store(st)
    assert sorted(ref) == sorted(got) == store_keys(st)
    for k in ref:
        _assert_same(np.asarray(ref[k]), np.asarray(got[k]))


def test_h5_to_store_copies_bit_for_bit(data, tmp_path):
    h5, _ = data['frames']
    # a chunked, gzip-compressed layout as well as the contiguous one
    chunked = make_synthetic_h5(str(tmp_path / 'c.h5'), n_frames=3, H=H,
                                W=W, img_layout='chunked')
    for path in (h5, chunked):
        st = h5_to_store(path, str(tmp_path / (os.path.basename(path)
                                               + '.npstore')))
        ref, got = _h5_arrays(path), open_store(st)
        assert sorted(ref) == sorted(got)
        for k in ref:
            _assert_same(np.asarray(ref[k]), np.asarray(got[k]))


def _assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        _assert_same(np.asarray(a[k]), np.asarray(b[k]))


def _datasets(data, kind, N=8, pose_per_ray=True):
    if kind == 'concat':
        (ha, sa), (hb, sb) = data['frames'], data['subject2']
        j = JD.ConcatH5Dataset([JL.SyntheticDataset(ha, N_samples=N),
                                JL.SyntheticDataset(hb, N_samples=N)])
        t = TD.ConcatDataset([TL.SyntheticDataset(sa, N_samples=N),
                              TL.SyntheticDataset(sb, N_samples=N)])
    elif kind == 'surreal':
        h5, st = data['surreal']
        j = JL.SurrealDataset(h5, N_samples=N, N_rand_kps='kps_3',
                              N_cams=2, split='train')
        t = TL.SurrealDataset(st, N_samples=N, N_rand_kps='kps_3',
                              N_cams=2, split='train')
    else:
        h5, st = data['frames']
        j = JL.SyntheticDataset(h5, N_samples=N)
        t = TL.SyntheticDataset(st, N_samples=N)
        if kind == 'temporal':
            for d in (j, t):
                d.temp_validity = np.array([0, 1, 1, 0, 1, 1])
            j, t = JD.TemporalDatasetWrapper(j), TD.TemporalDatasetWrapper(t)
    JD.set_pose_per_ray(j, pose_per_ray)
    TD.set_pose_per_ray(t, pose_per_ray)
    return j, t


@pytest.mark.parametrize('kind', ['frames', 'temporal', 'concat', 'surreal'])
def test_get_batch_bit_equal(data, kind):
    j, t = _datasets(data, kind)
    for seed, idxs in ((0, [0, 2, 5]), (1, [1, 1, 3, 4]), (2, [0, 5])):
        a = j.get_batch(np.array(idxs), np.random.default_rng(seed))
        b = t.get_batch(np.array(idxs), np.random.default_rng(seed))
        _assert_batches_equal(a, b)


@pytest.mark.parametrize('kind', ['frames', 'concat'])
def test_get_item_bit_equal(data, kind):
    """The per-image path (patch sampling and NMS take it)."""
    j, t = _datasets(data, kind, pose_per_ray=True)
    for q in (0, 4):
        a = j.get_item(q, np.random.default_rng(q))
        b = t.get_item(q, np.random.default_rng(q))
        _assert_batches_equal(a, b)


def test_sample_distinct_matches_the_numpy_fallback():
    """The vectorized partial Fisher-Yates against anerf_tpu's loop, on
    lists of different lengths and draws that revisit swapped slots."""
    rng = np.random.default_rng(0)
    valid = [np.sort(rng.choice(300, n, replace=False)).astype(np.int32)
             for n in (40, 7, 300, 13)]
    u = rng.random((4, 7))
    u[0, :3] = [0.999, 0.999, 0.0]        # the same last slot, twice
    _assert_same(native.sample_distinct(valid, u),
                 TD.sample_distinct(valid, u))


@pytest.mark.parametrize('n_workers', [1, 3])
@pytest.mark.parametrize('kind', ['frames', 'temporal', 'concat'])
def test_prefetcher_first_batches_bit_equal(data, kind, n_workers):
    j, t = _datasets(data, kind, N=6, pose_per_ray=False)
    pj = JPL.Prefetcher(j, N_images=3, n_workers=n_workers, seed=5, N_iter=5)
    pt = TPL.Prefetcher(t, N_images=3, n_workers=n_workers, seed=5, N_iter=5)
    try:
        bj, bt = list(pj), list(pt)
    finally:
        pj.stop()
        pt.stop()
    assert len(bj) == len(bt) == 5
    for a, b in zip(bj, bt):
        _assert_batches_equal(a, b)


@pytest.mark.parametrize('kind', ['frames', 'concat', 'surreal'])
def test_meta_and_render_data_equal(data, kind):
    j, t = _datasets(data, kind)
    for a, b in ((j.get_meta(), t.get_meta()),
                 (j.get_render_data(), t.get_render_data()),
                 (j.get_render_data([1, 2]), t.get_render_data([1, 2]))):
        assert sorted(a) == sorted(b)
        for k in a:
            va, vb = a[k], b[k]
            if k == 'skel_type':
                assert va.joint_trees == vb.joint_trees
            elif isinstance(va, tuple):
                for x, y in zip(va, vb):
                    _assert_same(np.asarray(x), np.asarray(y))
            elif va is None or np.isscalar(va):
                assert va == vb, k
            else:
                _assert_same(np.asarray(va), np.asarray(vb))


def test_load_data_matches(data, tmp_path):
    """``load_data`` of a synthetic recipe: the same attributes, render
    data and first batch as anerf_tpu's from the HDF5."""
    from anerf_tpu.utils.config import load_config as j_load
    from anerf_torch.utils.config import load_config as t_load
    h5, st = data['frames']
    cfg = os.path.join(os.path.dirname(__file__), '..', 'configs',
                       'synthetic_tiny.txt')
    over = dict(num_workers=1, n_iters=2, N_rand=24, N_sample_images=3)
    pj, rj, aj = JL.load_data(j_load(cfg, datadir=h5, **over))
    pt, rt, at = TL.load_data(t_load(cfg, datadir=st, **over))
    try:
        _assert_batches_equal(next(iter(pj)), next(iter(pt)))
    finally:
        pj.stop()
        pt.stop()
    for k in ('kp3d', 'bones', 'rest_pose', 'c2ws'):
        _assert_same(np.asarray(aj[k]), np.asarray(at[k]))
    _assert_same(rj['imgs'], rt['imgs'])


def test_synthetic_catalog_finds_stores_by_subject(tmp_path):
    """A synthetic ``datadir`` is a store itself or a directory of
    ``<subject>.npstore`` stores (two synthetic subjects side by side)."""
    st = make_synthetic_store(str(tmp_path / 'x.npstore'), n_frames=2, H=8,
                              W=8)
    assert TL.DATASET_CATALOG['synthetic'](st, 'any') == st
    assert TL.DATASET_CATALOG['synthetic'](str(tmp_path), 'x') == st


def test_device_feeder_on_cpu():
    """On the CPU the feeder copies: floats float32, index keys int64."""
    import torch
    feed = TPL.DeviceFeeder('cpu')
    b = {'rays_o': np.ones((4, 3), np.float32),
         'kp_idx': np.arange(4, dtype=np.int32),
         'subject_idxs': np.zeros(4, np.int32)}
    out = feed(b)
    assert out['rays_o'].dtype == torch.float32
    assert out['kp_idx'].dtype == out['subject_idxs'].dtype == torch.long
    b['rays_o'][:] = 2          # a copy, not a view of the numpy batch
    assert float(out['rays_o'].max()) == 1.
    assert torch.equal(out['kp_idx'], torch.arange(4))
