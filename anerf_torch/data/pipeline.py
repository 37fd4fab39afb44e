"""Host input pipeline: image sampler, threaded prefetch, collate, and the
hop to the device.

``RayImageSampler``, ``ray_collate`` and ``Prefetcher`` are
``anerf_tpu/data/pipeline.py``'s (reference RayImageSampler /
ray_collate_fn, core/dataset.py:730-802, and the DataLoader of
core/load_data.py:71-84): worker threads sample whole image batches,
batch ``i`` from an RNG keyed on ``(seed, i)`` whatever thread builds
it, and the consumer receives the batches strictly in index order, so
two runs with the same seed see the same batch stream at any worker
count.  Under several ranks every rank runs the same sampler and the
same pixel stream, and each image's pixels are one shared draw of
``N * process_count`` of which rank p keeps block p (the datasets'
``host_slice``): the ranks' batches are disjoint blocks of one global
batch.

``DeviceFeeder`` moves each numpy batch to the device without waiting
for the stream: a copy from pageable host memory drains the stream
first, so each batch is staged in a ring of pinned host buffers and
copied with ``non_blocking=True``; a CUDA event per slot keeps a slot
from being refilled before its last copy has finished.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

# index arrays: int32 on the host, int64 on the device
INDEX_KEYS = ('kp_idx', 'cam_idxs', 'subject_idxs')


class RayImageSampler:
    """Yields sorted batches of N_images image indices; every image is
    visited once per epoch-permutation (reference dataset.py:730-793)."""

    def __init__(self, n_data: int, N_images: int, N_iter: Optional[int] = None,
                 seed: int = 0):
        self.n_data = n_data
        self.N_images = N_images
        self.N_iter = N_iter
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[np.ndarray]:
        perm = iter(self.rng.permutation(self.n_data))
        i = 0
        while self.N_iter is None or i < self.N_iter:
            batch = []
            while len(batch) < self.N_images:
                try:
                    batch.append(next(perm))
                except StopIteration:
                    perm = iter(self.rng.permutation(self.n_data))
            yield np.sort(np.array(batch))
            i += 1


def ray_collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-image dicts and flatten to (N_rand, ...) ray arrays
    (reference ray_collate_fn, dataset.py:795-802), renaming to the
    train-step schema."""
    out = {}
    for k in items[0].keys():
        stacked = np.stack([it[k] for it in items], axis=0)
        out[k] = stacked.reshape((-1,) + stacked.shape[2:])
    if 'kp3d' in out:
        out['kps'] = out.pop('kp3d')
    for k in INDEX_KEYS:
        if k in out:
            out[k] = out[k].astype(np.int32)
    return out


class Prefetcher:
    """Threaded batch producer: workers sample whole image batches and
    collate them; the consumer receives batches strictly in sample-index
    order (seed-deterministic at any worker count).  ``process_index`` /
    ``process_count``: the rank's block of each global batch."""

    def __init__(self, dataset, N_images: int, n_workers: int = 4,
                 buffer_size: int = 8, seed: int = 0,
                 N_iter: Optional[int] = None,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.N_images = N_images
        self.n_workers = max(1, n_workers)
        self.q: 'queue.Queue' = queue.Queue(maxsize=buffer_size)
        self.idx_q: 'queue.Queue' = queue.Queue(maxsize=buffer_size * 2)
        self.seed = seed
        self.N_iter = N_iter
        self.host_slice = (process_index, process_count)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._started = False

    def _put(self, q, item) -> bool:
        """Bounded put that gives up when the pipeline is stopping (so a
        worker never blocks forever on a full queue at shutdown)."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _feeder(self):
        sampler = RayImageSampler(len(self.dataset), self.N_images,
                                  self.N_iter, seed=self.seed)
        for i, idxs in enumerate(sampler):
            if not self._put(self.idx_q, (i, idxs)):
                return
        for _ in range(self.n_workers):
            if not self._put(self.idx_q, None):
                return

    def _worker(self, wid: int):
        while not self._stop.is_set():
            try:
                task = self.idx_q.get(timeout=0.1)
            except queue.Empty:
                continue
            if task is None:
                self._put(self.q, None)
                return
            i, idxs = task
            # keyed on the batch index, not the worker: the sampled
            # pixels do not depend on thread scheduling; nor on the
            # rank, whose block host_slice picks
            rng = np.random.default_rng([self.seed, i])
            hs = self.host_slice
            try:
                # whole-batch assembly where the dataset and mode allow
                # it, else the per-image path (patch and NMS sampling)
                gb = getattr(self.dataset, 'get_batch', None)
                batch = gb(idxs, rng, host_slice=hs) \
                    if gb is not None else None
                if batch is None:
                    items = [self.dataset.get_item(int(idx), rng,
                                                   host_slice=hs)
                             for idx in idxs]
                    batch = ray_collate(items)
            except Exception:
                if self._stop.is_set():     # dataset torn down at shutdown
                    return
                raise
            self._put(self.q, (i, batch))

    def start(self):
        if self._started:
            return
        self._started = True
        t = threading.Thread(target=self._feeder, daemon=True)
        t.start()
        self._threads.append(t)
        for w in range(self.n_workers):
            t = threading.Thread(target=self._worker, args=(w,), daemon=True)
            t.start()
            self._threads.append(t)

    def __iter__(self):
        self.start()
        done = 0
        pending: Dict[int, Any] = {}
        next_i = 0
        while True:
            while next_i in pending:        # release strictly in order
                yield pending.pop(next_i)
                next_i += 1
            item = self.q.get()
            if item is None:
                done += 1
                if done == self.n_workers:
                    for j in sorted(pending):
                        yield pending[j]
                    return
                continue
            pending[item[0]] = item[1]

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)


N_SLOTS = 3     # DeviceFeeder's pinned buffers: batches in flight


class DeviceFeeder:
    """Numpy batches -> tensors on ``device`` (floats float32, the index
    keys int64), without a host wait for the stream.

    On a GPU each batch is copied into slot ``s`` of a ring of
    ``N_SLOTS`` pinned host buffers (one per key, reallocated when a
    shape changes) and from there with ``non_blocking=True``; the host
    waits on the event recorded after slot ``s``'s copies before it
    writes the slot again, ``N_SLOTS`` batches later (the one host wait
    on the device here; ``set_sync_debug_mode`` does not report event
    waits).  On the CPU a batch is copied into fresh tensors."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == 'cuda'
        self._slots: List[Dict[str, torch.Tensor]] = \
            [{} for _ in range(N_SLOTS)]
        self._events: List[Optional[torch.cuda.Event]] = [None] * N_SLOTS
        self._next = 0

    @staticmethod
    def _host_dtype(a: np.ndarray) -> torch.dtype:
        return torch.int32 if np.issubdtype(a.dtype, np.integer) \
            else torch.float32

    def __call__(self, batch: Dict[str, np.ndarray]
                 ) -> Dict[str, torch.Tensor]:
        if not self.cuda:
            out = {}
            for k, v in batch.items():
                t = torch.tensor(np.asarray(v), dtype=self._host_dtype(v))
                out[k] = t.long() if k in INDEX_KEYS else t
            return out
        s = self._next
        self._next = (s + 1) % N_SLOTS
        if self._events[s] is not None:
            self._events[s].synchronize()   # the slot's last copy is done
        slot = self._slots[s]
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            dt = self._host_dtype(v)
            buf = slot.get(k)
            if buf is None or tuple(buf.shape) != v.shape or buf.dtype != dt:
                buf = slot[k] = torch.empty(v.shape, dtype=dt,
                                            pin_memory=True)
            np.copyto(buf.numpy(), v, casting='unsafe')
            t = buf.to(self.device, non_blocking=True)
            out[k] = t.long() if k in INDEX_KEYS else t
        ev = torch.cuda.Event()
        ev.record()
        self._events[s] = ev
        return out
