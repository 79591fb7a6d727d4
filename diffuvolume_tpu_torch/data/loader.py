"""Parallel batch loader and prefetch to the card.

The port's counterpart of ``diffuvolume_tpu/data/loader.py``, of the
reference's input pipeline — torch ``DataLoader(num_workers=16,
drop_last=True, pin_memory=True)`` (SceneFlow/main.py:59-63) and
``fetch_dataloader``'s worker-seeded loading
(KITTI15/core/stereo_datasets.py:295-335, worker seeding :106-110):

  * a worker pool decodes and augments samples concurrently on the host,
  * each fetch checks out an exclusive dataset replica and reseeds its RNG
    from (seed, epoch, batch_index) — the analog of torch's
    ``worker_init_fn`` per-worker reseeding, but deterministic under any
    thread timing,
  * ``prefetch_to_device`` keeps N batches in flight to the card, copied
    from pinned host memory on a side stream, so that host decode and the
    copy overlap the card's work.
"""

from __future__ import annotations

import collections
import copy
import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator

import numpy as np
import torch

from diffuvolume_tpu_torch.utils.device import resolve_device


def default_collate(samples: list[dict]) -> dict:
    """Stack per-sample dict fields into batched arrays.

    Array-like fields are stacked on a new leading axis; strings (filenames)
    are collected into lists.  Fields missing from any sample are dropped
    (matching torch's strict collate would raise; test-time datasets here may
    omit ``disp_gt``).
    """
    keys = set(samples[0])
    for s in samples[1:]:
        keys &= set(s)
    out: dict[str, Any] = {}
    for k in keys:
        v0 = samples[0][k]
        if isinstance(v0, str):
            out[k] = [s[k] for s in samples]
        else:
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
    return out


class DataLoader:
    """Iterable over collated batches with a reseeded-replica worker pool.

    Args:
      dataset: indexable with ``__len__``; a ``rng`` attribute (numpy
        Generator), if present, is reseeded per worker replica.
      batch_size: batch size.
      shuffle: new permutation every epoch (epoch = one ``__iter__`` call).
      num_workers: 0 = synchronous in-caller loading; N > 0 = thread pool with
        N dataset replicas and up to ``prefetch_batches`` batches in flight.
      drop_last: drop the trailing partial batch (the reference trains with
        ``drop_last=True``; keep it True so every step sees one batch shape).
      seed: epoch-order and worker-RNG base seed.
      collate: batch assembly function.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 0,
        drop_last: bool = True,
        seed: int = 0,
        prefetch_batches: int = 2,
        collate: Callable[[list[dict]], dict] = default_collate,
    ):
        if batch_size < 1 or num_workers < 0:
            raise ValueError(f"batch_size {batch_size} and num_workers {num_workers}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch_batches = max(prefetch_batches, 1)
        self.collate = collate
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self) -> list[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self._epoch).permutation(n)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        return [
            order[i : i + self.batch_size] for i in range(0, stop, self.batch_size)
        ]

    def __iter__(self) -> Iterator[dict]:
        batches = self._batch_indices()
        self._epoch += 1
        if self.num_workers == 0:
            for idx in batches:
                yield self.collate([self.dataset[int(i)] for i in idx])
            return
        yield from self._iter_parallel(batches)

    def _iter_parallel(self, batches: list[np.ndarray]) -> Iterator[dict]:
        # Exclusive check-out of dataset replicas; each replica's RNG is
        # reseeded from (seed, epoch, batch_index) before fetching, so the
        # augmentation stream is deterministic regardless of thread timing —
        # stronger than torch's per-worker worker_init_fn seeding, which ties
        # randomness to the worker↔batch assignment.
        replicas: queue.Queue = queue.Queue()
        for _ in range(self.num_workers):
            replicas.put(copy.copy(self.dataset))
        epoch = self._epoch

        def fetch(batch_idx: int, idx: np.ndarray) -> dict:
            rep = replicas.get()
            try:
                if hasattr(rep, "rng"):
                    rep.rng = np.random.default_rng(
                        (self.seed, epoch, batch_idx)
                    )
                return self.collate([rep[int(i)] for i in idx])
            finally:
                replicas.put(rep)

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            inflight = min(self.prefetch_batches + 1, len(batches))
            futures = [pool.submit(fetch, j, b) for j, b in enumerate(batches[:inflight])]
            next_submit = inflight
            for _ in range(len(batches)):
                out = futures.pop(0).result()
                if next_submit < len(batches):
                    futures.append(pool.submit(fetch, next_submit, batches[next_submit]))
                    next_submit += 1
                yield out


def _map_arrays(batch, fn):
    """``fn`` on every numpy array of a batch (dicts, lists and tuples
    walked); other leaves (file names, pads) as they are."""
    if isinstance(batch, dict):
        return {k: _map_arrays(v, fn) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map_arrays(v, fn) for v in batch)
    if isinstance(batch, np.ndarray):
        return fn(batch)
    return batch


def _tensors(batch) -> list:
    if isinstance(batch, dict):
        return [t for v in batch.values() for t in _tensors(v)]
    if isinstance(batch, (list, tuple)):
        return [t for v in batch for t in _tensors(v)]
    return [batch] if isinstance(batch, torch.Tensor) else []


def prefetch_to_device(iterator, device=None, size: int = 2):
    """Keep ``size`` batches ahead on ``device`` (default ``cuda:0``).

    Each numpy array of a batch becomes a tensor on ``device``; other
    leaves pass through.  On a CUDA device the arrays are copied into
    pinned host memory and sent with ``non_blocking=True`` on a side
    stream; the consumer's stream waits for a batch's copies before the
    batch is handed over, and the batch's tensors are recorded on that
    stream so that their memory is not reused while it still reads them.
    ``device="cpu"`` hands over the arrays as CPU tensors (copies).
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        for batch in iterator:
            yield _map_arrays(batch, lambda a: torch.from_numpy(np.array(a)))
        return
    side = torch.cuda.Stream(dev)
    q: collections.deque = collections.deque()

    def put(batch):
        with torch.cuda.stream(side):
            out = _map_arrays(batch, lambda a: torch.from_numpy(np.ascontiguousarray(a))
                              .pin_memory().to(dev, non_blocking=True))
            done = torch.cuda.Event()
            done.record(side)
        q.append((out, done))

    def take():
        out, done = q.popleft()
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for t in _tensors(out):
            t.record_stream(consumer)
        return out

    for batch in iterator:
        put(batch)
        if len(q) > size:
            yield take()
    while q:
        yield take()
