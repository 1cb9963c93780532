"""Multi-process host input pipeline (port of
``bathymetric_gnn_tpu/utils/mp_loader.py``).

Worker processes build whole samples: ``dataset.raw_item`` (noise
synthesis, raster window reads, tiling) and ``dataset.finalize`` (the
graph build and the per-node target gather). The parent only collates
(``training/datasets.collate_samples``). The JAX loader keeps ``finalize``
in the parent, where its graph build is jitted and a worker could claim
the TPU; in the port ``finalize`` is host torch and NumPy on the CPU, the
cost that bounds the graph trainer's epoch.

Design notes:
* ``spawn`` context (not fork): the parent runs threads (the prefetch
  thread, torch's pools) and may hold a CUDA context, which forked
  children must not inherit. Workers re-import the package.
* The dataset is pickled once per worker (the initializer), not per task.
* Each worker runs torch on one CPU thread and never touches
  ``torch.cuda``: the card stays the parent's, and a sample's bits do not
  depend on how many workers there are (torch's CPU reductions can change
  bits with the thread count).
* Noise draws are a function of (epoch base seed, sample index), so the
  batches do not depend on which worker builds what.
* A sliding in-flight window bounds result memory; the parent collates in
  submission order while the workers fill the window.
* A dataset that caches built samples (``cached`` / ``remember``: the
  ground-truth dataset, whose tiles have no random draw) is served from
  its cache where it holds a sample, and keeps what the workers build, so
  its evaluation, calibration and later epochs in the parent build
  nothing again. The JAX loader has no such path (its parent finalizes).
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
from collections import deque
from concurrent.futures import Future, ProcessPoolExecutor
from typing import Iterator, Tuple

import numpy as np

_WORKER_DS = None


def _init_worker(ds_bytes: bytes) -> None:
    import torch

    torch.set_num_threads(1)
    global _WORKER_DS
    _WORKER_DS = pickle.loads(ds_bytes)


def _sample(idx: int, seed: int):
    return _WORKER_DS.finalize(_WORKER_DS.raw_item(int(idx), seed=int(seed)))


class ProcessSampleLoader:
    """``datasets.epoch_batches`` backed by a process pool.

    Usage:
        with ProcessSampleLoader(dataset, num_workers=2) as loader:
            for graph, targets in loader.epoch_batches(bs, rng):
                ...
    """

    def __init__(self, dataset, num_workers: int = 2,
                 max_inflight: int = 32, mp_context: str = "spawn"):
        if not hasattr(dataset, "raw_item"):
            raise TypeError(f"{type(dataset).__name__} has no raw_item — "
                            f"not splittable for worker processes")
        self.dataset = dataset
        self.num_workers = int(num_workers)
        self.max_inflight = max(int(max_inflight), 2)
        ctx = mp.get_context(mp_context)
        self._pool = ProcessPoolExecutor(
            max_workers=self.num_workers, mp_context=ctx,
            initializer=_init_worker,
            initargs=(pickle.dumps(dataset),))

    def epoch_batches(self, batch_size: int, rng: np.random.Generator,
                      shuffle: bool = True) -> Iterator[Tuple]:
        """Shuffled fixed-size batches (the contract of
        ``datasets.epoch_batches``; the ragged tail is dropped). Sample
        ``i`` is built with seed ``base + i``, ``base`` drawn from ``rng``
        after the shuffle."""
        from ..training.datasets import collate_samples

        order = np.arange(len(self.dataset))
        if shuffle:
            rng.shuffle(order)
        base = int(rng.integers(1 << 30))
        usable = len(order) - len(order) % batch_size
        order = order[:usable]

        cached = getattr(self.dataset, "cached", None)
        remember = getattr(self.dataset, "remember", None)
        pending: deque = deque()
        submit_iter = iter(order)

        def submit_more():
            while len(pending) < self.max_inflight:
                try:
                    i = int(next(submit_iter))
                except StopIteration:
                    return
                hit = cached(i) if cached is not None else None
                pending.append((i, hit if hit is not None else
                                self._pool.submit(_sample, i, base + i)))

        submit_more()
        batch = []
        while pending:
            i, sample = pending.popleft()
            if isinstance(sample, Future):
                sample = sample.result()
                if remember is not None:
                    remember(i, sample)
            submit_more()
            batch.append(sample)
            if len(batch) == batch_size:
                yield collate_samples(batch)
                batch = []

    def close(self) -> None:
        """Cancel the tasks not started and wait for the workers to
        exit."""
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
