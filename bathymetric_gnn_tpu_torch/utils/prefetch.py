"""Host-side async input pipeline.

Copy of ``bathymetric_gnn_tpu/utils/prefetch.py``. A background thread
materializes upcoming batches (tile IO, noise synthesis, collation) while
the card runs the current step; PyTorch's asynchronous launches overlap
the host-to-device copy with compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")


def prefetch_iterator(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Run `it` in a background thread, keeping `depth` items ready."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # propagate to consumer
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


class PrefetchingLoader:
    """Wraps a batch-producing callable into a prefetched epoch iterator."""

    def __init__(self, make_epoch: Callable[[], Iterable], depth: int = 2):
        self.make_epoch = make_epoch
        self.depth = depth

    def __iter__(self):
        return prefetch_iterator(self.make_epoch(), self.depth)
