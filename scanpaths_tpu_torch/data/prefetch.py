"""Host→device input prefetching.

The reference's input pipeline blocks the training loop on dataset
workers and per-batch ``.cuda()`` copies (reference AiR/train.py:177-181
with num_workers=4).  On TPU the equivalent win is overlapping the
host-side batch assembly + device transfer with the device step: a
background thread prepares and ``device_put``s the NEXT batches while
the current step executes, keeping a bounded queue of device-resident
batches ahead of the consumer.

``PrefetchIterator`` wraps any host batch iterable with a transfer
function (the trainer's ``_device_batch``, which shards onto the mesh),
so the training loop always finds its next batch already on device.

The port's own copy of ``scanpaths_tpu/data/prefetch.py``
(the port imports nothing of the JAX package); keep the two identical.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable


class PrefetchIterator:
    """Iterate ``transfer(batch)`` for batches of ``iterable``, staying
    up to ``depth`` device batches ahead via a daemon thread.

    Exceptions in the producer are re-raised in the consumer; iteration
    order is preserved.  ``depth=0`` degrades to synchronous mapping.
    """

    _END = object()

    def __init__(self, iterable: Iterable, transfer: Callable,
                 depth: int = 2):
        self._iterable = iterable
        self._transfer = transfer
        self._depth = depth

    def __iter__(self):
        if self._depth <= 0:
            for batch in self._iterable:
                yield self._transfer(batch)
            return

        q: queue.Queue = queue.Queue(maxsize=self._depth)

        def producer():
            try:
                for batch in self._iterable:
                    q.put(self._transfer(batch))
                q.put(self._END)
            except BaseException as e:  # noqa: BLE001
                q.put(e)

        t = threading.Thread(target=producer, daemon=True,
                             name="batch-prefetch")
        t.start()
        while True:
            item = q.get()
            if item is self._END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()


def prefetch(iterable: Iterable, transfer: Callable,
             depth: int = 2) -> PrefetchIterator:
    return PrefetchIterator(iterable, transfer, depth)
