"""Host-side input pipeline: background prefetch for the training loop.

Counterpart of abx_tpu/data/pipeline.py.  `prefetch(it, size)` drains `it`
into a bounded queue from a daemon thread, so the host builds the next
batches while the card runs the current step; producer exceptions are
re-raised at the consumer's `next()`.  With `device_put_ahead`, the
producer thread also moves each batch to `device` through the samplers'
`to_device_batch` (pinned host memory and a non-blocking copy for a CUDA
device), so the host-to-device copy of batch N+1 overlaps step N and the
trainer's own `to_device_batch` finds it there already.

Threads, not processes: the featurisation's numpy work releases the GIL,
and one producer keeps up when the host time a batch is below the device
time a step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

from abx_tpu_torch.sampling.sampler import to_device_batch


class _Stop:
    """Queue sentinel: producer exhausted the underlying iterator."""


class _Raised:
    """Queue sentinel wrapping a producer-side exception."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchIterator:
    """Bounded background-thread prefetch around a batch iterator.

    Keeps the wrapped iterator's order and contents; only the timing
    changes.  Single consumer.  `close()` stops the producer promptly even
    when the queue is full."""

    def __init__(self, it: Iterator, size: int = 2,
                 device_put_ahead: bool = False,
                 device: Optional[object] = None):
        if size < 1:
            raise ValueError(f'prefetch size must be >= 1, got {size}')
        self._q: queue.Queue = queue.Queue(maxsize=size)
        self._closed = threading.Event()
        self._device = device if device is not None else 'cpu'
        self._put_ahead = device_put_ahead
        self._thread = threading.Thread(
            target=self._produce, args=(it,), daemon=True,
            name='abx-prefetch')
        self._thread.start()

    def _put(self, item) -> bool:
        """Put with a timeout, so close() interrupts a producer blocked on
        a full queue (items and sentinels alike)."""
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, it: Iterator) -> None:
        try:
            for item in it:
                if self._put_ahead:
                    item = to_device_batch(item, self._device,
                                           non_blocking=True)
                if not self._put(item):
                    return
            self._put(_Stop())
        except BaseException as e:  # re-raised on the consumer side
            self._put(_Raised(e))

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed.is_set():
            raise StopIteration
        item = self._q.get()
        if isinstance(item, _Stop):
            self._closed.set()
            raise StopIteration
        if isinstance(item, _Raised):
            self._closed.set()
            raise item.exc
        return item

    def close(self) -> None:
        self._closed.set()
        # Free one slot so a producer blocked on put() sees the event.
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __del__(self):  # pragma: no cover - GC timing dependent
        try:
            self.close()
        except Exception:
            pass


def prefetch(it: Iterator, size: int = 2, device_put_ahead: bool = False,
             device: Optional[object] = None) -> Iterator:
    """Wrap `it` with background prefetch (`size=0` returns `it`)."""
    if size <= 0:
        return it
    return PrefetchIterator(it, size=size, device_put_ahead=device_put_ahead,
                            device=device)
