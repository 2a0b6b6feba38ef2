"""Host-side producer/consumer pipelining.

The analog of the reference's two-thread merge pipeline (bwt.cpp:152-190):
there a producer thread fills a single-slot RABuffer while the consumer
interleaves the previous batch.  Here the producer is a chunk iterator
(device->host RA stream, spill-ladder k-way merge) whose numpy work — cumsum,
duplicate summing, exception patching — overlaps the ctypes interleave call,
which releases the GIL for the duration of the C++ run.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_DONE = object()


def prefetch_chunks(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Drain `it` on a background thread, keeping up to `depth` items queued.

    Items must be safe to hand across threads (fresh arrays — NOT views into
    buffers the producer reuses).  Exceptions re-raise at the consumer; an
    abandoned consumer unblocks the producer via a poison get on close.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def run() -> None:
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(_DONE)
        except BaseException as e:  # noqa: BLE001 - propagate to consumer
            q.put(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
