"""Background-thread input pipeline (port of
``pretrain_gnns_tpu.data.prefetch``): a daemon thread pulls the loader
``depth`` batches ahead of the training loop, so packing and the masking
transform overlap the GPU's work."""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator


class _End:
    pass


class _Err:
    def __init__(self, e: BaseException):
        self.e = e


def prefetch(iterable: Iterable[Any], depth: int = 3) -> Iterator[Any]:
    """Iterate ``iterable`` on a daemon thread, ``depth`` items ahead.
    An exception raised by the producer re-raises at the consumer."""
    q: "queue.Queue[Any]" = queue.Queue(maxsize=max(depth, 1))

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # handed to the consumer, re-raised there
            q.put(_Err(e))
            return
        q.put(_End())

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if isinstance(item, _End):
            return
        if isinstance(item, _Err):
            raise item.e
        yield item


def chunked(iterator: Iterator[Any], k: int) -> Iterator[list]:
    """Group consecutive items into lists of ``k``; a final short group is
    yielded as it is."""
    buf: list = []
    for item in iterator:
        buf.append(item)
        if len(buf) == k:
            yield buf
            buf = []
    if buf:
        yield buf
