"""Input-pipeline prefetching (counterpart of ``vidsgg/runtime/prefetch.py``).

The reference overlaps host work with GPU compute via
``DataLoader(num_workers=4)`` (TEMPURA_train.py:46). Here a background
thread keeps a small queue of ready (already featurized, padded) videos,
so that the next video's host preparation overlaps with the device step.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

_SENTINEL = object()


def prefetch(source: Callable[[], Iterable], depth: int = 2) -> Callable[[], Iterator]:
    """Wrap an iterable factory with a depth-bounded background producer."""

    def wrapped():
        q: queue.Queue = queue.Queue(maxsize=depth)
        err: list[BaseException] = []

        def producer():
            try:
                for item in source():
                    q.put(item)
            except BaseException as e:  # propagate into the consumer
                err.append(e)
            finally:
                q.put(_SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item

    # forward the source's skip/yield accounting (SourceStats) if present
    wrapped.stats = getattr(source, "stats", None)
    return wrapped
