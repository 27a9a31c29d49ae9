"""Prefetching host-side batch loader.

The reference decodes and preprocesses one image at a time inline with
inference (31_clip_embedding_and_save_vector.py:161-180). Here a background
thread decodes/preprocesses the NEXT batch while the device runs the
current one, so host I/O and GPU compute overlap (double buffering).
Host-only code, copied from the JAX package's ``utils/loader.py``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_SENTINEL = object()


class PrefetchIterator(Iterator[U]):
    """Runs ``fn`` over ``items`` in a worker thread, ``depth`` ahead.

    Exceptions in the worker surface at the consuming ``next()`` call;
    ``close()`` (or garbage collection) stops the worker early.
    """

    def __init__(self, items: Iterable[T], fn: Callable[[T], U],
                 depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(iter(items), fn), daemon=True)
        self._thread.start()

    def _worker(self, it, fn) -> None:
        try:
            for item in it:
                if self._stop.is_set():
                    return
                self._q.put(("ok", fn(item)))
            self._q.put(("done", None))
        except BaseException as e:  # surfaced on the consumer side
            self._q.put(("err", e))

    def __iter__(self) -> "PrefetchIterator[U]":
        return self

    def __next__(self) -> U:
        kind, val = self._q.get()
        if kind == "ok":
            return val
        if kind == "done":
            raise StopIteration
        raise val

    def close(self) -> None:
        self._stop.set()
        # Drain so the worker is never blocked on a full queue.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):  # pragma: no cover
        self.close()


def batched(items: list[T], batch_size: int) -> list[list[T]]:
    return [items[i: i + batch_size]
            for i in range(0, len(items), batch_size)]


_decode_pool = None
_decode_pool_lock = threading.Lock()


def parallel_map(fn: Callable[[T], U], items: list[T],
                 workers: int | None = None) -> list[U]:
    """Order-preserving map over a shared decode thread pool.

    Image decode/resize (PIL) releases the GIL, so per-image work inside
    a batch parallelises across host cores — a single-threaded decode
    loop, not the GPU, would cap ingest throughput. Default parallelism
    = min(cpu_count, 8);
    pass ``workers`` to request more — the shared pool grows (never
    shrinks) to the largest request, so every caller gets at least what
    it asked for. On a 1-core host (workers unset) this degenerates to
    a plain map. Per-item exceptions propagate to the caller, same as a
    plain loop."""
    import os

    global _decode_pool
    n = workers or min(8, os.cpu_count() or 1)
    if n <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    with _decode_pool_lock:
        if _decode_pool is None or _decode_pool._max_workers < n:
            from concurrent.futures import ThreadPoolExecutor

            old = _decode_pool
            _decode_pool = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="rbod-decode")
            if old is not None:
                # Already-submitted work keeps running; new submissions
                # go to the grown pool.
                old.shutdown(wait=False)
        # Submit INSIDE the lock (Executor.map schedules eagerly): a
        # concurrent grower can then never shut this pool down between
        # our read of the reference and our submission.
        results = _decode_pool.map(fn, items)
    return list(results)
