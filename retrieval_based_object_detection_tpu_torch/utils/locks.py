"""Reader-writer lock for concurrent reads of a collection.

Searches, scrolls and counts share a collection; upserts take it alone.
Device dispatch is thread-safe, so only the host-side mutable structures
need exclusion.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    """Shared readers / exclusive writer, writer-preferring.

    * Any number of readers hold the lock together; a writer holds it
      alone.
    * Writer-preferring: once a writer is WAITING, new readers queue
      behind it — a steady stream of searches cannot starve an upsert.
    * The write side is reentrant for its owning thread, and a thread
      holding the write side may enter the read side (write implies
      read).
    * No upgrades: a thread holding only the read side must release it
      before taking the write side.
    * No reentrant reads: writer preference means a thread re-entering
      ``read()`` while a writer is queued deadlocks with that writer.
      Acquire exactly ONE lock scope per request.
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer: int | None = None  # owning thread ident
        self._write_depth = 0
        self._writers_waiting = 0

    @contextmanager
    def read(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                # Write implies read: count as nested write depth so the
                # release path stays symmetric.
                self._write_depth += 1
                nested = True
            else:
                while self._writer is not None or self._writers_waiting:
                    self._cond.wait()
                self._readers += 1
                nested = False
        try:
            yield
        finally:
            with self._cond:
                if nested:
                    self._write_depth -= 1
                else:
                    self._readers -= 1
                    if not self._readers:
                        self._cond.notify_all()

    @contextmanager
    def write(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._write_depth += 1
            else:
                self._writers_waiting += 1
                try:
                    while self._writer is not None or self._readers:
                        self._cond.wait()
                finally:
                    self._writers_waiting -= 1
                self._writer = me
                self._write_depth = 1
        try:
            yield
        finally:
            with self._cond:
                self._write_depth -= 1
                if not self._write_depth:
                    self._writer = None
                    self._cond.notify_all()
