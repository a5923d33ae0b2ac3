"""Night-mode ingest: directory watcher + arrival-completion guard.

The reference night mode runs a watchdog ``PollingObserver`` feeding an
mp.Queue, and ``get_file`` retries reading a frame for up to 180 s until
the rsync transfer completes (reference blackbox.py:392-612).
Here: a polling thread on the storage abstraction feeding a
``queue.Queue`` (one process owns the device, so frames are batched
in-process rather than forked), and a size-stability guard instead of
retry-reading.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

from blackbox_tpu_torch.io.storage import get_backend, list_files


class DirectoryWatcher:
    """Polls a directory pattern; enqueues new files once stable."""

    def __init__(self, pattern: str, q: "queue.Queue[str]",
                 poll_s: float = 2.0, stable_s: float = 2.0,
                 settle_timeout_s: float = 180.0,
                 preload_existing: bool = False):
        self.pattern = pattern
        self.q = q
        self.poll_s = poll_s
        self.stable_s = stable_s
        self.settle_timeout_s = settle_timeout_s
        self._seen = set()
        self._pending = {}          # path -> (size, first_seen, last_change)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if not preload_existing:
            self._seen.update(list_files(pattern))

    def _scan_once(self, now: float):
        be = get_backend(self.pattern)
        for path in list_files(self.pattern):
            if path in self._seen:
                continue
            try:
                size = be.size(path)
            except OSError:
                continue
            if path not in self._pending:
                self._pending[path] = (size, now, now)
                continue
            last_size, first, changed = self._pending[path]
            if size != last_size:
                self._pending[path] = (size, first, now)
                continue
            # size stable long enough, or we give up waiting (reference
            # waits <=180 s for rsync completion, blackbox.py:555-590)
            if now - changed >= self.stable_s \
                    or now - first >= self.settle_timeout_s:
                self._seen.add(path)
                del self._pending[path]
                self.q.put(path)

    def start(self):
        def loop():
            while not self._stop.is_set():
                self._scan_once(time.time())
                self._stop.wait(self.poll_s)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)


def drain_until(q: "queue.Queue[str]", handler: Callable[[str], None],
                until: Callable[[], bool], idle_wait_s: float = 1.0):
    """Process queue items until ``until()`` is true AND the queue is
    empty (the reference keeps reducing past sunrise while frames remain,
    blackbox.py:444-453)."""
    while True:
        try:
            item = q.get(timeout=idle_wait_s)
        except queue.Empty:
            if until():
                return
            continue
        handler(item)
