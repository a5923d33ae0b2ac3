"""Advisory locks for single-writer publication (SURVEY.md §5.2).

The reference serialises master creation and file deletion with one
global multiprocessing lock (blackbox.py:321-323, 1643-1661) and still
documents an unresolved cross-job race on shared-filesystem masters
(blackbox.py:4741-4755, "Header missing END card").  The functional
design here removes most races (pure kernels, content-addressed tmp
files), but cross-PROCESS publication of masters/refs on a shared
filesystem still needs an advisory lock — fcntl.flock on a sidecar
file, which NFS and local filesystems both honour.
"""

from __future__ import annotations

import contextlib
import errno
import fcntl
import os
import time


class LockTimeout(TimeoutError):
    pass


@contextlib.contextmanager
def advisory_lock(path: str, timeout: float = 300.0,
                  poll: float = 0.25):
    """Exclusive advisory lock on ``path + '.lock'``.

    Blocks up to ``timeout`` seconds, then raises :class:`LockTimeout`.
    Reentrant use within one process is NOT supported (matches the
    reference's single global lock semantics).
    """
    lock_path = path + ".lock"
    os.makedirs(os.path.dirname(lock_path) or ".", exist_ok=True)
    fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
    t0 = time.time()
    try:
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError as e:
                if e.errno not in (errno.EAGAIN, errno.EACCES):
                    raise
                if time.time() - t0 > timeout:
                    raise LockTimeout(f"lock on {lock_path} not "
                                      f"acquired in {timeout:.0f}s")
                time.sleep(poll)
        yield
    finally:
        try:
            fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)
