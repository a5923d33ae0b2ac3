"""In-memory gcsfs-compatible filesystem for exercising gs:// flows.

The reference's Google-mode publication path (gsutil copies with x3
retries, blackbox.py:7836-7852, 7939-7957) only ever runs on the
cluster; this fake implements the slice of the gcsfs API that
:class:`blackbox_tpu_torch.io.storage.GCSBackend` consumes so the whole
publication flow (atomic product writes, keep-lists, header tables,
obslog) runs in tests and local dev against a bucket-shaped store.

Install with::

    from blackbox_tpu_torch.io.storage import set_gcs_filesystem
    set_gcs_filesystem(FakeGCSFileSystem())

Paths are bucket-relative ("bucket/key/..."), exactly what gcsfs sees
after the ``gs://`` prefix strip.  Blobs are immutable-on-write (a
writer replaces the object atomically on close, like GCS).
"""

from __future__ import annotations

import fnmatch
import io
import time


class _WriteHandle(io.BytesIO):
    """Buffered writer: the object appears atomically on close."""

    def __init__(self, fs, path):
        super().__init__()
        self._fs = fs
        self._path = path

    def close(self):
        if not self.closed:
            self._fs._store[self._path] = (self.getvalue(), time.time())
        super().close()


class FakeGCSFileSystem:
    """Dict-backed stand-in for ``gcsfs.GCSFileSystem``."""

    def __init__(self):
        self._store: dict = {}

    # -- helpers -------------------------------------------------------
    def _norm(self, path: str) -> str:
        return str(path).strip("/")

    # -- gcsfs API subset ---------------------------------------------
    def exists(self, path) -> bool:
        p = self._norm(path)
        return p in self._store or self.isdir(p)

    def isfile(self, path) -> bool:
        return self._norm(path) in self._store

    def isdir(self, path) -> bool:
        p = self._norm(path) + "/"
        return any(k.startswith(p) for k in self._store)

    def open(self, path, mode="rb"):
        p = self._norm(path)
        if "r" in mode:
            if p not in self._store:
                raise FileNotFoundError(f"gs://{p}")
            return io.BytesIO(self._store[p][0])
        if "w" in mode:
            return _WriteHandle(self, p)
        raise ValueError(f"unsupported mode {mode!r}")

    def cat(self, path) -> bytes:
        p = self._norm(path)
        if p not in self._store:
            raise FileNotFoundError(f"gs://{p}")
        return self._store[p][0]

    def pipe_file(self, path, data: bytes):
        self._store[self._norm(path)] = (bytes(data), time.time())

    def glob(self, pattern) -> list:
        pat = self._norm(pattern)
        # gcsfs: a trailing-free pattern with no magic matches exactly;
        # '*' does not cross '/' (use '**' for recursive)
        if "**" in pat:
            rx = fnmatch.translate(pat.replace("**", "\0"))
            rx = rx.replace("\0", ".*")
            import re
            creg = re.compile(rx)
            return sorted(k for k in self._store if creg.match(k))
        out = []
        for k in self._store:
            if fnmatch.fnmatch(k, pat) and (
                    k.count("/") == pat.count("/")):
                out.append(k)
        # directory-style listings: pattern may name pseudo-folders
        seen = set()
        for k in self._store:
            parts = k.split("/")
            for i in range(1, len(parts)):
                d = "/".join(parts[:i])
                if d not in seen and fnmatch.fnmatch(d, pat) and \
                        d.count("/") == pat.count("/"):
                    seen.add(d)
        return sorted(set(out) | seen)

    def rm(self, path, recursive: bool = False):
        p = self._norm(path)
        if p in self._store:
            del self._store[p]
            return
        if recursive:
            pref = p + "/"
            for k in [k for k in self._store if k.startswith(pref)]:
                del self._store[k]
            return
        raise FileNotFoundError(f"gs://{p}")

    def copy(self, src, dst):
        s = self._norm(src)
        if s not in self._store:
            raise FileNotFoundError(f"gs://{s}")
        self._store[self._norm(dst)] = (self._store[s][0], time.time())

    def size(self, path) -> int:
        return len(self.cat(path))

    def modified(self, path):
        p = self._norm(path)
        if p not in self._store:
            raise FileNotFoundError(f"gs://{p}")
        import datetime
        return datetime.datetime.fromtimestamp(self._store[p][1])
