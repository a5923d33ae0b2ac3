"""Storage backends: POSIX and GCS behind one interface.

The reference switches between POSIX paths and ``gs://`` buckets by
string prefix in every I/O helper (reference blackbox.py:209, 1041,
7664-7766, copies in blackbox_slurm_google.py:1144-1510).  Here the
switch happens once: :func:`get_backend` resolves a path to a backend
object; everything else calls the backend protocol.  The GCS backend is
import-gated (gcsfs/google-cloud are not in this image) but keeps the
full protocol so cluster deployments only swap the class.
"""

from __future__ import annotations

import glob as _glob
import os
import shutil
from typing import Iterable


class PosixBackend:
    """Plain filesystem.  Writing methods refuse gs:// paths: a
    mis-routed bucket path would otherwise create a literal ``gs:/``
    directory tree (observed from a cross-backend copy bug)."""

    @staticmethod
    def _no_gs(path):
        if str(path).startswith("gs://"):
            raise ValueError(f"gs:// path reached the POSIX backend: "
                             f"{path}")

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def isfile(self, path: str) -> bool:
        return os.path.isfile(path)

    def isdir(self, path: str) -> bool:
        return os.path.isdir(path)

    def open(self, path: str, mode: str = "rb"):
        return open(path, mode)

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as fh:
            return fh.read()

    def write_bytes(self, path: str, data: bytes):
        self._no_gs(path)
        self.make_dir(os.path.dirname(path))
        tmp = path + ".part"
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)          # atomic publication

    def make_dir(self, path: str):
        self._no_gs(path)
        if path:
            # exist_ok by construction: the reference hit a mkdir race on
            # its cluster (blackbox.py:3890-3894)
            os.makedirs(path, exist_ok=True)

    def list_files(self, pattern: str) -> list:
        # '**' patterns recurse (CLI --recursive; gcsfs globs ** natively)
        return sorted(p for p in _glob.glob(pattern, recursive=True)
                      if os.path.isfile(p))

    def list_folders(self, pattern: str) -> list:
        return sorted(p for p in _glob.glob(pattern) if os.path.isdir(p))

    def remove(self, path: str):
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def copy(self, src: str, dst: str):
        self._no_gs(dst)
        self.make_dir(os.path.dirname(dst))
        shutil.copy2(src, dst)

    def size(self, path: str) -> int:
        return os.path.getsize(path)

    def mtime(self, path: str) -> float:
        return os.path.getmtime(path)


class GCSBackend:
    """Google Cloud Storage behind a gcsfs-compatible filesystem.

    Mirrors the reference's gsutil/google.cloud.storage usage
    (blackbox.py:7826-7852; blackbox_slurm_google.py:1144-1510),
    including its x3 retry on failed copies (blackbox.py:7836-7852,
    7939-7957) — here every operation retries with exponential backoff,
    since GCS transients hit reads and listings as much as copies.

    ``fs`` defaults to a real ``gcsfs.GCSFileSystem`` (constructor
    raises if the package is missing); tests and local dev inject
    :class:`blackbox_tpu_torch.io.fakegcs.FakeGCSFileSystem` via
    :func:`set_gcs_filesystem`.
    """

    def __init__(self, fs=None, retries: int = 3, backoff: float = 0.5):
        if fs is None:                    # pragma: no cover - env-gated
            try:
                import gcsfs  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "gs:// paths need the gcsfs package; not available "
                    "in this environment") from e
            fs = gcsfs.GCSFileSystem()
        self.fs = fs
        self.retries = int(retries)
        self.backoff = float(backoff)

    def _retry(self, op, *args):
        import time as _time
        last = None
        for attempt in range(self.retries):
            try:
                return op(*args)
            except FileNotFoundError:
                raise                     # definitive, not transient
            except Exception as e:        # noqa: BLE001 - fs-specific
                last = e
                if attempt + 1 < self.retries and self.backoff > 0:
                    _time.sleep(self.backoff * 2 ** attempt)
        raise last

    def exists(self, path):
        return self._retry(self.fs.exists, _strip(path))

    def isfile(self, path):
        return self._retry(self.fs.isfile, _strip(path))

    def isdir(self, path):
        return self._retry(self.fs.isdir, _strip(path))

    def open(self, path, mode="rb"):
        return self._retry(self.fs.open, _strip(path), mode)

    def read_bytes(self, path):
        return self._retry(self.fs.cat, _strip(path))

    def write_bytes(self, path, data):
        def _write():
            # one-shot object write: GCS publication is atomic per
            # object, the reference's .part/rename dance is POSIX-only
            with self.fs.open(_strip(path), "wb") as fh:
                fh.write(data)
        self._retry(_write)

    def make_dir(self, path):
        pass                              # buckets have no directories

    def list_files(self, pattern):
        hits = self._retry(self.fs.glob, _strip(pattern))
        return ["gs://" + p for p in hits if self.fs.isfile(p)]

    def list_folders(self, pattern):
        hits = self._retry(self.fs.glob, _strip(pattern))
        return ["gs://" + p for p in hits if self.fs.isdir(p)]

    def remove(self, path):
        self._retry(self.fs.rm, _strip(path), True)

    def copy(self, src, dst):
        self._retry(self.fs.copy, _strip(src), _strip(dst))

    def size(self, path):
        return self._retry(self.fs.size, _strip(path))

    def mtime(self, path):
        return self._retry(self.fs.modified, _strip(path)).timestamp()


def _strip(path: str) -> str:
    return path[5:] if path.startswith("gs://") else path


_POSIX = PosixBackend()
_GCS = None


def get_backend(path: str):
    """Resolve a path to its storage backend (prefix switch, done once)."""
    global _GCS
    if str(path).startswith("gs://"):
        if _GCS is None:
            _GCS = GCSBackend()
        return _GCS
    return _POSIX


def set_gcs_filesystem(fs, retries: int = 3, backoff: float = 0.5):
    """Install the filesystem behind gs:// paths (None resets to the
    default gcsfs-on-first-use).  Tests/local dev pass a
    :class:`blackbox_tpu_torch.io.fakegcs.FakeGCSFileSystem`."""
    global _GCS
    _GCS = None if fs is None else GCSBackend(fs, retries=retries,
                                              backoff=backoff)


# ---- convenience wrappers used across the framework ----

ZIP_VARIANTS = ("", ".fz", ".gz")


def already_exists(path: str, get_filename: bool = False):
    """Existence check tolerant of .fz/.gz variants (blackbox.py:787-807)."""
    base = str(path)
    for v in ZIP_VARIANTS:
        for cand in ({base + v} | ({base[:-len(v)]} if v and
                                   base.endswith(v) else set())):
            be = get_backend(cand)
            if be.isfile(cand):
                return (True, cand) if get_filename else True
    return (False, None) if get_filename else False


def list_files(prefix_or_pattern: str, search_str: str = "",
               end_str: str = "") -> list:
    """zogy-style listing: prefix + optional substring/suffix filters."""
    be = get_backend(prefix_or_pattern)
    pat = prefix_or_pattern
    if not any(ch in pat for ch in "*?["):
        pat = pat + "*"
    out = be.list_files(pat)
    if search_str:
        out = [p for p in out if search_str in os.path.basename(p)]
    if end_str:
        out = [p for p in out if p.endswith(end_str)]
    return out


def copy_files(files: Iterable[str], dest_dir: str):
    be = get_backend(dest_dir)
    be.make_dir(dest_dir)
    out = []
    for f in files:
        dst = os.path.join(dest_dir, os.path.basename(f))
        copy_file(f, dst)
        out.append(dst)
    return out


def copy_file(src: str, dst: str):
    """Copy across backends (upload/download when schemes differ)."""
    b_src, b_dst = get_backend(src), get_backend(dst)
    if b_src is b_dst:
        b_src.copy(src, dst)
    else:
        b_dst.write_bytes(dst, b_src.read_bytes(src))
