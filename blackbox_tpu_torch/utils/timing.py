"""Opt-in wall-time + memory tracing (SURVEY.md §5.1).

The reference brackets nearly every function with ``log_timing_memory``
wall/RSS lines and ``mem_use`` RSS snapshots behind ``set_zogy.timing``
(reference blackbox.py:201-202, 4638, 5243-5245).  Same label-based log
format here, plus device-side equivalents: the CUDA allocator's memory
statistics and a ``torch.profiler`` trace context for deep dives
(port of :mod:`blackbox_tpu.utils.timing`).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

log = logging.getLogger("blackbox_tpu")

# master switch (reference: set_zogy.timing); env override for ops
TIMING = os.environ.get("BLACKBOX_TPU_TIMING", "0") not in ("0", "",
                                                            "false")


def _rss_gb() -> float:
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1024 ** 3
    except Exception:
        return float("nan")


def mem_use(label: str = "") -> float:
    """RSS snapshot in GB, logged with the label (reference mem_use)."""
    gb = _rss_gb()
    if TIMING:
        log.info("memory use [GB]: rss=%.3f in %s", gb, label)
    return gb


def log_timing_memory(t0: float, label: str = "") -> float:
    """Wall time since t0 + RSS, reference log format
    ('wall-time spent in ...')."""
    dt = time.time() - t0
    if TIMING:
        log.info("wall-time spent in %s: %.3f s; rss=%.3f GB",
                 label, dt, _rss_gb())
    return dt


def device_memory_stats(device=None) -> dict:
    """Memory of a CUDA device from PyTorch's allocator: bytes in use,
    the peak since the last ``torch.cuda.reset_peak_memory_stats`` and
    the card's total (empty dict without a CUDA device)."""
    import torch
    if not torch.cuda.is_available():
        return {}
    d = torch.device(device or "cuda")
    stats = torch.cuda.memory_stats(d)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(d)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                d).total_memory)}


@contextlib.contextmanager
def timer(label: str, sync=None, spans: dict | None = None):
    """Context timer: ``with timer('overscan', sync=t): ...``

    ``sync`` — a tensor (or a device) whose CUDA device is synchronised
    before the clock stops (kernels run asynchronously; without a sync
    the timer measures the launches only).  ``spans``, when given,
    accumulates the span's seconds under ``label``.
    """
    t0 = time.time()
    try:
        yield
    finally:
        if sync is not None:
            import torch
            dev = sync.device if isinstance(sync, torch.Tensor) else \
                torch.device(sync)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        dt = log_timing_memory(t0, label)
        if spans is not None:
            spans[label] = spans.get(label, 0.0) + dt


@contextlib.contextmanager
def profile_trace(logdir: str):
    """torch.profiler trace context (a Chrome trace in ``logdir``)."""
    from torch.profiler import ProfilerActivity, profile
    import torch
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
