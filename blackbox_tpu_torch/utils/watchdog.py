"""Host watchdog for hung device programs (SURVEY.md §5.3).

A tunneled/remote TPU call can hang indefinitely (backend restart, ICI
fault); the reference's per-step try/except cannot catch a call that
never returns.  ``run_with_watchdog`` executes the callable in a worker
thread and gives up after a deadline — the frame is then red-flagged by
the normal step-containment path instead of wedging the whole night.
"""

from __future__ import annotations

import concurrent.futures
import logging

log = logging.getLogger("blackbox_tpu")


class DeviceHang(TimeoutError):
    pass


def run_with_watchdog(fn, *args, timeout_s: float = 600.0, label: str = "",
                      **kwargs):
    """Run ``fn(*args, **kwargs)``, raising :class:`DeviceHang` after
    ``timeout_s``.

    The worker thread cannot be force-killed (Python semantics); on
    timeout it is abandoned — acceptable for a process that will be
    torn down by the orchestrator's retry logic, which is exactly the
    reference's SLURM-level containment model.
    """
    ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        fut = ex.submit(fn, *args, **kwargs)
        try:
            return fut.result(timeout=timeout_s)
        except concurrent.futures.TimeoutError:
            log.error("device watchdog expired after %.0fs in %s",
                      timeout_s, label or getattr(fn, "__name__", "?"))
            fut.cancel()
            raise DeviceHang(
                f"{label or fn}: no result within {timeout_s:.0f}s")
    finally:
        # never wait=True: joining a truly hung worker would wedge the
        # watchdog itself — the thread is left detached for the process
        # teardown to reap
        ex.shutdown(wait=False)
