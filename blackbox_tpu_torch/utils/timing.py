"""Opt-in wall-time + memory tracing (SURVEY.md §5.1), and the port's
spans and counters.

The reference brackets nearly every function with ``log_timing_memory``
wall/RSS lines and ``mem_use`` RSS snapshots behind ``set_zogy.timing``
(reference blackbox.py:201-202, 4638, 5243-5245).  Same label-based log
format here, plus device-side equivalents: the CUDA allocator's memory
statistics and a ``torch.profiler`` trace context for deep dives
(port of :mod:`blackbox_tpu.utils.timing`).

Spans and counters (the port's own): the pipeline's stages open
:func:`span` and its host reads call :func:`count`.  Both do nothing
unless a :func:`recording` block is open, in which each span keeps its
name, parent, frame, host interval, attributes and a pair of CUDA
events recorded on the current stream (no synchronise), and enters
``torch.profiler.record_function`` under its name, so a profiler trace
shows the program's stages on the device's clock.
:meth:`Recorder.drain` synchronises once and resolves the events.
:func:`timer` is a span too.
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
    accumulates the span's seconds under ``label``.  Inside
    :func:`recording` the block is also a :func:`span` named ``label``.
    """
    t0 = time.time()
    try:
        with span(label):
            try:
                yield
            finally:
                if sync is not None:
                    import torch
                    dev = sync.device if isinstance(sync, torch.Tensor) \
                        else torch.device(sync)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
    finally:
        dt = log_timing_memory(t0, label)
        if spans is not None:
            spans[label] = spans.get(label, 0.0) + dt


class _NullSpan:
    """What :func:`span` returns while nothing records: one shared
    object that enters, exits and takes attributes doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


class Span:
    """One recorded span: ``name``; ``id``, ``parent`` (the id of the
    span it opened in, or None) and ``frame`` (the id of its root span:
    the spans of one frame share it); host ``start_ns`` and ``end_ns``
    (``time.perf_counter_ns``); ``attrs`` (host values); and, once
    drained, ``device_ms``."""

    __slots__ = ("name", "id", "parent", "frame", "attrs", "start_ns",
                 "end_ns", "device_ms", "_rec", "_join", "_events",
                 "_annotation")

    def __init__(self, rec, name: str, join, attrs: dict):
        self._rec, self.name, self._join, self.attrs = rec, name, join, attrs
        self.parent = self.frame = self.end_ns = self.device_ms = None
        self._events = None

    def set(self, **attrs):
        """Add attributes (host values) to the span."""
        self.attrs.update(attrs)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def __enter__(self):
        import torch
        rec = self._rec
        stack = rec._stack()
        self.id = rec._next_id
        rec._next_id += 1
        if stack:
            self.parent = stack[-1].id
            self.frame = stack[-1].frame
        else:
            self.frame = rec._roots.get(self._join, self.id)
            rec._roots[self.name] = self.frame
        stack.append(self)
        rec._open.append(self)
        self._annotation = torch.profiler.record_function(self.name)
        self._annotation.__enter__()
        if rec.cuda:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record()
        self._annotation.__exit__(None, None, None)
        self._annotation = None
        self._rec._stack().pop()
        return False


class Recorder:
    """The spans and counters recorded inside one :func:`recording`
    block.  ``cuda``: whether spans record CUDA events; without them a
    span's device time is its host interval (eager work on the CPU runs
    on the calling thread)."""

    active = None           # the open recording's Recorder, else None
    null = _NullSpan()      # what span() returns outside a recording

    def __init__(self, cuda: bool):
        # imported here: the module's top level stays the JAX package's
        # (tests/test_torch_import.py holds it to it)
        import collections
        import threading
        self.cuda = cuda
        self.counters = collections.Counter()
        self._open = []             # spans entered and not yet drained
        self._next_id = 0
        self._roots = {}            # root span name -> its latest frame
        self._local = threading.local()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def drain(self):
        """Synchronise once, resolve every closed span's device time,
        and hand over the closed spans (in the order they opened) and
        the counters, forgetting both.  Returns (spans, counters)."""
        done = [s for s in self._open if s.end_ns is not None]
        self._open = [s for s in self._open if s.end_ns is None]
        if any(s._events is not None for s in done):
            import torch
            torch.cuda.synchronize()
        for s in done:
            if s._events is None:
                s.device_ms = s.host_ms
            else:
                s.device_ms = s._events[0].elapsed_time(s._events[1])
                s._events = None
        counters, self.counters = dict(self.counters), type(self.counters)()
        return done, counters


def span(name: str, join: str | None = None, **attrs):
    """A span named ``name`` over the ``with`` block, with attributes
    ``attrs`` (more through the yielded span's ``set``).  A root span
    (none open on this thread) starts a frame; with ``join`` it takes
    the frame of the latest root span of that name instead.  Outside
    :func:`recording` it is a shared null context: no event, no
    profiler annotation, no allocation."""
    rec = Recorder.active
    if rec is None:
        return Recorder.null
    return Span(rec, name, join, attrs)


def annotate(name: str, **attrs) -> None:
    """Add ``attrs`` to the innermost span open on this thread if it is
    named ``name`` (for a function that learns what its caller's span
    should say); no-op otherwise and outside :func:`recording`."""
    rec = Recorder.active
    if rec is not None:
        stack = rec._stack()
        if stack and stack[-1].name == name:
            stack[-1].set(**attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` inside :func:`recording`; no-op
    outside it."""
    rec = Recorder.active
    if rec is not None:
        rec.counters[name] += n


@contextlib.contextmanager
def recording(cuda: bool | None = None):
    """Record spans and counters inside the block; yields the
    :class:`Recorder`.  ``cuda`` (default: whether PyTorch sees a CUDA
    device) makes spans record CUDA events.  Blocks nest: the inner one
    records alone until it closes."""
    if cuda is None:
        import torch
        cuda = torch.cuda.is_available()
    rec = Recorder(cuda)
    prev, Recorder.active = Recorder.active, rec
    try:
        yield rec
    finally:
        Recorder.active = prev


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
