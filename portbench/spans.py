"""The benchmark's own tracing: spans around calls into the program's
layers, the kernel wrappers' calls, and the device trace.

Spans wrap a program function where a pipeline module looks it up (the
module attribute the caller reads at call time).  In ``timed`` mode a
span synchronises the device at both ends and times the call with CUDA
events (the host clock on a CPU); in ``annotated`` mode it only names
the call for the profiler.  Kernel hooks replace a launch-counted
wrapper in every module of the program that binds it, and keep what
its roofline file needs from each call's arguments and result.

:func:`profile` runs frames under ``torch.profiler`` and reads the
exported trace: the device's busy intervals (kernels, copies and
memsets, merged), the idle gaps between them with what the host was
doing, and each kernel's device seconds.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import functools
import importlib
import inspect
import json
import os
import re
import sys
import tempfile
import time

import torch

SPAN = "portbench.span."
KERNEL = "portbench.kernel."
FRAME = "portbench.frame"


class Spans:
    """Named spans, each over one or more (module, function) sites; a
    module is named by its path inside the program's package."""

    def __init__(self, specs: dict, program: str, device):
        self.specs = specs          # name -> ((module, attr), ...)
        self.program = program
        self.cuda = torch.device(device).type == "cuda"
        self.events = collections.defaultdict(list)
        self.host_ms = collections.defaultdict(float)
        self.calls = collections.Counter()
        self._saved = []

    def _timed(self, name, fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            self.calls[name] += 1
            if not self.cuda:
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.host_ms[name] += (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                return fn(*args, **kwargs)
            finally:
                end.record()
                torch.cuda.synchronize()
                self.events[name].append((start, end))
        return run

    @staticmethod
    def _annotated(name, fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with torch.profiler.record_function(SPAN + name):
                return fn(*args, **kwargs)
        return run

    def install(self, mode: str) -> None:
        wrap = self._timed if mode == "timed" else self._annotated
        for name, sites in self.specs.items():
            for mod_name, attr in sites:
                mod = importlib.import_module(f"{self.program}.{mod_name}")
                fn = getattr(mod, attr)
                self._saved.append((mod, attr, fn))
                setattr(mod, attr, wrap(name, fn))

    def remove(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def total_ms(self) -> dict:
        out = dict(self.host_ms)
        for name, pairs in self.events.items():
            out[name] = sum(s.elapsed_time(e) for s, e in pairs)
        return out


class KernelHooks:
    """Every call of each roofline file's wrapper, with its record."""

    def __init__(self, rooflines: list, program: str):
        self.rooflines = rooflines
        self.program = program
        self.records = []           # (roofline module, record)
        self._saved = []

    def install(self) -> None:
        for roof in self.rooflines:
            mod_name, attr = roof.WRAPPER
            fn = getattr(importlib.import_module(
                f"{self.program}.{mod_name}"), attr)
            hook = self._hook(roof, fn)
            for mod in list(sys.modules.values()):
                if (getattr(mod, "__name__", "").startswith(
                        self.program + ".")
                        and getattr(mod, attr, None) is fn):
                    self._saved.append((mod, attr, fn))
                    setattr(mod, attr, hook)

    def _hook(self, roof, fn):
        sig = inspect.signature(fn)
        label = KERNEL + roof.__name__.rsplit("_", 1)[-1]

        @functools.wraps(fn)
        def run(*args, **kwargs):
            with torch.profiler.record_function(label):
                out = fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            self.records.append((roof, roof.record(bound.arguments, out)))
            return out
        return run

    def remove(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()


def kernel_base(name: str) -> str:
    """A device kernel's name without return type, anonymous namespace,
    template arguments or parameter list (``void (anonymous
    namespace)::median_kernel<7>(float const*, ...)`` ->
    ``median_kernel``; a named namespace stays)."""
    name = name.replace("(anonymous namespace)::", "")
    while "<" in name and re.search(r"<[^<>]*>", name):
        name = re.sub(r"<[^<>]*>", "", name)
    name = name.split("(")[0].strip()
    return name.split()[-1] if name else name


@dataclasses.dataclass
class DeviceTrace:
    """What the profiler saw over the profiled frames."""
    window_s: float                 # first frame's start to last's end
    busy_s: float                   # union of device intervals in it
    kernel_s: dict                  # bare kernel name -> device seconds
    op_s: dict                      # device operation name -> seconds
    gap_s: dict                     # host activity -> idle seconds


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
              "python_function")


def read_trace(events: list) -> DeviceTrace | None:
    """Reduce a chrome trace's events; None without profiled frames."""
    frames = [e for e in events if e.get("ph") == "X"
              and e.get("name") == FRAME
              and e.get("cat", "").lower() == "user_annotation"]
    if not frames:
        return None
    tid = frames[0].get("tid")
    t0 = min(e["ts"] for e in frames)
    t1 = max(e["ts"] + e["dur"] for e in frames)
    dev, host = [], []
    kernel_s = collections.defaultdict(float)
    op_s = collections.defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "").lower()
        if cat in _DEVICE_CATS:
            a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
            if b <= a:
                continue
            dev.append((a, b))
            name = e.get("name", cat)
            if cat == "kernel":
                name = kernel_base(name)
                kernel_s[name] += (b - a) * 1e-6
            op_s[name] += (b - a) * 1e-6
        elif cat in _HOST_CATS and e.get("tid") == tid:
            host.append((e["ts"], e["ts"] + e["dur"], e.get("name", cat),
                         cat == "user_annotation"))
    dev.sort()
    busy, gaps = 0.0, []
    cur = t0
    for a, b in dev:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if t1 > cur:
        gaps.append((cur, t1))
    host.sort()
    starts = [h[0] for h in host]
    annotations = [h for h in host if h[3]]
    gap_s = collections.defaultdict(float)
    for a, b in gaps:
        gap_s[_doing(a, host, starts, annotations)] += (b - a) * 1e-6
    return DeviceTrace((t1 - t0) * 1e-6, busy * 1e-6,
                       dict(kernel_s), dict(op_s), dict(gap_s))


def _doing(t: float, host, starts, annotations) -> str:
    """What the host thread was in at time ``t``: the innermost span of
    the benchmark's, and the innermost operation."""
    span = "between frames"
    for a, b, name, _ in annotations:
        if a <= t < b and name != FRAME:
            span = name.replace(SPAN, "").replace(KERNEL, "kernel ")
        elif a <= t < b and span == "between frames":
            span = "frame"
    inner = None
    i = bisect.bisect_right(starts, t)
    for a, b, name, is_span in reversed(host[max(0, i - 64):i]):
        if a <= t < b and not is_span:
            inner = name
            break
    return span if inner is None else f"{span}: {inner}"


def profile(run_frames, device) -> DeviceTrace | None:
    """Run ``run_frames()`` under the profiler; read its trace."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        run_frames()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return read_trace(events)


@dataclasses.dataclass
class Trace:
    """What a traced run hands the per-layer metrics' readers."""
    frames: int                     # frames in the spans' window
    span_ms: dict                   # span name -> total ms
    span_calls: dict                # span name -> calls
    records: list                   # (roofline module, record)
    device: DeviceTrace | None

    def span_mean_ms(self, name: str):
        """A span's mean ms a frame, or None if it never ran."""
        if not self.span_calls.get(name) or not self.frames:
            return None
        return self.span_ms[name] / self.frames
