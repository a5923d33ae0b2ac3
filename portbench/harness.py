"""One run of one cell: set-up, the measured window, the traced phases
and the comparison that decides ``correct``.

The run is a closed loop with one frame in flight, as a night's frames
go through one process: each frame is the entry's call on the next raw
frame of a pool made in set-up, and ends in ``torch.cuda.synchronize()``.
Nothing here knows a cell: the configuration, the traffic mix, the
limits, the entry and the metrics come from the files that
:mod:`portbench.manifest` finds by the names in ``BENCHMARK.json``.

The run logs the garbage collector's time, the main thread's CPU
seconds and context switches in the window, and each pool frame's
median latency: where a cell's frame rate spreads, they say whether
the host or the frames' content moved it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import random
import resource
import statistics
import subprocess
import sys
import time

import torch

from portbench import compare, manifest, spans
from portbench.package import PROGRAM, REFERENCE, Package

FORBIDDEN = ("jax", "jaxlib", "flax", "blackbox_tpu")

POOL = 16               # raw frames made in set-up and cycled
WARMUP_FRAMES = 3       # entry calls in set-up, on the pool's first frames
PROFILED_FRAMES = 3     # frames under the profiler after a traced window
CHECKED_FRAMES = 1      # window frames, drawn from the seed, compared


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--id=0",
                              "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or out.stderr.strip()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Window:
    """What an end-to-end metric's reader reads."""
    latency_s: list             # every window frame's, in order
    window_s: float             # first frame's start to last one's end
    setup_s: float              # process start to the first timed frame


class _HostWatch:
    """The garbage collector's time and the main thread's CPU seconds
    and context switches between :meth:`start` and :meth:`stop`."""

    def __init__(self):
        self.gc_s = collections.Counter()
        self.gc_n = collections.Counter()
        self._t = None

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s[info["generation"]] += time.perf_counter() - self._t
            self.gc_n[info["generation"]] += 1
            self._t = None

    def start(self):
        self._r0 = resource.getrusage(resource.RUSAGE_THREAD)
        gc.callbacks.append(self._on_gc)

    def stop(self) -> str:
        gc.callbacks.remove(self._on_gc)
        r0, r1 = self._r0, resource.getrusage(resource.RUSAGE_THREAD)
        cpu = (r1.ru_utime + r1.ru_stime) - (r0.ru_utime + r0.ru_stime)
        gcs = ", ".join(f"gen{g} {self.gc_n[g]} x {self.gc_s[g] * 1e3:.1f} ms"
                        for g in sorted(self.gc_n)) or "none"
        return (f"main thread {cpu:.3f} s CPU, "
                f"{r1.ru_nivcsw - r0.ru_nivcsw} involuntary and "
                f"{r1.ru_nvcsw - r0.ru_nvcsw} voluntary switches; "
                f"collections: {gcs}")


def _per_frame(indices: list, latency: list) -> str:
    """Each pool frame's median ms over its calls in the window."""
    by = collections.defaultdict(list)
    for i, t in zip(indices, latency):
        by[i].append(t * 1e3)
    return " ".join(f"{i}:{statistics.median(by[i]):.1f}x{len(by[i])}"
                    for i in sorted(by))


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device="cuda", cell: manifest.Cell | None = None,
        program: str = PROGRAM, program_context=None, pool: int = POOL,
        warmup: int = WARMUP_FRAMES, profiled: int = PROFILED_FRAMES,
        checked: int = CHECKED_FRAMES) -> dict:
    """Run ``workload`` once and return its result line as a dict.

    ``cell`` replaces the files' cell and the counts the harness's
    (tests run a smaller one), ``program`` the package under test, and
    ``program_context`` (a context manager factory taking the program's
    Package) wraps its set-up and window: the control and the planted
    faults.
    """
    cell = cell or manifest.cell(workload)
    traffic, config = cell.traffic, cell.config
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        _log(f"card: {card_label()}")

    # ---- set-up: inputs from the seed, the program, its warm-up ----
    inputs = cell.entry.inputs(config, traffic, seed, device, pool)
    _sync(device)
    prog = Package(program)
    ctx = (program_context(prog) if program_context
           else contextlib.nullcontext())
    frames = inputs.pool
    with ctx:
        entry = cell.entry.Entry(prog, config, traffic, inputs, device)
        for i in range(warmup):
            entry(frames[i % len(frames)])
            _sync(device)
        gc.collect()
        setup_s = time.perf_counter() - t_start
        _log(f"set-up {setup_s:.3f} s ({len(frames)} frames in the pool, "
             f"{warmup} warm-up frames)")

        # ---- the window: back to back, one frame in flight ----
        timed = None
        if trace:
            timed = spans.Spans(_span_specs(cell), program, device)
            timed.install("timed")
        pick = random.Random(seed)
        kept = []                       # (pool index, outputs)
        latency, indices = [], []
        k = warmup
        host = _HostWatch()
        host.start()
        t0 = time.perf_counter()
        t_end = t0
        while t_end - t0 < seconds:
            idx = k % len(frames)
            t_frame = time.perf_counter()
            out = entry(frames[idx])
            _sync(device)
            t_end = time.perf_counter()
            latency.append(t_end - t_frame)
            indices.append(idx)
            n = len(latency)
            if n <= checked:            # a uniform sample of the frames
                kept.append((idx, out))
            elif pick.random() < checked / n:
                kept[pick.randrange(checked)] = (idx, out)
            del out
            k += 1
        window = Window(latency, t_end - t0, setup_s)
        _log(f"host in the window: {host.stop()}")
        peak = (torch.cuda.max_memory_allocated(device) if is_cuda
                else 0)
        lat = sorted(x * 1e3 for x in latency)
        _log(f"window {window.window_s:.3f} s, {len(lat)} frames; frame ms "
             f"min {lat[0]:.1f}, median {statistics.median(lat):.1f}, max "
             f"{lat[-1]:.1f}; peak memory {peak / 2 ** 30:.2f} GiB")
        _log(f"pool frame:median ms x calls: {_per_frame(indices, latency)}")

        layer, breakdown, dev_trace = {}, None, None
        if trace:
            timed.remove()
            hooks = spans.KernelHooks(manifest.rooflines(), program)
            notes = spans.Spans(_span_specs(cell), program, device)

            def profiled_frames():
                for j in range(profiled):
                    with torch.profiler.record_function(spans.FRAME):
                        entry(frames[(k + j) % len(frames)])
                        _sync(device)

            notes.install("annotated")
            hooks.install()
            try:
                dev_trace = spans.profile(profiled_frames, device)
            finally:
                hooks.remove()
                notes.remove()
            tr = spans.Trace(len(latency), timed.total_ms(),
                             dict(timed.calls), hooks.records, dev_trace)
            for m, reader in cell.per_layer:
                value = reader.read(tr)
                if value is not None:
                    layer[m["name"]] = {"value": value, "unit": m["unit"]}
            if dev_trace is not None and dev_trace.busy_s > 0:
                breakdown = _breakdown(dev_trace)
        del entry
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()

    # ---- the reference on the kept frames' own inputs ----
    t_ref = time.perf_counter()
    ref_entry = cell.entry.Entry(Package(REFERENCE), config, traffic, inputs,
                                 device)
    numbers = getattr(cell.entry, "numbers", compare.numbers)
    readings = []
    for idx, out in kept:
        want = ref_entry(frames[idx])
        readings.append(numbers(out, want))
        del want
    correct, worst = compare.verdict(readings, cell.limits)
    _sync(device)
    _log(f"reference {time.perf_counter() - t_ref:.3f} s on frame(s) "
         f"{[idx for idx, _ in kept]} of the pool")

    if trace:
        metrics = layer
    else:
        metrics = {}
        for m, reader in cell.end_to_end:
            value = reader.read(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(latency), "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if is_cuda else "cpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if is_cuda else "cpu"),
                         "count": int(cell.workload["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"]["busy_s"] = dev_trace.busy_s if dev_trace else 0.0
        result["device"]["window_s"] = (dev_trace.window_s if dev_trace
                                        else 0.0)
        if breakdown is not None:
            result["breakdown"] = breakdown
    result["checks"] = {k: {"value": worst[k], "limit": cell.limits[k]}
                        for k in sorted(cell.limits)}
    return result


def _span_specs(cell: manifest.Cell) -> dict:
    specs = {}
    for _, reader in cell.per_layer:
        specs.update(getattr(reader, "SPANS", {}))
    return specs


def _breakdown(dt: spans.DeviceTrace) -> dict:
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]
    return {"device_ops": top(dt.op_s), "idle_gaps": top(dt.gap_s)}
