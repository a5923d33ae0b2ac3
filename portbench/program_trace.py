#!/usr/bin/env python3
"""The program's own spans and counters in one cell, on the card: the
numbers that per-layer metrics of the program's spans would read.

    python3 portbench/program_trace.py --workload <cell> --seed <n> \
        [--frames 16] [--sync-debug] [--onoff <seconds>]

Not part of a benchmark run: ``harness.py`` does not run these phases
(PERF.md §7 names the change that would).  After the harness's set-up
(the cell's inputs from the seed, the entry, three warm-up frames), on
the pool's frames in order, one frame in flight:

1. ``--frames`` frames under the benchmark's own timed spans
   (``spans.Spans``, synchronised at both ends): the five ``*.ms``
   metrics as a traced run reads them;
2. (a) the same frames under ``utils.timing.recording()`` and nothing
   else: each span's device ms a frame (its CUDA events), L.A.Cosmic's
   pass attributes and ``host.reads`` a frame (:func:`read_program`);
3. (b) three frames under ``recording()`` and ``torch.profiler``: the
   device's idle time a frame while the host was inside ``calibration``
   or ``lacosmic`` (:func:`idle_within`), and the idle gaps by the
   innermost program span the host was in;
4. with ``--sync-debug``: one frame under ``recording()`` and
   ``torch.cuda.set_sync_debug_mode("warn")``: every synchronising
   call by program line, against ``host.reads``;
5. with ``--onoff S``: frames/s over S seconds with recording off, on,
   on and off, and one frame's outputs with recording off and on
   compared bit for bit.

Standard error carries a line for each phase (the twins' gaps among
them); the last line of standard output is one JSON object.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from portbench import harness, manifest, spans  # noqa: E402
from portbench.package import PROGRAM, Package  # noqa: E402

# metric name -> the program span whose device ms a frame it reads
DEVICE_MS = {
    "calibration.device_ms": "calibration",
    "lacosmic.device_ms": "lacosmic",
    "catalog.device_ms": "catalog",
    "warp.device_ms": "warp",
    "zogy.device_ms": "zogy",
    "mask.device_ms": "calibration.mask",
    "fill_holes.device_ms": "fill_holes",
    "zogy.fft.device_ms": "zogy.fft",
}
# the program's twin of each benchmark span metric
TWINS = {"calibration.device_ms": "calibration.ms",
         "lacosmic.device_ms": "lacosmic.ms",
         "catalog.device_ms": "catalog.ms",
         "warp.device_ms": "warp.ms",
         "zogy.device_ms": "zogy.ms"}
# metric name -> the program span inside which the device's idle counts
IDLE_MS = {"calibration.idle_ms": "calibration",
           "lacosmic.idle_ms": "lacosmic"}
PROFILED = 3


def _timing():
    import importlib
    return importlib.import_module(f"{PROGRAM}.utils.timing")


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def read_program(span_list, counters: dict, frames: int) -> dict:
    """The values of a recording over ``frames`` frames: each
    ``DEVICE_MS`` span's device ms summed over its spans and divided by
    the frames, ``lacosmic.active_cells`` (Σ nact of the ``lacosmic.pass``
    spans a frame), ``lacosmic.window_yield_pct`` (100 Σ changed / Σ
    windows) and ``host.reads_per_frame``.  A span that never ran, or
    a ratio over nothing, gives no value."""
    ms = collections.defaultdict(float)
    for s in span_list:
        ms[s.name] += s.device_ms
    out = {m: ms[name] / frames for m, name in DEVICE_MS.items()
           if name in ms}
    passes = [s.attrs for s in span_list if s.name == "lacosmic.pass"]
    if passes:
        out["lacosmic.active_cells"] = sum(a["nact"] for a in passes) / frames
        windows = sum(a["windows"] for a in passes)
        if windows:
            out["lacosmic.window_yield_pct"] = (
                100.0 * sum(a["changed"] for a in passes) / windows)
    if "host.reads" in counters:
        out["host.reads_per_frame"] = counters["host.reads"] / frames
    return out


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_within(events: list, name: str):
    """Seconds in which the device ran nothing while the host thread
    was inside a span ``name`` (at any depth), over the profiled frames
    (``spans.FRAME`` annotations) of a chrome trace; None without
    profiled frames, device activity or such a span."""
    frames = [e for e in events if e.get("ph") == "X"
              and e.get("name") == spans.FRAME
              and e.get("cat", "").lower() == "user_annotation"]
    if not frames:
        return None
    tid = frames[0].get("tid")
    t0 = min(e["ts"] for e in frames)
    t1 = max(e["ts"] + e["dur"] for e in frames)
    dev, inside = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b <= a:
            continue
        cat = e.get("cat", "").lower()
        if cat in spans._DEVICE_CATS:
            dev.append((a, b))
        elif (cat == "user_annotation" and e.get("name") == name
              and e.get("tid") == tid):
            inside.append((a, b))
    if not dev or not inside:
        return None
    busy = _union(dev)
    idle = 0.0
    for a, b in _union(inside):
        covered = sum(max(0.0, min(b, d1) - max(a, d0)) for d0, d1 in busy)
        idle += (b - a) - covered
    return idle * 1e-6


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _frames(entry, pool, start, n, device):
    for j in range(n):
        entry(pool[(start + j) % len(pool)])
        _sync(device)


def _profiled_events(entry, pool, start, device) -> list:
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for j in range(PROFILED):
            with torch.profiler.record_function(spans.FRAME):
                entry(pool[(start + j) % len(pool)])
                _sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def _program_site() -> str:
    """The innermost line of the program on the stack, else the
    innermost line outside this file and the warnings module."""
    stack = traceback.extract_stack()[:-1]
    mine = (__file__, warnings.__file__)
    for fr in reversed(stack):
        if f"{PROGRAM}/" in fr.filename:
            return (f"{fr.filename.rsplit('/', 2)[-2]}/"
                    f"{fr.filename.rsplit('/', 1)[-1]}:{fr.lineno}")
    for fr in reversed(stack):
        if fr.filename not in mine:
            return f"{fr.filename}:{fr.lineno} {fr.name}"
    return "?"


def sync_debug(entry, frame, device):
    """One frame under recording and the CUDA sync debug mode "warn":
    (synchronising calls by program line, host.reads)."""
    T = _timing()
    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            sites[_program_site()] += 1

    with T.recording() as rec:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = entry(frame)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        del out
        _sync(device)
    _, counters = rec.drain()
    return dict(sites), counters.get("host.reads", 0)


def _rate(entry, pool, start, seconds, device, record: bool):
    T = _timing()
    n, k = 0, start
    with T.recording() if record else contextlib.nullcontext() as rec:
        t0 = time.perf_counter()
        t_end = t0
        while t_end - t0 < seconds:
            entry(pool[k % len(pool)])
            _sync(device)
            t_end = time.perf_counter()
            n += 1
            k += 1
        if rec is not None:
            rec.drain()
    return n / (t_end - t0), n


def _same(a, b) -> bool:
    """Two entry outputs equal bit for bit (NaN where NaN)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and bool(
            ((a == b) | (a != a) & (b != b)).all())
    return a == b


def run(workload: str, seed: int, frames: int, *, device="cuda",
        cell=None, pool: int = harness.POOL,
        warmup: int = harness.WARMUP_FRAMES, sync: bool = False,
        onoff: float = 0.0) -> dict:
    """The phases above; returns the result line as a dict."""
    T = _timing()
    cell = cell or manifest.cell(workload)
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        _log(f"card: {harness.card_label()}")
    inputs = cell.entry.inputs(cell.config, cell.traffic, seed, device, pool)
    entry = cell.entry.Entry(Package(PROGRAM), cell.config, cell.traffic,
                             inputs, device)
    P = inputs.pool
    _frames(entry, P, 0, warmup, device)
    _log(f"set-up {time.perf_counter() - T_START:.3f} s")
    k = warmup

    # 1. the benchmark's timed spans, as a traced run takes them
    timed = spans.Spans(harness._span_specs(cell), PROGRAM, device)
    timed.install("timed")
    try:
        _frames(entry, P, k, frames, device)
    finally:
        timed.remove()
    outside = {m["name"]: reader.read(spans.Trace(
        frames, timed.total_ms(), dict(timed.calls), [], None))
        for m, reader in cell.per_layer if hasattr(reader, "SPANS")}

    # 2. (a) the program's spans and counters alone
    with T.recording(cuda=is_cuda) as rec:
        t0 = time.perf_counter()
        _frames(entry, P, k, frames, device)
        t_a = time.perf_counter() - t0
        span_list, counters = rec.drain()
    values = read_program(span_list, counters, frames)
    _log(f"(a) {frames} frames in {t_a:.3f} s under recording: "
         + ", ".join(f"{n} {v:.4f}" for n, v in values.items()))
    twins = {}
    for inner, outer in TWINS.items():
        if values.get(inner) is not None and outside.get(outer):
            twins[inner] = 100.0 * (values[inner] / outside[outer] - 1.0)
            _log(f"twin {inner} {values[inner]:.3f} against {outer} "
                 f"{outside[outer]:.3f}: {twins[inner]:+.2f} %")
    by_name = collections.defaultdict(lambda: [0, 0.0, 0.0])
    for s in span_list:
        r = by_name[s.name]
        r[0] += 1
        r[1] += s.device_ms
        r[2] += s.host_ms
    table = {n: [c / frames, d / frames, h / frames]
             for n, (c, d, h) in by_name.items()}
    for n, (c, d, h) in table.items():
        _log(f"span {n}: {c:.2f} a frame, device {d:.3f} ms, host "
             f"{h:.3f} ms a frame")
    passes = [s.attrs for s in span_list if s.name == "lacosmic.pass"]
    _log(f"lacosmic.pass attributes, first frame's: "
         f"{passes[:len(passes) // max(frames, 1)]}")

    # 3. (b) recording and the profiler
    with T.recording(cuda=is_cuda) as rec:
        events = _profiled_events(entry, P, k, device)
        rec.drain()
    for m, name in IDLE_MS.items():
        s = idle_within(events, name)
        if s is not None:
            values[m] = s * 1e3 / PROFILED
    dt = spans.read_trace(events)
    gaps = []
    if dt is not None and dt.busy_s > 0:
        gaps = [[g, s] for g, s in sorted(dt.gap_s.items(),
                                          key=lambda kv: -kv[1])[:12]]
        _log(f"(b) busy {dt.busy_s:.4f} s of {dt.window_s:.4f} s; "
             + ", ".join(f"{m} {values[m]:.3f}" for m in IDLE_MS
                         if m in values))
        for g, s in gaps:
            _log(f"idle gap {g}: {s * 1e3:.3f} ms over {PROFILED} frames")

    result = {"workload": workload, "seed": seed, "frames": frames,
              "values": values, "outside": outside, "twins_pct": twins,
              "spans": table, "idle_gaps": gaps,
              "device": (torch.cuda.get_device_name(device) if is_cuda
                         else "cpu")}

    # 4. the synchronising calls of one frame
    if sync and is_cuda:
        sites, reads = sync_debug(entry, P[k % len(P)], device)
        result["sync_debug"] = {"calls": sum(sites.values()),
                                "host_reads": reads, "sites": sites}
        _log(f"sync debug: {sum(sites.values())} synchronising calls, "
             f"host.reads {reads}")
        for site, n in sorted(sites.items()):
            _log(f"  {n} {site}")

    # 5. the recorder's cost, and its outputs
    if onoff > 0:
        a = entry(P[k % len(P)])
        _sync(device)
        with T.recording(cuda=is_cuda) as rec:
            b = entry(P[k % len(P)])
            _sync(device)
            rec.drain()
        result["bit_identical"] = _same(a, b)
        del a, b
        rates = []
        for record in (False, True, True, False):
            fps, n = _rate(entry, P, k, onoff, device, record)
            rates.append(["on" if record else "off", fps, n])
            _log(f"recording {rates[-1][0]}: {fps:.4f} frames/s "
                 f"({n} frames)")
        result["onoff"] = rates
        _log(f"outputs bit-identical with recording on and off: "
             f"{result['bit_identical']}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, default=harness.POOL)
    ap.add_argument("--sync-debug", action="store_true")
    ap.add_argument("--onoff", type=float, default=0.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("program_trace: no CUDA card", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload, ROOT)
    result = run(args.workload, args.seed, args.frames, cell=cell,
                 sync=args.sync_debug, onoff=args.onoff)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
