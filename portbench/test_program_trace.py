"""``program_trace.py``'s readers on made-up spans and traces, and its
phases on every cell at the port's TINY geometry on the CPU.

    python -m pytest portbench -q
"""

import types

import pytest

from portbench import checks, manifest, program_trace, spans, tiny

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


def sp(name, ms, **attrs):
    return types.SimpleNamespace(name=name, device_ms=ms, attrs=attrs)


SPANS = [
    sp("calibration", 100.0), sp("calibration.mask", 30.0),
    sp("fill_holes", 10.0), sp("fill_holes", 12.0), sp("lacosmic", 40.0),
    sp("lacosmic.pass", 20.0, nact=300, branch="windowed", chunks=2,
       windows=512, changed=256),
    sp("lacosmic.pass", 10.0, nact=100, branch="windowed", chunks=1,
       windows=256, changed=0),
    sp("calibration", 120.0), sp("fill_holes", 8.0),
    sp("lacosmic.pass", 30.0, nact=5000, branch="dense", chunks=0,
       windows=0, changed=0),
]


def test_read_program():
    v = program_trace.read_program(SPANS, {"host.reads": 50}, 2)
    assert v["calibration.device_ms"] == pytest.approx(110.0)
    assert v["fill_holes.device_ms"] == pytest.approx(15.0)
    assert v["mask.device_ms"] == pytest.approx(15.0)
    assert v["lacosmic.active_cells"] == pytest.approx(2700.0)
    assert v["lacosmic.window_yield_pct"] == pytest.approx(100 * 256 / 768)
    assert v["host.reads_per_frame"] == pytest.approx(25.0)
    # spans that never ran give no value
    for m in ("warp.device_ms", "zogy.device_ms", "zogy.fft.device_ms",
              "catalog.device_ms"):
        assert m not in v


def test_read_program_nothing():
    assert program_trace.read_program([], {}, 3) == {}
    dense = [sp("lacosmic.pass", 1.0, nact=9, branch="dense", chunks=0,
                windows=0, changed=0)]
    v = program_trace.read_program(dense, {}, 1)
    assert v == {"lacosmic.active_cells": 9.0}


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


EVENTS = [
    ev("user_annotation", spans.FRAME, 0, 100),
    ev("user_annotation", spans.FRAME, 120, 80),
    ev("user_annotation", "calibration", 0, 60),
    ev("user_annotation", "lacosmic", 30, 20),
    ev("user_annotation", "calibration", 130, 40),
    ev("user_annotation", "calibration", 0, 300, tid=2),   # another thread
    ev("kernel", "a", 10, 20, tid=7),
    ev("gpu_memcpy", "b", 45, 10, tid=7),
    ev("kernel", "c", 150, 10, tid=7),
]


def test_idle_within():
    # calibration [0, 60) ∪ [130, 170): busy [10, 30) ∪ [45, 55) ∪
    # [150, 160) inside it, so idle 60 + 40 - 40 = 60 us
    assert program_trace.idle_within(EVENTS, "calibration") == \
        pytest.approx(60e-6)
    # lacosmic [30, 50): busy [45, 50)
    assert program_trace.idle_within(EVENTS, "lacosmic") == \
        pytest.approx(15e-6)
    assert program_trace.idle_within(EVENTS, "zogy") is None
    assert program_trace.idle_within(EVENTS[1:], "calibration") is not None
    assert program_trace.idle_within(EVENTS[2:], "calibration") is None
    # no device activity: nothing to call idle
    assert program_trace.idle_within(EVENTS[:6], "calibration") is None


def test_read_trace_keeps_its_result_with_program_spans():
    """The harness's reduction of a trace is what it was; a gap inside a
    program span goes to the innermost annotation, as before."""
    dt = spans.read_trace(EVENTS)
    assert dt.busy_s == pytest.approx(40e-6)
    assert dt.gap_s["lacosmic"] == pytest.approx(15e-6)      # [30, 45)


@pytest.mark.parametrize("workload", CELLS)
def test_phases_on_tiny(workload):
    checks.phases(tiny.cell(workload))
