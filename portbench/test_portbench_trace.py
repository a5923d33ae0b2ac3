"""The device trace's arithmetic on a made-up profiler trace: the busy
time is the union of overlapping device intervals inside the profiled
frames, and each idle gap goes to what the host thread was in.

    python -m pytest portbench -q
"""

import pytest

from portbench import manifest, spans


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


EVENTS = [
    ev("user_annotation", spans.FRAME, 0, 100),
    ev("user_annotation", spans.FRAME, 120, 80),
    ev("user_annotation", spans.SPAN + "calibration", 0, 60),
    ev("cpu_op", "aten::item", 40, 15),
    ev("kernel", "void (anonymous namespace)::median_kernel<7>(float "
       "const*, float*, int, int, int)", 10, 20, tid=7),
    ev("kernel", "void at::native::vectorized_elementwise_kernel<4, "
       "at::native::AbsFunctor<float> >(int, float)", 20, 20, tid=7),
    ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 60, 20, tid=7),
    ev("kernel", "gather_kernel(unsigned int const*)", 150, 10, tid=7),
    ev("kernel", "gather_kernel(unsigned int const*)", 90, 20, tid=7),
    ev("kernel", "outside_kernel", 300, 10, tid=7),
]


def test_union_and_gaps():
    dt = spans.read_trace(EVENTS)
    assert dt.window_s == pytest.approx(200e-6)
    # [10, 40) ∪ [60, 80) ∪ [90, 110) ∪ [150, 160); the kernel at 300
    # is outside the frames
    assert dt.busy_s == pytest.approx(80e-6)
    assert dt.kernel_s == pytest.approx({
        "median_kernel": 20e-6, "at::native::vectorized_elementwise_kernel":
        20e-6, "gather_kernel": 30e-6})
    # a gap goes to what the host was in when it began
    gaps = dt.gap_s
    assert gaps["calibration"] == pytest.approx(10e-6)        # [0, 10)
    assert gaps["calibration: aten::item"] == pytest.approx(20e-6)
    assert gaps["frame"] == pytest.approx(50e-6)     # [80, 90), [160, 200)
    assert gaps["between frames"] == pytest.approx(40e-6)     # [110, 150)
    assert sum(gaps.values()) == pytest.approx(120e-6)


def test_no_frames_no_trace():
    assert spans.read_trace(EVENTS[2:]) is None


@pytest.mark.parametrize("name, base", [
    ("void (anonymous namespace)::stage1(Frame, float const*)", "stage1"),
    ("radix2_kernel(float const*, float const*)", "radix2_kernel"),
    ("void prop_tiles<Seeds, Sink>(Seeds, Sink, int const*)", "prop_tiles"),
    ("void at::native::reduce_kernel<512, 1>(int)",
     "at::native::reduce_kernel"),
])
def test_kernel_names(name, base):
    assert spans.kernel_base(name) == base


def test_idle_and_roofline_readers():
    dt = spans.read_trace(EVENTS)
    roof = {r.__name__.rsplit("_", 1)[-1]: r for r in manifest.rooflines()}
    rec = {"H": 1000, "W": 1000, "k": 3}
    tr = spans.Trace(2, {}, {}, [(roof["K2"], rec)], dt)
    idle = manifest.metric_reader("device.idle_pct").read(tr)
    assert idle == pytest.approx(60.0)
    pct = manifest.metric_reader("kernels.roofline_pct").read(tr)
    # 8e6 bytes at 3.35 TB/s over the wrappers' kernels' device time
    # (K2's median_kernel, 20 us; gather_kernel is K4's, not called)
    assert pct == pytest.approx(100 * 8e6 / 3.35e12 / 20e-6)
    assert manifest.metric_reader("warp.ms").read(tr) is None
