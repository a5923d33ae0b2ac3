"""``kernels.roofline_pct``: the hand-written kernels' share of their
roofline over the profiled frames, in %.

Each call of a launch-counted wrapper (``portbench/rooflines/``) has a
least time: the larger of its bytes over the HBM rate and its
operations over their instruction rates (``portbench/peaks.py``),
counted from the call's shapes and from the work its inputs need.  The
share is the sum of those least times over the device seconds of the
wrappers' own kernels, by name, in the profiler's trace of the same
frames.  No kernel in the trace gives no value."""

from portbench import peaks


def read(trace):
    dt = trace.device
    if dt is None or not trace.records:
        return None
    names = set()
    for roof, _ in trace.records:
        names.update(roof.KERNELS)
    device_s = sum(s for k, s in dt.kernel_s.items() if k in names)
    if device_s <= 0:
        return None
    least = sum(peaks.least_s(*roof.work(rec))[0]
                for roof, rec in trace.records)
    return 100.0 * least / device_s
