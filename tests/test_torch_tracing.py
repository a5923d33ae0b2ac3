"""The port's spans and counters (``blackbox_tpu_torch/utils/timing.py``)
on the CPU, on TINY frames:

- outside ``recording()`` a span or a count records nothing: no CUDA
  event, no profiler annotation, no synchronise, nothing kept;
- inside it the spans nest into one tree a frame (``science.back``
  joins its front's frame), the outputs stay bit-identical, each
  ``lacosmic.pass`` carries its pass's own info, ``host.reads`` counts
  every operation that reads the device on the host, and a profiler
  trace holds the program's span names around their operations.
"""

import collections
import dataclasses
import json
import os
import sys
import tempfile
import threading
import tracemalloc

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from blackbox_tpu_torch.core.geometry import TINY
from blackbox_tpu_torch.ops import cosmics, warp
from blackbox_tpu_torch.pipeline import subtract
from blackbox_tpu_torch.pipeline.reduce import ReduceContext, make_reduce_fn
from blackbox_tpu_torch.synth.device import make_science_device
from blackbox_tpu_torch.utils import timing

sys.path.insert(0, os.path.dirname(__file__))


@pytest.fixture(scope="module")
def tiny():
    """A TINY context, a raw frame, its crosstalk, and the science
    programs against a reference made from the frame itself, moved by
    an integer shift."""
    ctx = ReduceContext.from_defaults(TINY)
    gen = torch.Generator().manual_seed(5)
    raw = make_science_device(gen, TINY, nstars=40, ncosmics=12, nsat=2)[:3]
    xt = np.random.default_rng(0).uniform(-2e-4, 2e-4, (16, 16)).astype(
        np.float32)
    H, W = TINY.red_shape
    step = 32
    gy = np.arange(0, H + step, step, dtype=np.float32)
    gx = np.arange(0, W + step, step, dtype=np.float32)
    sy = np.broadcast_to(gy[:, None] + 3, (len(gy), len(gx))).copy()
    sx = np.broadcast_to(gx[None, :] - 2, (len(gy), len(gx))).copy()
    front, back = subtract.make_science_programs(
        ctx, xt, remap_ranges=warp.grid_shift_ranges(sy, sx, step=step),
        remap_step=step, device="cpu")
    f = front(*raw, None, None, None)
    cat = f["cat"]
    ref = (f["sub"], f["bkg_std"], f["mask"], (sy, sx), f["psf_centre"],
           f["stats"]["bkg_std"],
           {"x": cat["x"], "y": cat["y"], "flux": cat["flux_psf"],
            "fluxerr": cat["fluxerr_psf"], "valid": cat["valid"]})
    return dict(ctx=ctx, raw=raw, xt=xt, front=front, back=back, ref=ref)


def reduce_frame(tiny, ctx=None):
    fn = make_reduce_fn(ctx or tiny["ctx"], device="cpu")
    return fn(*tiny["raw"], None, None, None, tiny["xt"])


def science_frame(tiny):
    f = tiny["front"](*tiny["raw"], None, None, None)
    sub, std, mask, grid, psf, sr, cat = tiny["ref"]
    b = tiny["back"](f["sub"], f["bkg_std"], f["mask"], f["psf_centre"],
                     f["cat"], f["stats"]["bkg_std"], sub, std, mask, grid,
                     psf, sr, cat)
    return {"front": f, "back": b}


FRAMES = {"reduce": reduce_frame, "science": science_frame}


def _fail(*a, **k):
    raise AssertionError("called outside a recording")


@pytest.fixture(scope="module")
def plain(tiny):
    """Each path's outputs with nothing recording, and CUDA events,
    synchronises and profiler annotations patched to fail."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "Event", _fail)
        mp.setattr(torch.cuda, "synchronize", _fail)
        mp.setattr(torch.profiler, "record_function", _fail)
        assert timing.Recorder.active is None
        return {path: make(tiny) for path, make in FRAMES.items()}


@pytest.fixture(scope="module")
def recorded(tiny):
    """A science frame then a reduce frame inside one recording: each
    path's outputs, the spans and the counters."""
    with timing.recording(cuda=False) as rec:
        out = {"science": science_frame(tiny), "reduce": reduce_frame(tiny)}
        spans, counters = rec.drain()
    return out, spans, counters


def test_off_records_nothing(plain, monkeypatch):
    """No CUDA event, profiler annotation or synchronise, and nothing
    kept, while nothing records: the whole reduce and science paths ran
    with those three patched to fail (``plain``), and a span and a count
    keep nothing."""
    monkeypatch.setattr(torch.cuda, "Event", _fail)
    monkeypatch.setattr(torch.cuda, "synchronize", _fail)
    monkeypatch.setattr(torch.profiler, "record_function", _fail)
    assert set(plain) == set(FRAMES)
    assert timing.Recorder.active is None
    assert timing.span("a") is timing.span("b", join="a", x=1)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with timing.span("x") as s:
                s.set(n=1)
                timing.count("host.reads", 3)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == timing.__file__
             and d.size_diff > 0]
    assert not grown, grown
    assert timing.Recorder.active is None


def _children(spans):
    by_id = {s.id: s for s in spans}
    kids = collections.defaultdict(list)
    for s in spans:
        if s.parent is not None:
            kids[by_id[s.parent].name].append(s.name)
    return by_id, kids


def test_tree_and_frames(recorded):
    """Each span's parent is the span it opened in and its frame its
    root's; ``science.back`` is a root that joins the frame of the
    ``science.front`` before it; a reduce frame is a frame of its own."""
    _, spans, counters = recorded
    by_id, kids = _children(spans)
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["science.front", "science.back",
                                       "reduce"]
    front, back, red = roots
    assert back.frame == front.id == front.frame
    assert red.frame == red.id != front.id
    for s in spans:
        root = s
        while root.parent is not None:
            parent = by_id[root.parent]
            assert parent.start_ns <= root.start_ns <= root.end_ns \
                <= parent.end_ns
            root = parent
        assert s.frame == (front.id if root is back else root.frame)
        assert s.device_ms == s.host_ms > 0
    want = {
        "science.front": {"calibration", "catalog"},
        "reduce": {"calibration", "catalog"},
        "calibration": {"calibration.overscan", "calibration.mask",
                        "lacosmic", "fill_holes", "calibration.xtalk",
                        "calibration.trails", "calibration.edge_fill"},
        "calibration.mask": {"fill_holes"},
        "lacosmic": {"lacosmic.pass"},
        "catalog": {"catalog.background", "catalog.detect", "catalog.psf"},
        "science.back": {"warp", "zogy", "transients"},
        "zogy": {"zogy.fft"},
    }
    assert {k: set(v) for k, v in kids.items()} == want
    # two a frame: under build_mask and on the cosmic mask
    assert sum(s.name == "fill_holes" for s in spans) == 4
    assert counters["host.reads"] > 0


def test_warp_span_carries_the_route(recorded):
    """The science back's ``warp`` span says which route the two-pass
    remap took: ``plain`` on the CPU (``kernel``, K10, on the card:
    ``tests/test_torch_warpkernel.py``)."""
    _, spans, _ = recorded
    assert [s.attrs.get("route") for s in spans if s.name == "warp"] == [
        "plain"]


def _leaves(x, path=""):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{path}/{k}")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}/{i}")
    elif isinstance(x, torch.Tensor):
        yield path, x
    elif dataclasses.is_dataclass(x):
        yield from _leaves(dataclasses.asdict(x), path)
    else:
        yield path, x


@pytest.mark.parametrize("path", sorted(FRAMES))
def test_outputs_bit_identical(plain, recorded, path):
    """Recording changes no bit of any output."""
    off = dict(_leaves(plain[path]))
    on = dict(_leaves(recorded[0][path]))
    assert off.keys() == on.keys() and len(off) > 10
    for k, a in off.items():
        b = on[k]
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert torch.equal(a, b) or torch.equal(
                torch.isnan(a), torch.isnan(b)) and torch.equal(
                    a[~torch.isnan(a)], b[~torch.isnan(b)]), k
        else:
            assert a == b or (a != a and b != b), k


@pytest.mark.parametrize("max_cells", [4096, 1], ids=["windowed", "dense"])
def test_pass_attributes_are_the_pass_info(tiny, monkeypatch, max_cells):
    """Each ``lacosmic.pass`` span carries its ``_windowed_pass`` call's
    own info, on a TINY frame; over ``max_cells`` the passes take the
    dense branch."""
    infos = []
    orig = cosmics._windowed_pass

    def keep(*a, **k):
        out = orig(*a, **k)
        infos.append(dict(out[2]))
        return out

    monkeypatch.setattr(cosmics, "_windowed_pass", keep)
    ctx = tiny["ctx"]
    ctx = dataclasses.replace(ctx, lac_params=dataclasses.replace(
        ctx.lac_params, max_cells=max_cells))
    with timing.recording(cuda=False) as rec:
        reduce_frame(tiny, ctx)
        spans, _ = rec.drain()
    attrs = [s.attrs for s in spans if s.name == "lacosmic.pass"]
    assert attrs == infos and len(attrs) >= 2
    branch = "windowed" if max_cells > 1 else "dense"
    assert {a["branch"] for a in attrs} == {branch}
    for a in attrs:
        assert set(a) == {"nact", "branch", "chunks", "windows", "changed"}
        if branch == "windowed":
            chunk = min(ctx.lac_params.window_chunk, max_cells,
                        (-(-TINY.red_shape[0] // 64))
                        * (-(-TINY.red_shape[1] // 64)))
            assert a["windows"] == a["chunks"] * chunk
            assert a["changed"] <= a["nact"] <= a["windows"]
        else:
            assert a["nact"] > max_cells and a["windows"] == 0
    assert attrs[0]["nact"] > 0
    assert attrs[0]["changed"] > 0 or branch == "dense"


# ---- host reads: the counter against every operation that would read
# the device on the host on a card ---------------------------------------

# on a card each of these reads the device on the host (linalg_solve
# its error flags)
_SYNCING = ("aten._local_scalar_dense.default", "aten.item.default",
            "aten.nonzero.default", "aten.masked_select.default",
            "aten.linalg_solve.default")


class _Reads(TorchDispatchMode):
    """Counts the dispatched operations that synchronise a CUDA stream:
    scalar reads, nonzero, boolean-mask indexing, uniques."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name in _SYNCING or "unique" in name or (
                name.startswith(("aten.index.", "aten.index_put"))
                and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                        for i in args[1] if i is not None)):
            self.n += 1
        return func(*args, **(kwargs or {}))


class _Copies(TorchFunctionMode):
    """Counts the tensor methods that copy a device tensor to the host."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in ("tolist", "cpu"):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _segments(tiny):
    ctx = dataclasses.replace(tiny["ctx"], detect_sat_segments=True)
    return reduce_frame(tiny, ctx)


def _dense_sparse(tiny):
    gen = torch.Generator().manual_seed(3)
    img = 300 + 5 * torch.randn(150, 230, generator=gen)
    img[20, 30] += 5000
    img[100, 200] += 5000
    inm = torch.zeros(150, 230, dtype=torch.bool)
    return cosmics.lacosmic(img, inm, torch.full((150, 230), 5.0),
                            cosmics.LACosmicParams(clean_cap=64))


READ_CASES = {"reduce": reduce_frame, "science": science_frame,
              "trail_segments": _segments, "dense_sparse": _dense_sparse}


@pytest.mark.parametrize("case", sorted(READ_CASES))
def test_host_reads_count_every_read(tiny, case):
    """``host.reads`` equals the number of operations that read the
    device on the host, counted independently: every read site is
    counted, once a read."""
    with timing.recording(cuda=False) as rec:
        with _Copies() as copies, _Reads() as reads:
            READ_CASES[case](tiny)
        _, counters = rec.drain()
    n = counters.get("host.reads", 0)
    assert n == reads.n + copies.n and n > 0


def test_read_int_counts_one():
    with timing.recording(cuda=False) as rec:
        assert cosmics._read_int(torch.tensor(7)) == 7
        assert rec.drain()[1] == {"host.reads": 1}


# ---- the profiler, the timer, the recorder --------------------------------

def _trace(tiny, record: bool) -> list:
    from torch.profiler import ProfilerActivity, profile
    ctx = timing.recording(cuda=False) if record else timing.Recorder.null
    with ctx, profile(activities=[ProfilerActivity.CPU]) as prof:
        reduce_frame(tiny)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"]
                    if e.get("ph") == "X"]
    finally:
        os.unlink(path)


PROGRAM_SPANS = {"reduce", "calibration", "calibration.mask", "fill_holes",
                 "lacosmic", "lacosmic.pass", "catalog", "catalog.psf"}


def test_profiler_sees_the_spans(tiny):
    """Inside a recording, a CPU profiler trace of a TINY reduce holds
    the program's span names as annotations, nested as the spans are,
    each around operations of its own."""
    events = _trace(tiny, True)
    ann = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation":
            ann[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    assert PROGRAM_SPANS <= set(ann)
    assert len(ann["fill_holes"]) == 2

    def inside(inner, outer):
        return all(any(a <= x and y <= b for a, b in ann[outer])
                   for x, y in ann[inner])

    assert inside("calibration", "reduce") and inside("catalog", "reduce")
    assert inside("lacosmic", "calibration")
    assert inside("lacosmic.pass", "lacosmic")
    assert inside("fill_holes", "calibration")
    ops = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") == "cpu_op"]
    for name in PROGRAM_SPANS:
        a, b = ann[name][0]
        assert any(a <= x and y <= b for x, y in ops), name


def test_profiler_sees_no_span_off_recording(tiny):
    names = {e["name"] for e in _trace(tiny, False)
             if e.get("cat") == "user_annotation"}
    assert not names & PROGRAM_SPANS


def test_timer_is_a_span(monkeypatch):
    """The driver's timer keeps its sum of seconds, and inside a
    recording it is a span in the same tree."""
    sums = {}
    with timing.timer("host: read", spans=sums):
        pass
    assert sums["host: read"] >= 0
    with timing.recording(cuda=False) as rec:
        with timing.span("process_file"):
            with timing.timer("device: calibrate+extract", spans=sums):
                with timing.span("calibration"):
                    pass
        spans, _ = rec.drain()
    names = [(s.name, s.parent) for s in spans]
    assert names == [("process_file", None),
                     ("device: calibrate+extract", 0),
                     ("calibration", 1)]
    assert set(sums) == {"host: read", "device: calibrate+extract"}


def test_drain_keeps_open_spans_and_resets_counters():
    with timing.recording(cuda=False) as rec:
        with timing.span("outer") as outer:
            with timing.span("inner", k=1):
                timing.count("c", 2)
            done, counters = rec.drain()
            assert [s.name for s in done] == ["inner"]
            assert done[0].attrs == {"k": 1} and done[0].parent == outer.id
            assert counters == {"c": 2}
        done, counters = rec.drain()
        assert [s.name for s in done] == ["outer"] and counters == {}


def test_recordings_nest():
    with timing.recording(cuda=False) as a:
        timing.count("n")
        with timing.recording(cuda=False) as b:
            timing.count("n", 5)
            with timing.span("x"):
                pass
        timing.count("n")
        assert b.drain()[1] == {"n": 5}
        spans, counters = a.drain()
        assert spans == [] and counters == {"n": 2}
    assert timing.Recorder.active is None


def test_threads_keep_their_own_stack():
    """A span opened on another thread is a root there, not a child of
    the span open on this one."""
    with timing.recording(cuda=False) as rec:
        with timing.span("main"):
            t = threading.Thread(target=lambda: timing.span("worker")
                                 .__enter__().__exit__(None, None, None))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        spans, _ = rec.drain()
    by = {s.name: s for s in spans}
    assert by["worker"].parent is None
    assert by["worker"].frame == by["worker"].id != by["main"].id


def test_driver_stages_join_the_file_span(tmp_path):
    """Each raw file the driver processes is one frame: its timers
    (FrameResult.timing's stages, unchanged) are spans under the root
    span ``process_file``."""
    import night_parity as NP
    from blackbox_tpu_torch.config.defaults import ReductionSettings
    from blackbox_tpu_torch.orchestration.paths import DataTree
    from blackbox_tpu_torch.pipeline.driver import SPAN_CALIB, Pipeline
    files, stars = NP.tiny_night(str(tmp_path))
    s = ReductionSettings(geometry=TINY, pixscale=NP.PIXSCALE,
                          create_ref=True)
    p = Pipeline(DataTree(str(tmp_path), "ML1"), "ML1", s, NP.tiny_ctx(s),
                 ref_catalog=NP.ref_catalog(stars, TINY.red_shape),
                 device="cpu")
    with timing.recording(cuda=False) as rec:
        results = [p.process_file(f) for f in files]
        spans, _ = rec.drain()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["process_file"] * len(files)
    assert [s.attrs["file"] for s in roots] == [os.path.basename(f)
                                                for f in files]
    by_frame = collections.defaultdict(set)
    for s in spans:
        by_frame[s.frame].add(s.name)
    for r, res in zip(roots, results):
        stages = {k for k in res.timing if k != "wall"}
        assert {SPAN_CALIB, "calibration", "lacosmic"} <= stages | {
            "calibration", "lacosmic"} <= by_frame[r.id]
        # the science frames' catalogs, and the second visit's
        # subtraction
        assert ("catalog" in by_frame[r.id]) == (r.id >= roots[-2].id)
        assert ("zogy" in by_frame[r.id]) == (r is roots[-1])
