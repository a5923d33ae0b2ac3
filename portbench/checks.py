"""The checks the benchmark's tests make of every cell, each a function
of a :class:`~portbench.manifest.Cell`: the tests run them on each cell
of ``BENCHMARK.json``, and on a cell added in a copy by new files alone.

Everything a check assumes of a cell comes from the cell's files and its
entry module's declarations: ``tiny``, ``control``, ``witness``,
``FAULTS`` and ``PROGRAM_VALUES``.  Never used by a benchmark run.

    python -m pytest portbench -q
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from portbench import harness, manifest, package, program_trace, tiny

SEED = 2 ** 31 + 17


def run(cell: manifest.Cell, trace=False, **kw) -> dict:
    """The harness on a tiny cell on the CPU, for a hundredth of a
    second."""
    return harness.run(cell.name, SEED, 0.01, trace,
                       t_start=time.perf_counter(), device="cpu", cell=cell,
                       **tiny.RUN, **kw)


def declarations(cell: manifest.Cell) -> None:
    """The entry declares what the tests need of it: without ``tiny``
    no test can rehearse the cell on the CPU, and a cell with no planted
    fault guards nothing."""
    e = cell.entry
    for hook in ("tiny", "control", "witness"):
        assert callable(getattr(e, hook, None)), \
            f"{e.__file__}: declares no {hook}"
    faults = getattr(e, "FAULTS", ())
    assert faults and all(callable(f) for f in faults), \
        f"{e.__file__}: declares no FAULTS"
    assert isinstance(getattr(e, "PROGRAM_VALUES", None), frozenset), \
        f"{e.__file__}: declares no PROGRAM_VALUES"


def cell_files(cell: manifest.Cell) -> None:
    """The cell's files, found by the names in its BENCHMARK.json entry."""
    workload = cell.workload
    assert callable(cell.entry.inputs) and callable(cell.entry.Entry)
    assert cell.config["name"] == workload["config"]
    assert workload["chips"] in (1, 4)
    assert 1 <= len(workload["why"]) <= 200
    e2e = {m["name"] for m, _ in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for _, reader in cell.end_to_end + cell.per_layer:
        assert callable(reader.read)


def result_line(cell: manifest.Cell, trace: bool) -> None:
    """A rehearsal of the cell's path: the result's keys, its metrics,
    ``checks`` last, and ``correct`` true.  Traced, every per-layer
    metric of the program's spans reads a value (the CPU has spans but
    no device trace)."""
    r = run(cell, trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    if trace:
        assert set(r["metrics"]) <= {m["name"] for m, _ in cell.per_layer}
        spans = {m["name"] for m, _ in cell.per_layer
                 if m["source"] == "program_span"}
        assert spans <= set(r["metrics"]), spans - set(r["metrics"])
        assert {"busy_s", "window_s"} <= set(r["device"])
    else:
        assert set(r["metrics"]) == {m["name"] for m, _ in cell.end_to_end}
    for m in r["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert set(r["checks"]) == set(cell.limits)
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r)


def control_not_correct(cell: manifest.Cell) -> None:
    """The reference in the program's place under the entry's control
    fails the comparison."""
    r = run(cell, program=package.REFERENCE,
            program_context=cell.entry.control)
    assert r["correct"] is False, r["checks"]


def witness_correct(cell: manifest.Cell) -> None:
    """The reference in the program's place under the entry's witness,
    a sound change that is not bit-exact, passes the comparison."""
    r = run(cell, program=package.REFERENCE,
            program_context=cell.entry.witness)
    assert r["correct"] is True, r["checks"]


def control_readings(cell: manifest.Cell, device="cpu") -> None:
    """``control.py``'s readings: the entry's control reads one of the
    cell's numbers above its limit at least, its witness none."""
    from portbench import control

    r = control.readings(cell, SEED, device)
    over = {side: [k for k, v in nums.items() if v > cell.limits[k]]
            for side, nums in r.items()}
    assert over["control"] and not over["witness"], r


def fault_not_correct(cell: manifest.Cell, fault) -> None:
    """The harness, run with the timed path broken underneath, finds it
    not correct."""
    r = run(cell, program_context=fault)
    assert r["correct"] is False, r["checks"]


def leaves(x, path: str = "inputs"):
    """(path, array) of every tensor and ndarray in ``x``: a dataclass's
    fields, lists, tuples and dicts, walked in order."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        yield path, x
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from leaves(getattr(x, f.name), f"{path}.{f.name}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from leaves(v, f"{path}[{i}]")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from leaves(v, f"{path}[{k!r}]")


def same(a, b) -> bool:
    """Two arrays equal bit for bit in shape, type and value (NaN where
    NaN)."""
    if isinstance(a, torch.Tensor):
        if not isinstance(b, torch.Tensor) or a.shape != b.shape \
                or a.dtype != b.dtype:
            return False
        return bool(((a == b) | (a != a) & (b != b)).all())
    return (isinstance(b, np.ndarray) and a.shape == b.shape
            and a.dtype == b.dtype and np.array_equal(
                a, b, equal_nan=a.dtype.kind in "fc"))


def pool_follows_the_seed(cell: manifest.Cell) -> None:
    """The same seed gives the same inputs, every array of them; another
    seed gives arrays of the same shapes, every tensor of them other
    (the inputs draw on the device from the seed; a host array may be
    fixed by the traffic, as a registration grid is); every tensor of a
    pool item differs from the same tensor of the first item."""
    pool = tiny.RUN["pool"]
    a, b, c = (cell.entry.inputs(cell.config, cell.traffic, s, "cpu", pool)
               for s in (SEED, SEED, SEED + 1))
    assert len(a.pool) == pool
    la, lb, lc = (list(leaves(x)) for x in (a, b, c))
    assert [p for p, _ in la] == [p for p, _ in lb] == [p for p, _ in lc]
    assert la, "no arrays in the inputs"
    for (path, x), (_, y), (_, z) in zip(la, lb, lc):
        assert same(x, y), f"{path} differs for the same seed"
        assert x.shape == z.shape, path
        if isinstance(x, torch.Tensor):
            assert not same(x, z), f"{path} does not follow the seed"
    first = list(leaves(a.pool[0], "pool[0]"))
    for i, item in enumerate(a.pool[1:], 1):
        for (path, x), (_, y) in zip(first, leaves(item)):
            if isinstance(x, torch.Tensor):
                assert not same(x, y), f"{path} same in pool[{i}]"


def _copies(x, path: str) -> list:
    return [(p, v.clone() if isinstance(v, torch.Tensor) else v.copy())
            for p, v in leaves(x, path)]


def _unchanged(x, path: str, copies: list) -> None:
    now = list(leaves(x, path))
    assert [p for p, _ in now] == [p for p, _ in copies]
    for (p, v), (_, w) in zip(now, copies):
        assert same(v, w), f"{p} changed"


def inputs_unchanged(cell: manifest.Cell, device) -> None:
    """Cycling a pool is sound only if a call changes no array of the
    inputs (raw frames, masters, an entry's own fields) and none of the
    entry's set-up state (``entry.ref``, where the entry has one)."""
    inputs = cell.entry.inputs(cell.config, cell.traffic, SEED, device, 2)
    inputs_before = _copies(inputs, "inputs")
    entry = cell.entry.Entry(package.Package(package.PROGRAM), cell.config,
                             cell.traffic, inputs, device)
    state = getattr(entry, "ref", ())
    state_before = _copies(state, "entry.ref")
    for f in inputs.pool:
        entry(f)
        entry(f)
    _unchanged(inputs, "inputs", inputs_before)
    _unchanged(state, "entry.ref", state_before)


def phases(cell: manifest.Cell) -> None:
    """A rehearsal of ``program_trace.py``: the values the entry
    declares and no other (the CPU has no device activity, so no idle
    times), each above 0, the twins, and outputs bit-identical with
    recording on and off."""
    r = program_trace.run(cell.name, SEED, 2, device="cpu", cell=cell,
                          pool=tiny.RUN["pool"], warmup=1, onoff=0.01)
    want = cell.entry.PROGRAM_VALUES
    assert set(r["values"]) == want
    assert all(v > 0 for v in r["values"].values())
    assert set(r["twins_pct"]) == {m for m in program_trace.TWINS
                                   if m in want}
    assert r["bit_identical"] is True
    assert [side for side, _, _ in r["onoff"]] == ["off", "on", "on", "off"]
