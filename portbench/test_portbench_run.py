"""Runs of both cells at the port's TINY geometry on the CPU: the result
line, the control and planted faults coming out not correct, the frame
pool, the entries' inputs, and the modules a run loads.  The card's
case of the inputs test is marked ``cuda``.

    python -m pytest portbench -q
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, manifest, package, tiny

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]
SEED = 2 ** 31 + 17


def run(workload, trace=False, **kw):
    return harness.run(workload, SEED, 0.01, trace,
                       t_start=time.perf_counter(), device="cpu",
                       cell=tiny.cell(workload), **tiny.RUN, **kw)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line(workload, trace):
    """A rehearsal of the cell's path: the result's keys, its metrics,
    ``checks`` last, and ``correct`` true."""
    r = run(workload, trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    cell = manifest.cell(workload)
    if trace:
        allowed = {m["name"] for m, _ in cell.per_layer}
        assert set(r["metrics"]) <= allowed
        # the CPU has spans but no device trace
        assert {"calibration.ms", "catalog.ms"} <= set(r["metrics"])
        assert {"busy_s", "window_s"} <= set(r["device"])
    else:
        assert set(r["metrics"]) == {m["name"] for m, _ in cell.end_to_end}
    for m in r["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert set(r["checks"]) == set(cell.limits)
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The reference in the program's place with its frame held in
    bfloat16 after the overscan fails the comparison."""
    r = run(workload, program=package.REFERENCE,
            program_context=package.bfloat16_frame)
    assert r["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_witness_is_correct(workload):
    """The reference in the program's place with its frame moved by a
    unit in the last place, a sound change that is not bit-exact,
    passes the comparison."""
    r = run(workload, program=package.REFERENCE,
            program_context=package.ulp_frame)
    assert r["correct"] is True, r["checks"]


@contextlib.contextmanager
def patched(mod, attr, make):
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def stale(pkg):
    """A step that returns its state unchanged: calibration hands on
    the first frame's result for every frame."""
    def make(orig):
        seen = []

        def step(*a, **k):
            if not seen:
                seen.append(orig(*a, **k))
            return seen[0]
        return step
    stack = contextlib.ExitStack()
    for mod in (pkg.reduce, pkg.subtract):
        stack.enter_context(patched(mod, "calibrate_detector", make))
    return stack


def _catalog_fault(pkg, change):
    def make(orig):
        def step(*a, **k):
            out = orig(*a, **k)
            change(out["cat"])
            return out
        return step
    stack = contextlib.ExitStack()
    for mod in (pkg.reduce, pkg.subtract):
        stack.enter_context(patched(mod, "extract_catalog", make))
    return stack


def half(pkg):
    """Half of the batch left out: every other source of the catalog."""
    def change(cat):
        cat["valid"] = cat["valid"] & (
            torch.arange(cat["valid"].shape[0]) % 2 == 0)
    return _catalog_fault(pkg, change)


def altered_flux(pkg):
    """An answer altered where it is produced: one source's PSF flux,
    by ten of its errors."""
    def change(cat):
        i = int(torch.nonzero(cat["valid"])[0])
        cat["flux_psf"][i] += 10 * cat["fluxerr_psf"][i].abs()
    return _catalog_fault(pkg, change)


def altered_pixel(pkg):
    """An answer altered where it is produced: one pixel of the
    calibrated image, by 100 e-."""
    def make(orig):
        def step(*a, **k):
            sci, mask, stats = orig(*a, **k)
            sci = sci.clone()
            sci[sci.shape[0] // 2, sci.shape[1] // 3] += 100.0
            return sci, mask, stats
        return step
    stack = contextlib.ExitStack()
    for mod in (pkg.reduce, pkg.subtract):
        stack.enter_context(patched(mod, "calibrate_detector", make))
    return stack


def altered_transient(pkg):
    """An answer altered where it is produced: one transient's PSF
    flux, by ten of its errors."""
    def make(orig):
        def step(*a, **k):
            cat, n = orig(*a, **k)
            i = int(torch.nonzero(cat["valid"])[0])
            cat["flux_psf"][i] += 10 * cat["fluxerr_psf"][i].abs()
            return cat, n
        return step
    return patched(pkg.subtract, "extract_transients", make)


FAULTS = [(w, f) for w in CELLS
          for f in (stale, half, altered_flux, altered_pixel)]
FAULTS.append(("ml1.transient", altered_transient))


@pytest.mark.parametrize("workload, fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_fault_is_not_correct(workload, fault):
    """The harness, run with the timed path broken underneath, finds it
    not correct."""
    assert run(workload, program_context=fault)["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_pool_follows_the_seed(workload):
    cell = tiny.cell(workload)
    pool = tiny.RUN["pool"]
    a = cell.entry.inputs(cell.config, cell.traffic, SEED, "cpu", pool)
    b = cell.entry.inputs(cell.config, cell.traffic, SEED, "cpu", pool)
    c = cell.entry.inputs(cell.config, cell.traffic, SEED + 1, "cpu", pool)
    assert len(a.pool) == pool
    for fa, fb, fc in zip(a.pool, b.pool, c.pool):
        for x, y, z in zip(fa, fb, fc):
            assert torch.equal(x, y) and not torch.equal(x, z)
            assert x.shape == z.shape
    assert torch.equal(a.mflat, b.mflat) and not torch.equal(a.mflat,
                                                             c.mflat)
    # distinct frames in one pool
    assert not torch.equal(a.pool[0][0], a.pool[1][0])


def _inputs_unchanged(cell, device):
    inputs = cell.entry.inputs(cell.config, cell.traffic, SEED, device, 2)
    before = [tuple(x.clone() for x in f) for f in inputs.pool[:2]]
    ref_raw = getattr(inputs, "ref_raw", None) or ()
    ref_before = tuple(x.clone() for x in ref_raw)
    masters = (inputs.mbias.clone(), inputs.mflat.clone(),
               inputs.xtalk.copy())
    entry = cell.entry.Entry(package.Package(package.PROGRAM), cell.config,
                             cell.traffic, inputs, device)
    planes = ([t.clone() for t in entry.ref[:3]]
              if hasattr(entry, "ref") else [])
    for f in inputs.pool:
        entry(f)
        entry(f)
    for f, g in zip(inputs.pool[:2], before):
        assert all(torch.equal(x, y) for x, y in zip(f, g))
    assert all(torch.equal(x, y) for x, y in zip(ref_raw, ref_before))
    assert torch.equal(inputs.mbias, masters[0])
    assert torch.equal(inputs.mflat, masters[1])
    assert (inputs.xtalk == masters[2]).all()
    for t, u in zip(entry.ref[:3] if planes else (), planes):
        assert torch.equal(t, u)


@pytest.mark.parametrize("workload", CELLS)
def test_entries_leave_inputs_unchanged(workload):
    """Cycling a pool is sound only if a call changes neither the raw
    frames, the masters nor the reference planes on the card."""
    _inputs_unchanged(tiny.cell(workload), "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_entries_leave_inputs_unchanged_on_the_card(workload, card):
    """The same at the cell's own size, on the card."""
    _inputs_unchanged(manifest.cell(workload), card)


PROBE = """
import sys, time
sys.path.insert(0, {root!r})
from portbench import {mods}
{body}
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(body, mods="harness, tiny", cwd=None):
    code = PROBE.format(root=str(cwd or manifest.ROOT), mods=mods,
                        body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=cwd or manifest.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split("\n")[-2].split())


def test_a_run_loads_no_jax():
    """Compared by whole top-level names: the port's own name begins
    with the JAX package's."""
    mods = _modules(
        "harness.run('bg3.crowded-catalog', 5, 0.01, False, "
        "t_start=time.perf_counter(), device='cpu', "
        "cell=tiny.cell('bg3.crowded-catalog'), **tiny.RUN)")
    assert "blackbox_tpu_torch" in mods
    assert not mods & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    body = ("from portbench import package\n"
            "cell = tiny.cell('ml1.transient')\n"
            "x = cell.entry.inputs(cell.config, cell.traffic, 5, 'cpu', 1)\n"
            "e = cell.entry.Entry(package.Package(package.REFERENCE), "
            "cell.config, cell.traffic, x, 'cpu')\n"
            "e(x.pool[0])")
    mods = _modules(body, mods="tiny")
    assert "portbench" in mods
    assert not mods & (set(harness.FORBIDDEN) | {"blackbox_tpu_torch"})


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "ml1.transient", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=manifest.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_is_no_run(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ has no
    program: the run fails and prints no result."""
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time\nsys.path.insert(0, '.')\n"
            "from portbench import harness, tiny\n"
            "print(harness.run('bg3.crowded-catalog', 5, 0.01, False, "
            "t_start=time.perf_counter(), device='cpu', "
            "cell=tiny.cell('bg3.crowded-catalog'), **tiny.RUN))")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""
    assert "blackbox_tpu_torch" in out.stderr
