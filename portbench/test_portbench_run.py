"""Runs of every cell at the port's TINY geometry on the CPU: the result
line, the control and the entry's planted faults coming out not
correct, the frame pool, the entries' inputs, and the modules a run
loads.  The card's case of the inputs test is marked ``cuda``.  Each
per-cell test runs a check of :mod:`portbench.checks`.

    python -m pytest portbench -q
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import checks, harness, manifest, package, tiny

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]
FAULTS = [(w, f) for w in CELLS
          for f in getattr(manifest.cell(w).entry, "FAULTS", ())]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("workload", CELLS)
def test_entry_declares_its_hooks(workload):
    """``tiny``, ``FAULTS`` (one at least) and ``PROGRAM_VALUES``."""
    checks.declarations(manifest.cell(workload))


def test_package_reaches_any_module():
    """An entry reaches a module beyond the seven that ``Package``
    names, on either side, by its path inside the package."""
    prog = package.Package(package.PROGRAM)
    ref = package.Package(package.REFERENCE)
    masters = prog.module("pipeline.masters")
    assert masters.__name__ == "blackbox_tpu_torch.pipeline.masters"
    assert callable(masters.master_bias)
    assert ref.module("ops.stats") is ref.stats
    assert ref.stats.__name__ == "portbench.reference.ops.stats"


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line(workload, trace):
    checks.result_line(tiny.cell(workload), trace)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    checks.control_not_correct(tiny.cell(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_witness_is_correct(workload):
    checks.witness_correct(tiny.cell(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_control_readings(workload):
    checks.control_readings(tiny.cell(workload))


@pytest.mark.parametrize("workload, fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_fault_is_not_correct(workload, fault):
    checks.fault_not_correct(tiny.cell(workload), fault)


@pytest.mark.parametrize("workload", CELLS)
def test_pool_follows_the_seed(workload):
    checks.pool_follows_the_seed(tiny.cell(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_entries_leave_inputs_unchanged(workload):
    checks.inputs_unchanged(tiny.cell(workload), "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_entries_leave_inputs_unchanged_on_the_card(workload, card):
    """The same at the cell's own size, on the card."""
    checks.inputs_unchanged(manifest.cell(workload), card)


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
