"""The manifest: ``BENCHMARK.json``'s form, and the files it names.

    python -m pytest portbench -q
"""

import json
import re
import shutil
import time

import pytest

from portbench import checks, harness, manifest, tiny

BENCH = manifest.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", [m["name"] for m in METRICS]
                         + [w["name"] for w in BENCH["workloads"]]
                         + [c["name"] for c in BENCH["configs"]]
                         + [w["traffic"] for w in BENCH["workloads"]])
def test_names(name):
    assert NAME.fullmatch(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_form(metric):
    assert UNIT.fullmatch(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    keys = set(metric) - {"workloads"}
    if metric in BENCH["end_to_end"]:
        assert keys == {"name", "unit", "better", "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert keys == {"name", "unit", "better", "source", "layer",
                        "moves"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert 1 <= len(metric["layer"]) <= 200


def test_names_unique():
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_moves_names_a_metric_its_cells_report(metric):
    """``moves`` is an end-to-end metric that every cell of the per-layer
    metric reports."""
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    target = e2e[metric["moves"]]
    cells = metric.get("workloads",
                       [w["name"] for w in BENCH["workloads"]])
    for w in cells:
        assert "workloads" not in target or w in target["workloads"]


@pytest.mark.parametrize("workload", BENCH["workloads"],
                         ids=lambda w: w["name"])
def test_cell_files_found_by_name(workload):
    checks.cell_files(manifest.cell(workload["name"]))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert config["file"].startswith("portbench/configs/")
    data = json.loads((manifest.ROOT / config["file"]).read_text())
    assert config["reduced"] == data["reduced"]
    assert all(isinstance(k, str) and 1 <= len(k) <= 200
               for k in config["reduced"])
    assert len(data["gains"]) == len(data["satlevel_adu"]) == 16
    assert data["precision"] == "float32"
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    assert len(config["source"]) <= 200
    others = [c["source"] for c in BENCH["configs"] if c is not config]
    assert config["source"] not in others


def test_paths_hold_only_names(tmp_path):
    for p in (manifest.HERE).rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(manifest.ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", rel), rel


def _copy(tmp_path):
    """Copy BENCHMARK.json and portbench/ into ``tmp_path``; return the
    copy's ``portbench/`` and BENCHMARK.json's contents."""
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    base = tmp_path / "portbench"
    shutil.copytree(manifest.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return base, json.loads((tmp_path / "BENCHMARK.json").read_text())


def test_cell_added_by_files_alone(tmp_path):
    """A new cell needs only a BENCHMARK.json entry and new files."""
    base, bench = _copy(tmp_path)
    bench["workloads"].append({"name": "ml1.cosmic-heavy", "config": "ml1",
                               "traffic": "cosmic-heavy", "chips": 1,
                               "why": "4000 cosmics a frame"})
    bench["per_layer"][1]["workloads"].append("ml1.cosmic-heavy")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((base / "traffic" / "transient.json").read_text())
    traffic["cosmics"] = 4000
    (base / "traffic" / "cosmic-heavy.json").write_text(json.dumps(traffic))
    (base / "limits" / "ml1.cosmic-heavy.json").write_text(
        (base / "limits" / "ml1.transient.json").read_text())
    cell = manifest.cell("ml1.cosmic-heavy", root=tmp_path, base=base)
    assert cell.traffic["cosmics"] == 4000
    assert [m["name"] for m, _ in cell.per_layer] == [
        BENCH["per_layer"][1]["name"]]
    assert {m["name"] for m, _ in cell.end_to_end} == {
        m["name"] for m in BENCH["end_to_end"]}


def test_entry_and_metric_added_by_files_alone(tmp_path):
    """A cell whose traffic drives a new entry, and reports a new
    end-to-end metric, needs only new files and BENCHMARK.json
    entries: the harness runs it."""
    base, bench = _copy(tmp_path)
    bench["workloads"].append({"name": "ml1.catalog", "config": "ml1",
                               "traffic": "catalog", "chips": 1,
                               "why": "a light field, raw to catalog"})
    bench["end_to_end"].append({"name": "frame_ms_max", "unit": "ms",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["ml1.catalog"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (base / "entries" / "catalog-only.py").write_text(
        (base / "entries" / "reduce.py").read_text().replace(
            '("image", "mask", "bkg_std", "cat")',
            '("image", "mask", "bkg_std", "cat", "stats")'))
    traffic = json.loads((base / "traffic" / "transient.json").read_text())
    traffic = {k: traffic[k] for k in ("field", "cosmics", "trail")}
    (base / "traffic" / "catalog.json").write_text(json.dumps(
        dict(traffic, entry="catalog-only")))
    (base / "limits" / "ml1.catalog.json").write_text(
        (base / "limits" / "bg3.crowded-catalog.json").read_text())
    (base / "end_to_end" / "frame_ms_max.py").write_text(
        "def read(window):\n    return 1e3 * max(window.latency_s)\n")
    cell = tiny.cell("ml1.catalog", root=tmp_path, base=base)
    assert cell.entry.__file__ == str(base / "entries" / "catalog-only.py")
    r = harness.run("ml1.catalog", 7, 0.01, False,
                    t_start=time.perf_counter(), device="cpu", cell=cell,
                    **tiny.RUN)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"frames_per_s", "frame_ms_p90", "setup_s",
                                 "frame_ms_max"}


def test_entry_of_another_kind_added_by_files_alone(tmp_path):
    """A cell whose entry is not a frame reduction, added by new files
    and BENCHMARK.json entries alone (``rehearsal/``: the median of a
    stack of channel stacks, with its own tiny cut, control, witness,
    faults and program values), passes every per-cell check."""
    base, bench = _copy(tmp_path)
    rehearsal = manifest.HERE / "rehearsal"
    for src in sorted(rehearsal.rglob("*")):
        rel = src.relative_to(rehearsal)
        if src.is_file() and "__pycache__" not in rel.parts \
                and rel.name != "benchmark.json":
            assert not (base / rel).exists(), rel       # new files only
            shutil.copy(src, base / rel)
    extra = json.loads((rehearsal / "benchmark.json").read_text())
    for key, entries in extra.items():
        bench[key] += entries
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    name = extra["workloads"][0]["name"]

    full = manifest.cell(name, root=tmp_path, base=base)
    checks.declarations(full)
    checks.cell_files(full)
    cell = tiny.cell(name, root=tmp_path, base=base)
    assert cell.entry.__file__ == str(base / "entries" / "stack-median.py")
    checks.result_line(cell, trace=False)
    checks.result_line(cell, trace=True)
    checks.control_not_correct(cell)
    checks.witness_correct(cell)
    checks.control_readings(cell)
    for fault in cell.entry.FAULTS:
        checks.fault_not_correct(cell, fault)
    checks.pool_follows_the_seed(cell)
    checks.inputs_unchanged(cell, "cpu")
    checks.phases(cell)
