"""What a run of one cell is made of, found by name.

``BENCHMARK.json`` at the checkout's root names the cells; everything
that belongs to one configuration, traffic mix, per-layer metric,
kernel or cell is a file of its own under ``portbench/``:

    configs/<config>.json     sizes, gains, settings (the entry's ``file``)
    traffic/<traffic>.json    the frames' parameters and the entry they
                              drive (its ``entry``)
    entries/<entry>.py        an entry: its inputs from the seed, the
                              program call it times and, where its
                              outputs are not compare.py's, its own
                              ``numbers``
    limits/<workload>.json    each compared number's limit
    end_to_end/<metric>.py    an end-to-end metric's reader
    metrics/<metric>.py       a per-layer metric's reader
    rooflines/<kernel>.py     a kernel wrapper's bytes and operations

A cell, an entry or a metric added by new files and entries alone is
found the same way.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod         # a dataclass looks its module up
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict          # the BENCHMARK.json entry
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    entry: object           # entries/<traffic's entry>.py
    limits: dict            # limits/<workload>.json
    end_to_end: list        # (metric, reader module) this cell reports
    per_layer: list         # (metric, reader module) this cell reports


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _module_name(kind: str, name: str) -> str:
    return f"portbench_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)


def metric_reader(name: str, base: Path = HERE, kind: str = "metrics"):
    """The reader module of metric ``name``: ``metrics/`` for a
    per-layer metric, ``end_to_end/`` for an end-to-end one."""
    return _load_module(base / kind / f"{name}.py", _module_name(kind, name))


def entry(name: str, base: Path = HERE):
    """The module of entry ``name``: ``inputs(config, traffic, seed,
    device, pool)`` and ``Entry(package, config, traffic, inputs,
    device)``, called once a frame."""
    return _load_module(base / "entries" / f"{name}.py",
                        _module_name("entry", name))


def rooflines(base: Path = HERE) -> list:
    """Every kernel's roofline module, by file name order."""
    return [_load_module(p, _module_name("roofline", p.stem))
            for p in sorted((base / "rooflines").glob("*.py"))]


def cell(workload: str, root: Path = ROOT, base: Path = HERE) -> Cell:
    bench = benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((base / "limits" / f"{workload}.json").read_text())
    e2e = [(m, metric_reader(m["name"], base, "end_to_end"))
           for m in bench["end_to_end"] if _reports(m, workload)]
    layer = [(m, metric_reader(m["name"], base))
             for m in bench["per_layer"] if _reports(m, workload)]
    return Cell(workload, w, config, traffic, entry(traffic["entry"], base),
                limits, e2e, layer)
