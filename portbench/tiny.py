"""A cell of ``BENCHMARK.json`` cut to the port's ``TINY`` geometry, for
the benchmark's own CPU tests: the same configuration, traffic mix,
entry, limits and metrics, with a frame of 132 x 320 pixels, tens of
stars and a few cosmics and transients, and the harness's counts in
:data:`RUN`.  Never used by a benchmark run."""

from __future__ import annotations

import copy

from portbench import manifest

RUN = {"pool": 3, "warmup": 1, "profiled": 1, "checked": 1}


def cell(workload: str, **base) -> manifest.Cell:
    c = manifest.cell(workload, **base)
    c.config = copy.deepcopy(c.config)
    c.config["geometry"] = "TINY"
    c.config["detect"]["max_sources"] = 256
    t = copy.deepcopy(c.traffic)
    t["cosmics"] = 6
    t["field"].update(stars=40, saturated=1)
    if "transients" in t:
        t["transients"]["count"] = 3
    c.traffic = t
    return c
