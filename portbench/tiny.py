"""A cell of ``BENCHMARK.json`` cut to the port's ``TINY`` geometry, for
the benchmark's own CPU tests: the same configuration, traffic mix,
entry, limits and metrics, cut by the entry's own ``tiny(config,
traffic)``, and the harness's counts in :data:`RUN`.  Never used by a
benchmark run."""

from __future__ import annotations

import copy

from portbench import manifest

RUN = {"pool": 3, "warmup": 1, "profiled": 1, "checked": 1}


def cell(workload: str, **base) -> manifest.Cell:
    c = manifest.cell(workload, **base)
    c.config, c.traffic = c.entry.tiny(copy.deepcopy(c.config),
                                       copy.deepcopy(c.traffic))
    return c


def raw_frame_cut(config: dict, traffic: dict) -> tuple:
    """The cut of an entry on raw frames: 132 x 320 pixels, at most 256
    sources, 6 cosmics, 40 stars and 1 saturated."""
    config["geometry"] = "TINY"
    config["detect"]["max_sources"] = 256
    traffic["cosmics"] = 6
    traffic["field"].update(stars=40, saturated=1)
    return config, traffic
