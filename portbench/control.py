#!/usr/bin/env python3
"""The comparison's control and witness against the plain reference, at
the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

The control is the reference in the program's place with the entry's
own float32 stage held in bfloat16, and the witness, a sound change
that is not bit-exact, the same stage moved by a unit in the last place
of float32: the entry module's ``control`` and ``witness`` (for the
entries on raw frames, ``package.bfloat16_frame`` and
``package.ulp_frame`` on the overscan-corrected frames).  For each seed:
the cell's inputs, one pool item drawn from the seed, the reference's
outputs, the control's and the witness's, and every compared number
beside the cell's limit (one JSON line a seed on standard output).  The
limits lie above the program's and the witness's readings and below the
control's (PERF.md).  Not part of a benchmark run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, device) -> dict:
    """The control's and the witness's numbers on one item of
    ``seed``'s pool."""
    import torch

    from portbench import compare, harness, package

    idx = random.Random(seed).randrange(harness.POOL)
    inputs = cell.entry.inputs(cell.config, cell.traffic, seed, device,
                               idx + 1)
    ref = package.Package(package.REFERENCE)
    numbers = getattr(cell.entry, "numbers", compare.numbers)

    def outputs():
        return cell.entry.Entry(ref, cell.config, cell.traffic, inputs,
                                device)(inputs.pool[idx])

    want = outputs()
    out = {}
    for name, change in (("control", cell.entry.control),
                         ("witness", cell.entry.witness)):
        with change(ref):
            got = outputs()
        out[name] = numbers(got, want)
        del got
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, manifest

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {harness.card_label()}", file=sys.stderr)
    cell = manifest.cell(args.workload, ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = readings(cell, seed, "cuda")
        fails = {side: sorted(k for k, v in r.items()
                              if v > cell.limits.get(k, float("inf")))
                 for side, r in nums.items()}
        print(json.dumps({"workload": args.workload, "seed": seed, **nums,
                          "limits": cell.limits, "fails": fails,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
