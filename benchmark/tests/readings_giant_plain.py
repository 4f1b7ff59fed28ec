"""Readings for the limits of the plain giant cell's checks
(``giant-plain-train``).

As ``readings.py`` does for the other cells: runs the cell once a seed in
one process and prints each run's result line with its seed, with the
program as it is (the sound readings), with the control in the program's
place (``--control``: the reference on bfloat16 aggregation streams), or
with a fault planted in the program (``--fault``).  On the card at the
cell's own size:

    python3 benchmark/tests/readings_giant_plain.py --seeds 1,2,3 --seconds 2

``--tiny`` runs on the CPU at the tests' sizes instead.  No benchmark
run uses this script.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402
from benchmark.tests import readings  # noqa: E402

WORKLOAD = "giant-plain-train"
FAULTS = ("unchanged", "half_batch")

# CPU sizes of the tests: the published widths, a small graph
TINY_CONFIG = {"nodes": 4096, "bandwidth": 15}
TINY_TRAFFIC = {"epochs_per_job": 20, "epochs_per_call": 5, "job_graphs": 3}


@contextlib.contextmanager
def planted(fault: str | None):
    """The plain giant trainer with ``fault`` planted:

    * ``unchanged``: Adam's step leaves the state as it was
      (``readings.planted``);
    * ``half_batch``: the loss leaves out the second half of the nodes'
      one-hot rows and scales the rest to the whole."""
    if fault in (None, "unchanged"):
        with readings.planted(fault):
            yield
        return
    if fault != "half_batch":
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    import torch

    import gcn_maxcut_tpu_torch.bench.giant_demo as gd

    real = gd.ste_argmax_onehot

    def half_onehot(h):
        out = real(h)
        rows = out.shape[0] // 2
        return torch.cat([out[:rows] * 2 ** 0.5, torch.zeros_like(out[rows:])])

    gd.ste_argmax_onehot = half_onehot
    try:
        yield
    finally:
        gd.ste_argmax_onehot = real


def cell_for(seed: int, seconds: float, trace: bool = False, control: bool = False,
             tiny: bool = False) -> harness.Cell:
    cell = harness.load_cell(WORKLOAD, seed, seconds, trace, control,
                             device="cpu" if tiny else "cuda")
    if tiny:
        cell.config.update(TINY_CONFIG)
        cell.traffic.update(TINY_TRAFFIC)
    return cell


def reading(seed: int, seconds: float, control: bool = False, fault: str | None = None,
            tiny: bool = False, trace: bool = False) -> dict:
    """One run's result line."""
    cell = cell_for(seed, seconds, trace, control, tiny)
    with planted(fault):
        return harness.run_cell(cell, time.perf_counter())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=FAULTS, default=None)
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = reading(seed, args.seconds, args.control, args.fault, args.tiny)
        print(json.dumps({"seed": seed, "control": args.control, "fault": args.fault,
                          "correct": line["correct"], "metrics": line["metrics"],
                          "checks": line["checks"]}), flush=True)
        if not args.tiny:
            import torch

            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
