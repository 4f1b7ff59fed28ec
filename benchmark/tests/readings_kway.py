"""Readings for the limits of the k-way cell's checks (``kway-100k-ring``).

As ``readings.py`` does for the other cells: runs the cell once a seed in
one process and prints each run's result line with its seed, with the
program as it is (the sound readings), with the control in the program's
place (``--control``: the reference in TF32), or with a fault planted in
the program (``--fault``).  On the card at the cell's own size:

    python3 benchmark/tests/readings_kway.py --seeds 1,2,3 --seconds 2

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

WORKLOAD = "kway-100k-ring"
FAULTS = ("unchanged", "half_batch", "terminal_moved")

# CPU sizes of the tests: every width small, every path the same
TINY_CONFIG = {"nodes": 512, "embedding": 16, "hidden": 8}
TINY_TRAFFIC = {"epochs_per_job": 10, "epochs_per_call": 5, "trace_jobs": 2}


@contextlib.contextmanager
def planted(fault: str | None):
    """The sharded trainer with ``fault`` planted:

    * ``unchanged``: Adam's step leaves the state as it was
      (``readings.planted``);
    * ``half_batch``: the loss counts the edges into the first half of
      each shard's rows only and scales them to the whole;
    * ``terminal_moved``: the decoded assignment has terminal 0 in class 1,
      where it is produced."""
    if fault in (None, "unchanged"):
        with readings.planted(fault):
            yield
        return
    import torch

    import gcn_maxcut_tpu_torch.parallel.giant as pg
    from gcn_maxcut_tpu_torch.parallel.spmm import sharded_spmm_sym

    def half_cut(sg, ss, mesh, schedule="ring"):
        dev0 = mesh.devices[0]
        total_w = sum(torch.sum(w * m).to(dev0) for w, m in zip(sg.weights, sg.edge_mask))
        a_s = sharded_spmm_sym(sg, ss, mesh, schedule)
        same = sum(torch.sum((s * a)[: s.shape[0] // 2]).to(dev0) for s, a in zip(ss, a_s))
        return (total_w - 2 * same) / 2.0

    def moved(*args, **kw):
        out = real["decode"](*args, **kw).copy()
        out[0, 0] = 1
        return out

    real = {"cut": pg.sharded_cut_edgeform, "decode": pg.decode_assignment}
    if fault == "half_batch":
        pg.sharded_cut_edgeform = half_cut
    elif fault == "terminal_moved":
        pg.decode_assignment = moved
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    try:
        yield
    finally:
        pg.sharded_cut_edgeform, pg.decode_assignment = real["cut"], real["decode"]


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
