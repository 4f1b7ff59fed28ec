"""Readings for the limits of a cell's checks.

Runs a cell once a seed in one process and prints each run's result line
with its seed: the program as it is (the sound readings), with the
control in the program's place (``--control``: the reference in TF32,
or the giant trainer's own bfloat16 activations), or with a fault
planted in the program (``--fault``).  On the card at the cells' own
sizes:

    python3 benchmark/tests/readings.py --workload recipe-train --seeds 1,2,3 --seconds 2

``--tiny`` runs on the CPU at the tests' sizes instead.  No benchmark
run uses this script.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402

FAULTS = ("unchanged", "half_batch", "answer_altered", "rollout_permuted")

# CPU sizes of the tests: every width small, every path the same
TINY_CONFIG = {
    "recipe-n500": {"in_features": 64, "hidden": 32, "nodes": 40, "pad_to": 64},
    "giant-packed-10m": {"nodes": 4096, "bandwidth": 15},
}
TINY_TRAFFIC = {
    "train-loop": {"train_graphs": 4, "trace_epochs": 5},
    "giant-jobs": {"epochs_per_job": 20, "epochs_per_call": 5, "job_graphs": 3},
    "heldout-decode": {"train_graphs": 4, "train_epochs": 20, "sizes": [20, 30],
                       "graphs_per_size": 3, "checked_answers": 4, "trace_graphs": 6},
}


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with ``fault`` planted:

    * ``unchanged``: Adam's step leaves the state as it was;
    * ``half_batch``: the recipe's epoch steps on the first half of its
      graphs and doubles their loss; the giant's loss leaves out the second
      half of the nodes and scales the rest to the whole;
    * ``answer_altered``: the refine's assignment has one node's class
      changed where it is produced, its cut counted after the change;
    * ``rollout_permuted``: the rollouts sample each node from the next
      node's probabilities (the probability matrix rolled by one row)."""
    if fault is None:
        yield
        return
    import torch

    import gcn_maxcut_tpu_torch.bench.giant_demo as gd
    import gcn_maxcut_tpu_torch.eval.decode as pd
    import gcn_maxcut_tpu_torch.eval.harness as ph
    import gcn_maxcut_tpu_torch.train.loop as loop
    import gcn_maxcut_tpu_torch.train.optim as optim
    from gcn_maxcut_tpu_torch.objectives.cut_loss import hard_cut_value

    def half_epoch(state, inputs, generator):
        h = len(inputs.graphs) // 2
        part = dataclasses.replace(
            inputs, graphs=inputs.graphs[:h],
            a_mask=None if inputs.a_mask is None else inputs.a_mask[:h],
            a_feat=None if inputs.a_feat is None else inputs.a_feat[:h])
        return 2 * real["run_epoch"](state, part, generator)

    def half_onehot(pinned, class_ok):
        out = real["onehot"](pinned, class_ok)
        rows = out.shape[0] // 2
        return torch.cat([out[:rows] * 2 ** 0.5, torch.zeros_like(out[rows:])])

    def altered(g, probs, u, *args, **kw):
        asn, _ = real["refine"](g, probs, u, *args, **kw)
        asn = asn.clone()
        i = int(g.n_nodes) // 2
        asn[i] = (asn[i] + 1) % probs.shape[1]
        return asn, hard_cut_value(g, asn)

    def permuted(probs, u, *args, **kw):
        return real["sample"](torch.roll(probs, 1, dims=0), u, *args, **kw)

    real = {"step": optim.Adam.step, "run_epoch": loop._run_epoch,
            "onehot": gd.group_onehot, "refine": ph.refine_multi_start_from_uniforms,
            "sample": pd.sample_partitions_from_uniforms}
    if fault == "unchanged":
        optim.Adam.step = lambda self, grads: None
    elif fault == "half_batch":
        loop._run_epoch, gd.group_onehot = half_epoch, half_onehot
    elif fault == "answer_altered":
        ph.refine_multi_start_from_uniforms = altered
    elif fault == "rollout_permuted":
        ph.sample_partitions_from_uniforms = pd.sample_partitions_from_uniforms = permuted
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    try:
        yield
    finally:
        optim.Adam.step, loop._run_epoch = real["step"], real["run_epoch"]
        gd.group_onehot, ph.refine_multi_start_from_uniforms = real["onehot"], real["refine"]
        ph.sample_partitions_from_uniforms = pd.sample_partitions_from_uniforms = real["sample"]


def cell_for(workload: str, seed: int, seconds: float, trace: bool = False,
             control: bool = False, tiny: bool = False) -> harness.Cell:
    cell = harness.load_cell(workload, seed, seconds, trace, control,
                             device="cpu" if tiny else "cuda")
    if tiny:
        cell.config.update(TINY_CONFIG[cell.config_name])
        cell.traffic.update(TINY_TRAFFIC[cell.traffic_name])
    return cell


def reading(workload: str, seed: int, seconds: float, control: bool = False,
            fault: str | None = None, tiny: bool = False, trace: bool = False) -> dict:
    """One run's result line."""
    cell = cell_for(workload, seed, seconds, trace, control, tiny)
    with planted(fault):
        return harness.run_cell(cell, time.perf_counter())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=FAULTS, default=None)
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = reading(args.workload, seed, args.seconds, args.control, args.fault, args.tiny)
        print(json.dumps({"seed": seed, "control": args.control, "fault": args.fault,
                          "correct": line["correct"], "metrics": line["metrics"],
                          "checks": line["checks"]}), flush=True)
        if not args.tiny:
            import torch

            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
