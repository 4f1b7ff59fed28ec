#!/usr/bin/env python3
"""The eager training epochs of a tree of the port, for comparing two trees
on one card in one call.

    python tools/eager_epochs.py [--tree DIR] [--label NAME] [--epochs 30]

``--tree`` is a directory holding a ``gcn_maxcut_tpu_torch`` package (an
older commit unpacked with ``git archive``; the default is this checkout),
imported in place of this checkout's.  On the reference recipe's data (20
graphs of n = 500, d in [6, 8], padded to 1000, GCNSoftmax 1000-500-3):

  * ``bench_train``: ``bench/microbench.bench_train_epoch``, the epoch
    ``bench --what train`` reports (per-graph Adam steps, no early-stopping
    bookkeeping; CUDA events, best of three rounds of ten epochs);
  * ``dp``: the data-parallel epoch (``parallel/data_parallel.py``) on a
    data mesh of 4 entries of one card, each epoch ending in its loss's
    host read; host clock over ``--epochs`` epochs after 3 warm-up epochs;
  * ``train_model``: ``train/loop.train_model``'s epoch, its chunks run
    eagerly (``ChunkRunner(capture=False)`` where the tree has chunks, K =
    10), timed on the host clock between the callbacks of epoch 10 and of
    epoch 10 + ``--epochs`` (patience off);
  * ``train_model_captured``: the same with the tree's default, a captured
    chunk of 10 (only where the tree has chunks).

With ``--old-optim NAME=FILE`` (repeatable; an older ``train/optim.py``,
whose ``Adam`` has the same ``step(grads)``), one process also times, in
turns over ``--rounds`` rounds of 10 epochs each (host clock, a
synchronize at each round's end; the order reversed every other round;
each variant's best and median round, and its median difference from the
same round of the first older ``Adam`` (``monitored``: of ``run_epoch``
with this tree's), with the rounds it was faster),
the same epochs with
this tree's ``Adam`` ("new") and each older one: ``run_epoch``
(``bench_train``'s epoch), ``dp`` (the DP epoch) and, with this tree's
``Adam`` only, ``monitored`` (``train_model``'s epoch with the
early-stopping state on the device, a ``ChunkRunner(capture=False)`` chunk
of 10).  One process and turns take the host's drift out of the
comparison of the optimizers.

Prints the card's name and power limit, then one JSON object.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ap = argparse.ArgumentParser()
ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
ap.add_argument("--label", default="this tree")
ap.add_argument("--epochs", type=int, default=30)
ap.add_argument("--old-optim", action="append", default=[])
ap.add_argument("--rounds", type=int, default=7)
args = ap.parse_args()
sys.path.insert(0, str(Path(args.tree).resolve()))

import torch  # noqa: E402

import gcn_maxcut_tpu_torch  # noqa: E402
from gcn_maxcut_tpu_torch.bench.microbench import bench_train_epoch  # noqa: E402
from gcn_maxcut_tpu_torch.core.graph import pad_graph_batch  # noqa: E402
from gcn_maxcut_tpu_torch.data.generate import generate_graph_dataset  # noqa: E402
from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs  # noqa: E402
from gcn_maxcut_tpu_torch.parallel import data_parallel as tdp  # noqa: E402
from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from gcn_maxcut_tpu_torch.train import loop as tloop  # noqa: E402
from gcn_maxcut_tpu_torch.train.config import TrainingConfig  # noqa: E402


def recipe_batch():
    specs, _ = generate_graph_dataset(20, 500, 500, 6, 8, base_seed=1000)
    ds = process_graphs(specs, DataConfig(max_nodes=1000))
    return pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])


def dp_ms(batch, epochs: int) -> float:
    cfg = TrainingConfig(n_nodes=1000, learning_rate=1e-3, seed=1000)
    mesh = make_mesh(("data",), devices=["cuda:0"] * 4)
    state = tloop.setup_train_state(cfg, device="cuda")
    fn = tdp.make_dp_epoch_fn(cfg, state.optimizer, mesh)
    shards = tdp.shard_batch_for_dp(batch, mesh)
    for _ in range(3):
        fn(state, shards)
    t0 = time.perf_counter()
    for _ in range(epochs):
        fn(state, shards)           # returns the loss as a float: a host read
    return (time.perf_counter() - t0) * 1e3 / epochs


def train_model_ms(batch, epochs: int, capture: bool | None) -> float:
    cfg = TrainingConfig(n_nodes=1000, learning_rate=1e-3, seed=1000, patience=10**9,
                         number_epochs=10 + epochs, epochs_per_call=10)
    stamps = []
    orig = getattr(tloop, "ChunkRunner", None)
    if orig is not None and capture is False:
        tloop.ChunkRunner = functools.partial(orig, capture=False)
    try:
        tloop.train_model(batch, cfg, device="cuda",
                          callback=lambda e, loss: stamps.append(time.perf_counter()))
    finally:
        if orig is not None:
            tloop.ChunkRunner = orig
    return (stamps[9 + epochs] - stamps[9]) * 1e3 / epochs


def in_turns(batch, old_optims: list, rounds: int) -> dict:
    """The epochs of ``run_epoch``, ``dp`` and ``monitored`` with this
    tree's ``Adam`` and each ``NAME=FILE`` of ``old_optims``, in turns; ms
    an epoch of the best round of each."""
    import importlib.util

    adams = {"new": None}
    for arg in old_optims:
        name, path = arg.split("=", 1)
        spec = importlib.util.spec_from_file_location(f"optim_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        adams[name] = mod.Adam
    cfg = TrainingConfig(n_nodes=1000, learning_rate=1e-3, seed=1000, patience=10**9)
    start = tloop.setup_train_state(cfg, 20, device="cpu").params()
    inputs = tloop.epoch_inputs(batch.to("cuda"), cfg)
    mesh = make_mesh(("data",), devices=["cuda:0"] * 4)
    shards = tdp.shard_batch_for_dp(batch, mesh)

    def state(adam):
        st = tloop.setup_train_state(cfg, 20, params=start, device="cuda")
        if adam is not None:
            st.optimizer = adam(st.optimizer.params, cfg.learning_rate)
        return st

    def run_epoch(adam):
        st, gen = state(adam), torch.Generator(device="cuda").manual_seed(1)
        return lambda: [tloop._run_epoch(st, inputs, gen) for _ in range(10)]

    def dp(adam):
        st = state(adam)
        fn = tdp.make_dp_epoch_fn(cfg, st.optimizer, mesh)
        return lambda: [fn(st, shards) for _ in range(10)]

    def monitored():
        st, gen = state(None), torch.Generator(device="cuda").manual_seed(1)
        es = tloop.init_early_stop_state(st.params())
        runner = tloop.ChunkRunner(tloop.make_monitored_epoch_fn(st, inputs, es, gen),
                                   ["cuda"], 10, capture=False)
        return lambda: runner.run(10)

    fns = {}
    for name, adam in adams.items():
        fns[f"run_epoch/{name}"] = run_epoch(adam)
        fns[f"dp/{name}"] = dp(adam)
    fns["monitored/new"] = monitored()
    ms = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3 / 10)
    out = {name: {"best": min(v), "median": statistics.median(v)} for name, v in ms.items()}
    ref = next((n for n in adams if n != "new"), None)
    pairs = {f"{k}/{a}": f"{k}/{ref}" for k, a in (n.split("/") for n in fns)
             if ref is not None and a != ref and k != "monitored"}
    pairs["monitored/new"] = "run_epoch/new"
    for name, base in pairs.items():    # paired with the same round of the reference
        v, b = ms[name], ms[base]
        out[name][f"median_minus_{base}"] = statistics.median(x - y for x, y in zip(v, b))
        out[name][f"rounds_faster_than_{base}"] = sum(x < y for x, y in zip(v, b))
    out["rounds"] = rounds
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: no output")
    batch = recipe_batch()
    out = {"label": args.label, "package": str(Path(gcn_maxcut_tpu_torch.__file__).parent),
           "bench_train_ms": bench_train_epoch(device="cuda")["epoch_time_s"] * 1e3,
           "dp_ms": dp_ms(batch, args.epochs),
           "train_model_eager_ms": train_model_ms(batch, args.epochs, False)}
    if hasattr(tloop, "ChunkRunner"):
        out["train_model_captured_ms"] = train_model_ms(batch, args.epochs, None)
    if args.old_optim:
        out["in_turns_ms"] = in_turns(batch, args.old_optim, args.rounds)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
