#!/usr/bin/env python3
"""Times of the loops that run as lockstep steps (the default decode's
climb and the anytime solver's SA chains) for one tree of the port on one
device, for comparing two trees on the same host and card.

    python tools/loop_times.py [--tree DIR] [--device cpu|cuda] [--rounds 3] [--out FILE]

``--tree`` is a directory holding a ``gcn_maxcut_tpu_torch`` package (an
older commit unpacked with ``git archive``; the default is this checkout),
imported in place of this checkout's.  On ``--device`` it times, on a host
clock with the device synchronised around each call, the first call (which
on the card builds and captures) and the best of ``--rounds`` later ones:

  * ``decode``: the default decode (``eval/decode.refine_multi_start``,
    200 rollouts and the climb from the best 4) of 6 recipe graphs (n =
    500, d in [6, 8], padded to 1000) on seeded random probabilities, ms a
    graph over the 6;
  * ``sa_climb``: ``baselines/exact._sa_restart_batch_from_draws`` at the
    solvers phase's shape (n = 100, d = 6, R = 8 chains of 2,000 steps,
    then their climb), seconds a call;
  * ``solve``: ``baselines/exact.anytime_solver`` at ``solve --n 100``'s
    graph (d = 8, seed 0) limited to one batch of R = 8 chains of its
    default 20,000 steps and their climb, seconds a call.

Each entry also holds a digest of its results, so two trees' outputs can
be held equal.  Prints the card's name and power limit (on the card), then
one JSON object.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path


def digest(ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    from gcn_maxcut_tpu_torch.baselines.exact import (
        _sa_restart_batch_from_draws,
        anytime_solver,
    )
    from gcn_maxcut_tpu_torch.data.generate import generate_graph, generate_graph_dataset
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
    from gcn_maxcut_tpu_torch.eval.decode import refine_multi_start

    dev = torch.device(args.device)
    card = None
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip().splitlines()[0]
        print(card)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def entry(fn, per: int = 1, scale: float = 1.0) -> dict:
        out, first = timed(fn)
        times = [timed(fn)[1] for _ in range(args.rounds)]
        return {"first": first * scale / per, "best": min(times) * scale / per,
                "runs": [t * scale / per for t in times], "out": out}

    specs, _ = generate_graph_dataset(6, 500, 500, 6, 8, base_seed=6000)
    ds = process_graphs(specs, DataConfig(max_nodes=1000))
    graphs = [ds.graphs[k].to(dev) for k in sorted(ds.graphs)]
    probs = []
    for i, g in enumerate(graphs):
        gen = torch.Generator(device=dev).manual_seed(i)
        probs.append(torch.softmax(2 * torch.randn((g.n_pad, 3), generator=gen, device=dev), -1))

    def decode_all():
        res = []
        for i, (g, p) in enumerate(zip(graphs, probs)):
            gen = torch.Generator(device=dev).manual_seed(i)
            res.append(refine_multi_start(g, p, gen, 200, 4))
        return digest([a for a, _ in res] + [c.reshape(1) for _, c in res])

    specs, _ = generate_graph_dataset(1, 100, 100, 6, 6, base_seed=100)
    g100 = process_graphs(specs, DataConfig(max_nodes=100)).graphs[0]
    gen = torch.Generator().manual_seed(0)
    draws = [t.to(dev) for t in (torch.randint(0, 3, (8, g100.n_pad), generator=gen),
                                 torch.randint(3, g100.n_pad, (8, 2000), generator=gen),
                                 torch.randint(0, 3, (8, 2000), generator=gen),
                                 torch.rand((8, 2000), generator=gen))]
    g100 = g100.to(dev)

    def sa_climb():
        asn, cut = _sa_restart_batch_from_draws(g100, *draws, 3, 3)
        return digest([asn, cut.reshape(1)])

    spec = generate_graph(n=100, d=8, graph_type="reg", seed=0)
    gs = process_graphs([spec], DataConfig(max_nodes=100)).graphs[0].to(dev)

    def solve():
        res = anytime_solver(gs, k=3, time_limit=1e9, seed=0, batch_restarts=8,
                             solution_limit=8)
        return f"{res['cut_value']}:{res['restarts']}"

    out = {"tree": args.tree, "device": str(dev), "card": card,
           "decode_ms_per_graph": entry(decode_all, per=len(graphs), scale=1e3),
           "sa_climb_s": entry(sa_climb),
           "solve_s": entry(solve)}
    line = json.dumps(out)
    if args.out:
        Path(args.out).write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
