#!/usr/bin/env python3
"""Times of the greedy climb on the card, by route: the kernel
(``csrc/climb.cu``, ``ops/climb.greedy_climb``), the captured lockstep
step that the card ran before it, and the plain version.

    python3 tools/climb_times.py [--sizes 50,500] [--starts 4] [--reps 200] [--out FILE]

For each size n, a recipe graph (d-regular, d in [6, 8], padded to 1000
rows as the decode pads) and ``--starts`` seeded random starts with the
terminals pinned:

  * ``kernel_ms``: one launch, CUDA events around ``--reps`` launches;
    ``ms_per_move`` divides it by the most moves a start made (the blocks
    run side by side, so the longest climb bounds the launch);
  * ``route_ms``: ``greedy_flip_local_search`` on the kernel route (the
    launch and the cut), host clock around a synchronised call, median;
  * ``captured_ms``: the same on the captured lockstep route (forced by a
    zero shared-memory limit; captured once before the timed calls),
    median of ``--reps`` // 10;
  * ``plain_ms``: ``ops/climb.greedy_climb_plain`` on the card (each start
    alone, a host read a step), median of 3.

All routes' assignments are held equal.  Prints the card's name and power
limit, then one JSON object (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="50,500")
    ap.add_argument("--starts", type=int, default=4)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out")
    args = ap.parse_args()
    import numpy as np
    import torch

    from gcn_maxcut_tpu_torch.baselines import local_search as tls
    from gcn_maxcut_tpu_torch.data.generate import generate_graph_dataset
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
    from gcn_maxcut_tpu_torch.ops import climb as tclimb

    if not torch.cuda.is_available():
        raise SystemExit("climb_times needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)

    def host_ms(fn, reps):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), out

    result = {"card": card.strip(), "starts": args.starts, "sizes": {}}
    for n in [int(s) for s in args.sizes.split(",")]:
        specs, _ = generate_graph_dataset(1, n, n, 6, 8, base_seed=11 + n)
        g = process_graphs(specs, DataConfig(max_nodes=1000)).graphs[0].to("cuda")
        starts = torch.tensor(np.random.default_rng(n).integers(0, 3, (args.starts, g.n_pad)))
        starts[:, :3] = torch.arange(3)
        starts = starts.cuda()

        asn, moves = tclimb.greedy_climb(g, starts, max_steps=500)    # build, load, warm
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(args.reps):
            tclimb.greedy_climb(g, starts, max_steps=500)
        t1.record()
        torch.cuda.synchronize()
        kernel_ms = t0.elapsed_time(t1) / args.reps
        route_ms, (route_asn, _) = host_ms(
            lambda: tls.greedy_flip_local_search(g, starts, max_steps=500), args.reps)

        limit = tclimb._SMEM_LIMIT
        tclimb._SMEM_LIMIT = 0
        try:
            tls.clear_climbs()
            tls.greedy_flip_local_search(g, starts, max_steps=500)          # the capture
            captured_ms, (captured_asn, _) = host_ms(
                lambda: tls.greedy_flip_local_search(g, starts, max_steps=500),
                max(1, args.reps // 10))
        finally:
            tclimb._SMEM_LIMIT = limit
            tls.clear_climbs()
        plain_ms, (plain_asn, plain_moves) = host_ms(
            lambda: tclimb.greedy_climb_plain(g, starts, 3, 3, 500), 3)

        equal = (torch.equal(asn, route_asn) and torch.equal(asn, captured_asn)
                 and torch.equal(asn, plain_asn) and torch.equal(moves, plain_moves))
        most = int(moves.max())
        result["sizes"][n] = {
            "n_pad": g.n_pad, "moves": moves.tolist(), "kernel_ms": kernel_ms,
            "ms_per_move": kernel_ms / max(1, most), "route_ms": route_ms,
            "captured_ms": captured_ms, "plain_ms": plain_ms, "equal": equal,
        }
        print(f"n={n}: moves {moves.tolist()}, kernel {kernel_ms:.4f} ms "
              f"({kernel_ms / max(1, most) * 1e3:.2f} us a move), kernel route "
              f"{route_ms:.4f} ms, captured {captured_ms:.4f} ms, plain {plain_ms:.2f} ms; "
              f"equal {equal}", flush=True)
    print(json.dumps(result))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0 if all(v["equal"] for v in result["sizes"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
