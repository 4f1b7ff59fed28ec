#!/usr/bin/env python3
"""The results of the loops a tree of the port runs in chunks, for holding
two trees equal on one card.

    python tools/tree_histories.py [--tree DIR] --out FILE
    python tools/tree_histories.py --compare A.json B.json

``--tree`` is a directory holding a ``gcn_maxcut_tpu_torch`` package (an
older commit unpacked with ``git archive``; the default is this checkout),
imported in place of this checkout's.  On ring of four shards of cuda:0 and
one card it records:

  * ``halo_packed``, ``halo_plain``: the loss histories of
    ``train_halo_giant_packed`` (n = 10,002,432) and ``train_halo_giant``
    (n = 1,048,576), 20 epochs each from their default parameters, in
    chunks of 10, and their epoch ms;
  * ``decode``: the default decode (``eval/decode.refine_multi_start``, 200
    rollouts and the climb from 4 starts) of 6 recipe graphs (n = 500, d in
    [6, 8]) on seeded random probabilities: each graph's refined cut and a
    digest of the assignments;
  * ``sa``: 64 SA chains of 2,000 steps at n = 500, d = 8 on seeded draws
    (``baselines/local_search.simulated_annealing_from_draws``): the best
    cuts and a digest of the assignments.

``--compare`` prints, for each key of two such files, whether the values
are equal (histories and cuts as float32 bit patterns).  Prints the card's
name and power limit first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path


def digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def record() -> dict:
    import torch

    from gcn_maxcut_tpu_torch.baselines.local_search import simulated_annealing_from_draws
    from gcn_maxcut_tpu_torch.data.generate import generate_graph_dataset
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
    from gcn_maxcut_tpu_torch.eval.decode import refine_multi_start
    from gcn_maxcut_tpu_torch.parallel import giant_banded as tgb
    from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh

    out = {}
    ring = make_mesh(devices=["cuda:0"] * 4)
    res = tgb.train_halo_giant_packed(10_002_432 // 4, tgb.PackedHaloGiantConfig(epochs=20),
                                      ring)
    out["halo_packed"] = {"history": res["history"], "epoch_ms": res["epoch_time_s"] * 1e3}
    res = tgb.train_halo_giant(262_144, tgb.HaloGiantConfig(epochs=20), ring)
    out["halo_plain"] = {"history": res["history"], "epoch_ms": res["epoch_time_s"] * 1e3}
    torch.cuda.empty_cache()

    specs, _ = generate_graph_dataset(6, 500, 500, 6, 8, base_seed=6000)
    ds = process_graphs(specs, DataConfig(max_nodes=1000))
    cuts, asns = [], []
    for i, k in enumerate(sorted(ds.graphs)):
        g = ds.graphs[k].to("cuda")
        gen = torch.Generator(device="cuda").manual_seed(i)
        probs = torch.softmax(2 * torch.randn((g.n_pad, 3), generator=gen, device="cuda"), -1)
        asn, cut = refine_multi_start(g, probs, gen, 200, 4)
        cuts.append(float(cut))
        asns.append(asn)
    out["decode"] = {"cuts": cuts, "digest": digest(torch.stack(asns))}

    specs, _ = generate_graph_dataset(1, 500, 500, 8, 8, base_seed=500)
    g = process_graphs(specs, DataConfig(max_nodes=500)).graphs[0].to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.arange(g.n_pad, device="cuda")
    init = torch.where(ids < 3, ids, torch.randint(0, 3, (64, g.n_pad), generator=gen,
                                                   device="cuda"))
    draws = (torch.randint(3, g.n_pad, (64, 2000), generator=gen, device="cuda"),
             torch.randint(0, 3, (64, 2000), generator=gen, device="cuda"),
             torch.rand((64, 2000), generator=gen, device="cuda"))
    asn, cut = simulated_annealing_from_draws(g, init, *draws)
    out["sa"] = {"cuts": [float(c) for c in cut], "digest": digest(asn)}
    return out


def compare(a: dict, b: dict) -> dict:
    import numpy as np

    def bits(v):
        if isinstance(v, dict):
            return {k: bits(x) for k, x in v.items() if k != "epoch_ms"}
        if isinstance(v, list):
            return np.asarray(v, np.float32).view(np.uint32).tolist()
        return v

    return {k: bits(a[k]) == bits(b[k]) for k in a if k in b and k != "tree"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        a, b = (json.loads(Path(p).read_text()) for p in args.compare)
        print(json.dumps(compare(a, b)))
        return 0
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: no output")
    out = {"tree": args.tree, **record()}
    Path(args.out).write_text(json.dumps(out))
    print(json.dumps({k: v.get("epoch_ms") for k, v in out.items() if isinstance(v, dict)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
