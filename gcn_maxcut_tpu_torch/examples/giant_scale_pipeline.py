"""At-scale workflow: giant-graph training, refinement, a classical anchor
(port of ``examples/giant_scale_pipeline.py``).

  1. build a semi-local graph and check a 4-way multilevel (METIS-style)
     partition of it;
  2. train the node-sharded GCN on a ring of 4 shards (``train_giant_graph``;
     on one card a virtual ring of ``device`` four times);
  3. decode an assignment and refine it with the native sweep search;
  4. anchor it against the same sweep from a random start, the at-scale
     ablation of PARITY §4-5.

    python -m gcn_maxcut_tpu_torch.examples.giant_scale_pipeline [--n 20000] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

N = 20_000
D_REG = 8
K = 3
SEED = 0
SHARDS = 4


def build_graph(n: int = N):
    """Banded neighbours with 2% random rewires: the class where
    locality-aware partitions pay.  Returns the directed COO (both
    directions)."""
    rng = np.random.default_rng(SEED)
    offs = rng.choice(np.arange(1, 257), D_REG // 2, replace=False)
    s = np.concatenate([np.arange(n)] * (D_REG // 2))
    r = np.concatenate([(np.arange(n) + o) % n for o in offs])
    rewire = rng.random(r.shape[0]) < 0.02
    r = np.where(rewire, rng.integers(0, n, r.shape[0]), r)
    keep = s != r
    s, r = s[keep], r[keep]
    return np.concatenate([s, r]), np.concatenate([r, s])


def main(N: int = N, device: str | torch.device | None = None) -> int:  # noqa: N803
    from gcn_maxcut_tpu_torch.baselines.sweep import greedy_sweep_maxcut
    from gcn_maxcut_tpu_torch.device import resolve_device
    from gcn_maxcut_tpu_torch.parallel import make_mesh, partition_nodes_metis, partition_quality
    from gcn_maxcut_tpu_torch.parallel.giant import GiantConfig, train_giant_graph

    dev = resolve_device(device)
    senders, receivers = build_graph(N)
    e_und = senders.shape[0] // 2

    # 1. what the ring will pay
    owner = partition_nodes_metis(senders, receivers, N, SHARDS)
    q = partition_quality(owner, senders, receivers)
    print(f"metis {SHARDS}-way partition: {100 * q['cross_shard_edge_fraction']:.2f}% "
          f"cross-shard edges, imbalance {q['imbalance']:.3f}")

    # 2. sharded training
    cfg = GiantConfig(num_classes=K, dim_embedding=64, hidden_dim=32, number_epochs=40,
                      log_every=10, seed=SEED, block_ell=False, local_reorder="off")
    out = train_giant_graph(senders, receivers, N, cfg,
                            mesh=make_mesh(devices=[dev] * SHARDS), return_assignment=True)
    print(f"GCN cut after {out['epochs']} epochs: {out['final_cut']:.0f}/{e_und} "
          f"({100 * out['final_cut'] / e_und:.1f}%)")

    # 3. refine the decode with the sweep
    edges = np.stack([senders[:e_und], receivers[:e_und]], axis=1)
    asn = np.asarray(out["assignment"], np.int64)
    _, refined_cut, sweeps = greedy_sweep_maxcut(edges, N, asn, k=K)
    print(f"GCN + sweep refine: {refined_cut:.0f} ({100 * refined_cut / e_und:.1f}%) "
          f"in {sweeps} sweeps")

    # 4. the classical anchor: the same sweep from a random start
    rng = np.random.default_rng(123)
    rand_init = rng.integers(0, K, N)
    rand_init[:K] = np.arange(K)
    _, rand_cut, rsweeps = greedy_sweep_maxcut(edges, N, rand_init, k=K)
    print(f"random-init sweep baseline: {rand_cut:.0f} ({100 * rand_cut / e_und:.1f}%) "
          f"in {rsweeps} sweeps")
    print(f"GCN warm-start margin: {refined_cut - rand_cut:+.0f} edges")
    return 0


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--device", default=None, help="default: the CUDA device")
    a = p.parse_args()
    raise SystemExit(main(a.n, a.device))
