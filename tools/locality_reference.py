#!/usr/bin/env python3
"""The JAX package's run of the locality trainer, for the port to be held to.

    JAX_PLATFORMS=cpu python tools/locality_reference.py [--n 100000] [--epochs 200]
        [--perm chiprun_out/locality_rcm_perm.npy]

Builds the locality trainer's graph with the JAX package's own functions
(``rcm_reorder``, ``normalize_terminals``, ``graph_from_edges(block_ell=
True)``) from the edge list and terminals of
``gcn_maxcut_tpu_torch.bench.locality.locality_spec``.  SciPy versions
differ in their RCM, so ``--perm`` takes the relabeling another machine
computed (``chip_smoke.py`` saves the card machine's as
``chiprun_out/locality_rcm_perm.npy``) in place of this machine's; the
printed ``graph_digest`` names the graph.  It starts from the same
numpy parameters (``locality_params``), trains with the JAX ``train_model``
(embedding features, sparse aggregation, lr 1e-3, patience 20, no dropout)
and decodes with ``simple_assignment`` and the hard cut.  At the widths 64
and 3 the JAX block-ELL path runs its exact XLA fallback, so this runs on a
CPU.  Prints one JSON object; ``chip_smoke.py`` holds the port's cut on the
card to the ``final_cut`` printed here at the defaults with the card's
``--perm``, and fails unless the card trained on the graph of the
``graph_digest`` printed here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from unittest import mock

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gcn_maxcut_tpu import train as jtrain  # noqa: E402
from gcn_maxcut_tpu.core.graph import graph_from_edges, pad_graph_batch, round_up  # noqa: E402
from gcn_maxcut_tpu.data import reorder as jreorder  # noqa: E402
from gcn_maxcut_tpu.data.generate import GraphSpec  # noqa: E402
from gcn_maxcut_tpu.data.process import normalize_terminals  # noqa: E402
from gcn_maxcut_tpu.eval.decode import simple_assignment  # noqa: E402
from gcn_maxcut_tpu.models.gcn import gcn_softmax_apply  # noqa: E402
from gcn_maxcut_tpu.objectives.cut_loss import hard_cut_value  # noqa: E402
from gcn_maxcut_tpu_torch.bench.locality import (  # noqa: E402
    graph_digest,
    locality_params,
    locality_spec,
)


def jax_locality_graph(n: int, d: int = 8, locality: int = 255, seed: int = 0,
                       perm: np.ndarray | None = None):
    """The JAX package's locality graph; ``perm``: the RCM relabeling to
    use instead of this machine's SciPy's (old id ``i`` becomes ``perm[i]``)."""
    spec_t = locality_spec(n, d, locality, seed)
    spec = GraphSpec(n_nodes=n, edges=spec_t.edges, terminals=spec_t.terminals, degree=d)
    if perm is None:
        reordered, bandwidth = jreorder.rcm_reorder(spec)
    else:
        with mock.patch.object(jreorder, "rcm_permutation", lambda edges, n_nodes: perm):
            reordered, bandwidth = jreorder.rcm_reorder(spec)
    spec = normalize_terminals(reordered)
    g = graph_from_edges(spec.edges, n, n_pad=round_up(n, 2048), block_ell=True)
    return g, bandwidth


def jax_config(n: int, epochs: int, patience: int = 20, seed: int = 0):
    return jtrain.TrainingConfig(
        n_nodes=n, dim_embedding=128, hidden_dim=64, number_classes=3,
        learning_rate=1e-3, number_epochs=epochs, patience=patience, dropout=0.0,
        feature_mode="embedding", aggregation="sparse", seed=seed,
    )


def jax_state(config, params_np):
    state = jtrain.setup_train_state(config)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    return jtrain.TrainState(params, state.optimizer.init(params), config, state.optimizer)


def jax_decode_cut(params, g) -> float:
    embed = params["embed"]
    x = jnp.pad(embed, ((0, g.n_pad - embed.shape[0]), (0, 0)))
    probs = gcn_softmax_apply({"conv1": params["conv1"], "conv2": params["conv2"]}, g, x)
    return float(hard_cut_value(g, simple_assignment(probs)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--perm", type=Path, default=None,
                    help="an .npy RCM relabeling to use instead of this machine's")
    args = ap.parse_args()
    t0 = time.perf_counter()
    perm = None if args.perm is None else np.load(args.perm)
    g, bandwidth = jax_locality_graph(args.n, perm=perm)
    config = jax_config(args.n, args.epochs)
    params_np = locality_params(args.n)
    state = jax_state(config, params_np)
    initial = jax_decode_cut(state.params, g)
    best, best_loss, final_epoch, _, history = jtrain.train_model(
        pad_graph_batch([g]), config, state=state)
    final = jax_decode_cut(best, g)
    edges = int(g.n_edges) // 2
    print(json.dumps({
        "n": args.n, "n_pad": g.n_pad, "rcm_bandwidth": bandwidth,
        "perm": None if args.perm is None else str(args.perm),
        "graph_digest": graph_digest(np.asarray(g.senders), np.asarray(g.receivers)),
        "bell_block": g.bell_block, "bell_wp": g.bell_wp,
        "n_outliers": int(np.asarray(g.bell_out_mask).sum()),
        "epochs_run": final_epoch + 1, "best_loss": best_loss,
        "initial_cut": initial, "final_cut": final, "cut_fraction": final / edges,
        "history_head": history[:5], "history_tail": history[-5:],
        "seconds": time.perf_counter() - t0, "backend": jax.default_backend(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
