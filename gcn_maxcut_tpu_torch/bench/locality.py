"""The locality trainer: one large graph with locality, relabeled, trained
and decoded through the block-ELL kernel (K1).

A user brings a graph whose ids hide its locality.  This module runs the
JAX package's functions' counterparts in order:

  1. ``data.reorder.rcm_reorder`` relabels it by reverse Cuthill–McKee;
  2. ``data.process.normalize_terminals`` moves the terminals onto ids 0..2;
  3. ``core.graph.graph_from_edges(block_ell=True)`` plans it;
  4. ``train.loop.train_model`` trains GCNSoftmax on embedding features
     with sparse aggregation, so every aggregation is ``spmm`` on the plan:
     K1 at the hidden width and at the class width, forward and backward
     (4 launches an epoch on a symmetric graph);
  5. ``eval.decode.simple_assignment`` and the hard cut decode it (2 more
     launches for each decode forward).

The graph is the SpMM microbenchmark's banded-random graph
(``bench.microbench.banded_random_edges``) with its ids shuffled by a
seeded permutation and three terminals from ``generate_unique_terminals``;
its widths are those of the k-way sweep's n = 100k configuration
(embedding 128, hidden 64, 3 classes).  Initial parameters come from numpy
(``locality_params``), so that the JAX package can start from the same.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Dict

import numpy as np
import torch

from gcn_maxcut_tpu_torch.bench.microbench import banded_random_edges
from gcn_maxcut_tpu_torch.convert import params_from_jax
from gcn_maxcut_tpu_torch.core.graph import Graph, graph_from_edges, pad_graph_batch, round_up
from gcn_maxcut_tpu_torch.data.generate import GraphSpec, generate_unique_terminals
from gcn_maxcut_tpu_torch.data.process import normalize_terminals
from gcn_maxcut_tpu_torch.data.reorder import rcm_reorder
from gcn_maxcut_tpu_torch.device import resolve_device
from gcn_maxcut_tpu_torch.eval.decode import simple_assignment
from gcn_maxcut_tpu_torch.models.gcn import gcn_softmax_apply
from gcn_maxcut_tpu_torch.objectives.cut_loss import hard_cut_value
from gcn_maxcut_tpu_torch.train.config import TrainingConfig
from gcn_maxcut_tpu_torch.train.loop import _embed_rows, setup_train_state, train_model


def locality_spec(n: int, d: int = 8, locality: int = 255, seed: int = 0) -> GraphSpec:
    """The banded-random graph with shuffled ids and three terminals."""
    edges = banded_random_edges(n, d, locality, seed)
    perm = np.random.default_rng(seed + 1).permutation(n)
    edges = perm[edges]
    return GraphSpec(
        n_nodes=n, edges=edges,
        terminals=generate_unique_terminals(n, 3, seed=seed + 2), degree=d,
    )


def locality_graph(spec: GraphSpec, n_pad: int | None = None) -> tuple[Graph, int]:
    """RCM relabel, terminals onto 0..2, plan; returns (graph, bandwidth)."""
    reordered, bandwidth = rcm_reorder(spec)
    spec = normalize_terminals(reordered)
    n_pad = n_pad if n_pad is not None else round_up(spec.n_nodes, 2048)
    g = graph_from_edges(spec.edges, spec.n_nodes, n_pad=n_pad, block_ell=True)
    return g, bandwidth


def graph_digest(senders: np.ndarray, receivers: np.ndarray) -> str:
    """First 16 hex digits of the SHA-256 of a graph's padded (senders,
    receivers) as int64: names the graph a run trained on.  SciPy versions
    differ in their RCM, so two machines can relabel one spec differently."""
    h = hashlib.sha256()
    for a in (senders, receivers):
        h.update(np.ascontiguousarray(np.asarray(a), dtype=np.int64).tobytes())
    return h.hexdigest()[:16]


def locality_params(
    n: int, dim: int = 128, hidden: int = 64, classes: int = 3, seed: int = 0
) -> Dict[str, Any]:
    """Initial parameters in the JAX layout as numpy arrays: Glorot-uniform
    weights, zero biases, an N(0, 1) embedding table."""
    rng = np.random.default_rng(seed)

    def glorot(fan_in, fan_out):
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-limit, limit, (fan_in, fan_out)).astype(np.float32)

    return {
        "conv1": {"w": glorot(dim, hidden), "b": np.zeros(hidden, np.float32)},
        "conv2": {"w": glorot(hidden, classes), "b": np.zeros(classes, np.float32)},
        "embed": rng.standard_normal((n, dim)).astype(np.float32),
    }


def decode_cut(params: Dict[str, Any], g: Graph) -> tuple[torch.Tensor, float]:
    """Argmax decode with pinned terminals; (assignment, hard cut)."""
    with torch.no_grad():
        probs = gcn_softmax_apply(params, g, _embed_rows(params["embed"], g.n_pad))
        assignment = simple_assignment(probs)
        return assignment, float(hard_cut_value(g, assignment))


def train_locality(
    n: int = 100_000,
    d: int = 8,
    locality: int = 255,
    epochs: int = 200,
    patience: int = 20,
    learning_rate: float = 1e-3,
    dim: int = 128,
    hidden: int = 64,
    classes: int = 3,
    seed: int = 0,
    params: Dict[str, Any] | None = None,
    device: str | torch.device | None = None,
) -> Dict[str, Any]:
    """Build, train and decode the locality trainer's graph.  ``params``:
    initial parameters in the JAX layout (default ``locality_params``)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    g, bandwidth = locality_graph(locality_spec(n, d, locality, seed))
    if g.bell_block is None:
        raise RuntimeError("the locality graph did not plan")
    build_s = time.perf_counter() - t0

    config = TrainingConfig(
        n_nodes=n, dim_embedding=dim, hidden_dim=hidden, number_classes=classes,
        learning_rate=learning_rate, number_epochs=epochs, patience=patience,
        dropout=0.0, feature_mode="embedding", aggregation="sparse", seed=seed,
    )
    start = params_from_jax(params or locality_params(n, dim, hidden, classes, seed), dev)
    state = setup_train_state(config, params=start, device=dev)
    gd = g.to(dev)
    _, initial_cut = decode_cut(start, gd)

    t0 = time.perf_counter()
    best, best_loss, final_epoch, _, history = train_model(
        pad_graph_batch([g]), config, state=state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    training_s = time.perf_counter() - t0
    assignment, cut = decode_cut(best, gd)
    edges = int(g.n_edges) // 2
    return {
        "n": n, "n_pad": g.n_pad, "d": d, "edges": edges, "rcm_bandwidth": bandwidth,
        "graph_digest": graph_digest(g.senders.numpy(), g.receivers.numpy()),
        "bell_block": g.bell_block, "bell_wp": g.bell_wp,
        "bell_width": int(g.bell_senders.shape[1]),
        "n_outliers": int(g.bell_out_mask.sum()),
        "build_s": build_s, "training_s": training_s,
        "epochs_run": final_epoch + 1,
        "epoch_ms": training_s / (final_epoch + 1) * 1e3,
        "history": history, "best_loss": best_loss,
        "initial_cut": initial_cut, "final_cut": cut, "cut_fraction": cut / edges,
        "assignment": assignment.cpu().numpy(),
    }
