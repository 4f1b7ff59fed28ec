"""Terminal normalisation and padded `Graph` dataset assembly.

Port of ``gcn_maxcut_tpu/data/process.py``: each graph's terminals move
onto node ids ``[0, 1, 2]`` by a node-id permutation, and every graph is
padded to the dataset's shared ``(n_pad, e_pad)`` and ELL width.  Graphs
stay on the CPU; the training loop moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from gcn_maxcut_tpu_torch.core.graph import (
    ELL_MAX_DEGREE,
    Graph,
    graph_from_edges,
    round_up,
)
from gcn_maxcut_tpu_torch.data.generate import GraphSpec


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Processing parameters."""

    max_nodes: int = 1000          # feature width / padding target
    num_terminals: int = 3
    node_pad_multiple: int = 8
    edge_pad_multiple: int = 128


def terminal_permutation(n: int, terminals: Sequence[int]) -> np.ndarray:
    """Permutation p of node ids with p[terminals[k]] = k for all k, built
    from transpositions (t_k <-> k) so every collision pattern works."""
    perm = np.arange(n, dtype=np.int64)
    for k, t in enumerate(terminals):
        cur = int(np.nonzero(perm == t)[0][0])
        perm[[k, cur]] = perm[[cur, k]]
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)
    return inv


def normalize_terminals(spec: GraphSpec) -> GraphSpec:
    """Relabel nodes so terminals become ``[0..t-1]`` (order-preserving);
    edges come back as sorted (lo, hi) pairs."""
    t = len(spec.terminals)
    if list(spec.terminals) == list(range(t)):
        return spec
    p = terminal_permutation(spec.n_nodes, spec.terminals)
    edges = p[spec.edges]
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    edges = np.stack([lo, hi], axis=1)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    weights = None if spec.weights is None else spec.weights[order]
    return GraphSpec(
        n_nodes=spec.n_nodes,
        edges=edges[order],
        terminals=list(range(t)),
        degree=spec.degree,
        weights=weights,
    )


@dataclasses.dataclass
class ProcessedDataset:
    """Equally padded graphs + the host specs they came from."""

    graphs: Dict[int, Graph]
    specs: Dict[int, GraphSpec]
    config: DataConfig
    skipped: int = 0

    def __len__(self) -> int:
        return len(self.graphs)


def process_graphs(
    specs: Dict[int, GraphSpec] | List[GraphSpec],
    config: DataConfig = DataConfig(),
) -> ProcessedDataset:
    """Normalize terminals and tensorize every graph to shared padding: rows
    pad to the largest graph (the ``max_nodes``-wide features are built
    later), edges to the largest edge count, ELL to the largest degree."""
    if isinstance(specs, list):
        specs = dict(enumerate(specs))
    normed = {i: normalize_terminals(s) for i, s in specs.items()}
    if not normed:
        return ProcessedDataset(graphs={}, specs={}, config=config)
    n_pad = round_up(
        max(s.n_nodes for s in normed.values()), config.node_pad_multiple
    )
    e_pad = round_up(
        max(2 * s.n_edges for s in normed.values()), config.edge_pad_multiple
    )
    max_deg = max(
        (
            int(np.bincount(s.edges.ravel(), minlength=s.n_nodes).max())
            for s in normed.values()
            if s.n_edges
        ),
        default=0,
    )
    ell_width = max_deg if 0 < max_deg <= ELL_MAX_DEGREE else 0
    graphs = {
        i: graph_from_edges(
            s.edges, s.n_nodes, weights=s.weights, n_pad=n_pad, e_pad=e_pad,
            ell_width=ell_width,
        )
        for i, s in normed.items()
    }
    return ProcessedDataset(graphs=graphs, specs=normed, config=config)
