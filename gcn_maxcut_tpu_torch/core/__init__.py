"""core: see the counterpart in gcn_maxcut_tpu/core/."""

from gcn_maxcut_tpu_torch.core.graph import (
    Graph,
    dense_adjacency,
    graph_from_dense,
    graph_from_edges,
    pad_graph_batch,
    round_up,
)

__all__ = [
    "Graph",
    "graph_from_edges",
    "graph_from_dense",
    "dense_adjacency",
    "pad_graph_batch",
    "round_up",
]
