"""Locality reordering: reverse Cuthill–McKee banding.

Port of ``gcn_maxcut_tpu/data/reorder.py``.  A graph with locality (a mesh,
a lattice, a road-like network, a banded random graph whose ids were
shuffled) is relabeled so that neighbour offsets stay inside a small band;
its SpMM then rides the block-ELL kernel (``ops/block_ell.py``).  Expanders
(random regular graphs) keep a bandwidth of order n under every ordering;
``rcm_reorder`` reports the bandwidth it reached so that the caller can
tell.  The permutation is SciPy's, so both packages give the same ids.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gcn_maxcut_tpu_torch.data.generate import GraphSpec


def rcm_permutation(edges: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill–McKee node permutation: old id ``i`` becomes
    ``perm[i]``."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    adj = csr_matrix((np.ones(src.shape[0], np.float32), (src, dst)), shape=(n, n))
    order = reverse_cuthill_mckee(adj, symmetric_mode=True)  # slot -> old id
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    return inv


def graph_bandwidth(edges: np.ndarray) -> int:
    """max |u − v| over the edges (0 for none)."""
    if edges.size == 0:
        return 0
    return int(np.max(np.abs(edges[:, 0].astype(np.int64) - edges[:, 1])))


def rcm_reorder(spec: GraphSpec) -> Tuple[GraphSpec, int]:
    """Relabel a graph by RCM; returns ``(reordered_spec, bandwidth)``.
    Edges come back as sorted (lo, hi) pairs and terminals are mapped
    through the permutation (``normalize_terminals`` moves them back onto
    ids 0..t-1)."""
    perm = rcm_permutation(spec.edges, spec.n_nodes)
    e = perm[spec.edges]
    edges = np.stack([np.minimum(e[:, 0], e[:, 1]), np.maximum(e[:, 0], e[:, 1])], axis=1)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    new = GraphSpec(
        n_nodes=spec.n_nodes,
        edges=edges[order],
        terminals=[int(perm[t]) for t in spec.terminals],
        degree=spec.degree,
        weights=None if spec.weights is None else spec.weights[order],
    )
    return new, graph_bandwidth(new.edges)


def is_bandable(spec: GraphSpec, max_bandwidth: int) -> Tuple[bool, int]:
    """Whether RCM brings the graph's bandwidth to ``max_bandwidth`` or
    below, and the bandwidth it reached."""
    _, w = rcm_reorder(spec)
    return w <= max_bandwidth, w
