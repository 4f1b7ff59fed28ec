"""Padded sparse graph container.

Port of ``gcn_maxcut_tpu/core/graph.py``: a padded directed COO edge list
sorted by receiver, CSR offsets, degrees, node/edge masks and ELL neighbour
tables, all as torch tensors.  Padding conventions are the JAX package's:

  * nodes ``[0, n_nodes)`` are real, ``[n_nodes, n_pad)`` have
    ``node_mask == 0``;
  * the first ``n_edges`` edge slots are real; padded slots have
    ``senders == receivers == n_pad - 1`` and ``weights == edge_mask == 0``.

``symmetric`` records that every directed edge is stored with its reverse
and the same weight (graphs built with ``symmetrize=True``, or from a
symmetric dense matrix).  Only then may the ELL SpMM reuse its forward as
its backward (``ops/segment.py``).

The block-ELL plan fields and locality reordering of the JAX container are
not in this port yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

# Rows with degree above this skip the ELL path (COO index_add_ instead).
ELL_MAX_DEGREE = 64

_TENSOR_FIELDS = (
    "senders", "receivers", "weights", "edge_mask", "row_ptr", "degrees",
    "node_mask", "n_nodes", "n_edges", "ell_senders", "ell_weights",
    "ell_mask",
)


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m`` (min ``m``)."""
    return max(m, ((int(x) + m - 1) // m) * m)


@dataclasses.dataclass
class Graph:
    """Padded sparse graph; a batch (``pad_graph_batch``) adds a leading
    dimension to every tensor field.

    Shapes: ``senders/receivers`` int32 [e_pad] (receivers nondecreasing),
    ``weights/edge_mask`` float32 [e_pad], ``row_ptr`` int32 [n_pad + 1],
    ``degrees/node_mask`` float32 [n_pad], ``n_nodes/n_edges`` int32
    scalars (directed edge count), ELL tables [n_pad, width] or None.
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    weights: torch.Tensor
    edge_mask: torch.Tensor
    row_ptr: torch.Tensor
    degrees: torch.Tensor
    node_mask: torch.Tensor
    n_nodes: torch.Tensor
    n_edges: torch.Tensor
    ell_senders: torch.Tensor | None = None   # int32 [n_pad, width]
    ell_weights: torch.Tensor | None = None   # float32 [n_pad, width]
    ell_mask: torch.Tensor | None = None      # float32 [n_pad, width]
    symmetric: bool = False

    @property
    def n_pad(self) -> int:
        return self.node_mask.shape[-1]

    @property
    def e_pad(self) -> int:
        return self.senders.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.senders.device

    def _map(self, fn) -> "Graph":
        return dataclasses.replace(self, **{
            f: (None if getattr(self, f) is None else fn(getattr(self, f)))
            for f in _TENSOR_FIELDS
        })

    def to(self, device: str | torch.device) -> "Graph":
        return self._map(lambda t: t.to(device))

    def index(self, i: int) -> "Graph":
        """Graph ``i`` of a batch built by ``pad_graph_batch``."""
        return self._map(lambda t: t[i])


def _build_padded_coo(
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    n_nodes: int,
    n_pad: int,
    e_pad: int,
    ell_width: int | None,
    symmetric: bool,
) -> Graph:
    """Assemble a `Graph` from host-side directed COO arrays.

    ``ell_width``: None = this graph's max degree (when ≤ ELL_MAX_DEGREE);
    0 = no ELL tables; a positive width lets a dataset share one width.
    """
    m = src.shape[0]
    if m > e_pad:
        raise ValueError(f"{m} directed edges do not fit in e_pad={e_pad}")
    if n_nodes > n_pad:
        raise ValueError(f"{n_nodes} nodes do not fit in n_pad={n_pad}")

    order = np.argsort(dst, kind="stable")
    src, dst, w = src[order], dst[order], w[order]

    senders = np.full(e_pad, n_pad - 1, dtype=np.int32)
    receivers = np.full(e_pad, n_pad - 1, dtype=np.int32)
    weights = np.zeros(e_pad, dtype=np.float32)
    edge_mask = np.zeros(e_pad, dtype=np.float32)
    senders[:m] = src
    receivers[:m] = dst
    weights[:m] = w
    edge_mask[:m] = 1.0

    counts = np.bincount(receivers, minlength=n_pad)
    row_ptr = np.zeros(n_pad + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])

    degrees = np.bincount(dst, minlength=n_pad).astype(np.float32)

    node_mask = np.zeros(n_pad, dtype=np.float32)
    node_mask[:n_nodes] = 1.0

    max_deg = int(degrees.max()) if m else 0
    if ell_width is None:
        ell_width = max_deg if 0 < max_deg <= ELL_MAX_DEGREE else 0
    elif 0 < ell_width < max_deg:
        raise ValueError(f"ell_width={ell_width} < graph max degree {max_deg}")
    ell = {}
    if ell_width > 0:
        # slot of each edge within its receiver's run (the sort is stable,
        # so slots follow the edge order, as a per-edge fill loop would)
        slot = np.arange(m) - row_ptr[dst]
        ell_senders = np.zeros((n_pad, ell_width), dtype=np.int32)
        ell_weights = np.zeros((n_pad, ell_width), dtype=np.float32)
        ell_mask = np.zeros((n_pad, ell_width), dtype=np.float32)
        ell_senders[dst, slot] = src
        ell_weights[dst, slot] = w
        ell_mask[dst, slot] = 1.0
        ell = {
            "ell_senders": torch.from_numpy(ell_senders),
            "ell_weights": torch.from_numpy(ell_weights),
            "ell_mask": torch.from_numpy(ell_mask),
        }

    return Graph(
        senders=torch.from_numpy(senders),
        receivers=torch.from_numpy(receivers),
        weights=torch.from_numpy(weights),
        edge_mask=torch.from_numpy(edge_mask),
        row_ptr=torch.from_numpy(row_ptr),
        degrees=torch.from_numpy(degrees),
        node_mask=torch.from_numpy(node_mask),
        n_nodes=torch.tensor(n_nodes, dtype=torch.int32),
        n_edges=torch.tensor(m, dtype=torch.int32),
        symmetric=symmetric,
        **ell,
    )


def graph_from_edges(
    edges: Sequence[Tuple[int, int]] | np.ndarray,
    n_nodes: int,
    *,
    weights: Sequence[float] | np.ndarray | None = None,
    n_pad: int | None = None,
    e_pad: int | None = None,
    symmetrize: bool = True,
    ell_width: int | None = None,
    reorder: str = "off",
) -> Graph:
    """Build a padded `Graph` from an undirected edge list of (u, v) pairs;
    with ``symmetrize`` (the default) both directions are stored.

    Only ``reorder="off"`` is ported; locality reordering comes with the
    block-ELL kernel.
    """
    if reorder != "off":
        raise NotImplementedError(f"reorder={reorder!r} is not ported yet")
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    w = (
        np.ones(e.shape[0], dtype=np.float32)
        if weights is None
        else np.asarray(weights, dtype=np.float32)
    )
    if symmetrize:
        src = np.concatenate([e[:, 0], e[:, 1]])
        dst = np.concatenate([e[:, 1], e[:, 0]])
        w = np.concatenate([w, w])
    else:
        src, dst = e[:, 0], e[:, 1]
    n_pad = n_pad if n_pad is not None else round_up(n_nodes, 8)
    e_pad = e_pad if e_pad is not None else round_up(src.shape[0], 128)
    return _build_padded_coo(
        src.astype(np.int32), dst.astype(np.int32), w, n_nodes, n_pad, e_pad,
        ell_width, symmetric=symmetrize,
    )


def graph_from_dense(
    adj: np.ndarray,
    *,
    n_pad: int | None = None,
    e_pad: int | None = None,
    ell_width: int | None = None,
) -> Graph:
    """Build a `Graph` from a dense (possibly weighted) adjacency matrix;
    it is marked symmetric when the matrix is."""
    adj = np.asarray(adj)
    n = adj.shape[0]
    src, dst = np.nonzero(adj)
    w = adj[src, dst].astype(np.float32)
    n_pad = n_pad if n_pad is not None else round_up(n, 8)
    e_pad = e_pad if e_pad is not None else round_up(max(1, src.shape[0]), 128)
    return _build_padded_coo(
        src.astype(np.int32), dst.astype(np.int32), w, n, n_pad, e_pad,
        ell_width, symmetric=bool(np.array_equal(adj, adj.T)),
    )


def dense_adjacency(
    g: Graph, width: int | None = None, values: str = "weights"
) -> torch.Tensor:
    """Densify to ``[n_pad, width]`` (default ``width = n_pad``).

    ``values="weights"`` gives the reference's padded adjacency-as-features
    (sender ids past ``width - 1`` are clipped onto the last column, as in
    the JAX package); ``values="mask"`` writes 1.0 per real edge, the
    unweighted aggregation operator.
    """
    if values not in ("weights", "mask"):
        raise ValueError(f"unknown values mode {values!r}")
    width = g.n_pad if width is None else width
    dense = torch.zeros((g.n_pad, width), dtype=torch.float32, device=g.device)
    vals = g.weights * g.edge_mask if values == "weights" else g.edge_mask
    cols = torch.clamp(g.senders, max=width - 1).long()
    return dense.index_put_((g.receivers.long(), cols), vals, accumulate=True)


def pad_graph_batch(graphs: List[Graph]) -> Graph:
    """Stack equally padded graphs into a leading batch dimension."""
    shapes = {(g.n_pad, g.e_pad) for g in graphs}
    if len(shapes) != 1:
        raise ValueError(f"graphs must share padded shapes, got {shapes}")
    fields = {}
    for f in _TENSOR_FIELDS:
        vals = [getattr(g, f) for g in graphs]
        if any(v is None for v in vals):
            if not all(v is None for v in vals):
                raise ValueError(f"graphs disagree on having {f}")
            fields[f] = None
        else:
            fields[f] = torch.stack(vals)
    return Graph(**fields, symmetric=all(g.symmetric for g in graphs))
