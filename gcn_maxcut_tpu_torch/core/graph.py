"""Padded sparse graph container.

Port of ``gcn_maxcut_tpu/core/graph.py``: a padded directed COO edge list
sorted by receiver, CSR offsets, degrees, node/edge masks and ELL neighbour
tables, all as torch tensors.  Padding conventions are the JAX package's:

  * nodes ``[0, n_nodes)`` are real, ``[n_nodes, n_pad)`` have
    ``node_mask == 0``;
  * the first ``n_edges`` edge slots are real; padded slots have
    ``senders == receivers == n_pad - 1`` and ``weights == edge_mask == 0``.

``sender_order``/``sender_ptr`` list the real edges grouped by sender:
``sender_order[sender_ptr[u] : sender_ptr[u + 1]]`` are the ids of node
``u``'s out-edges, ascending, and ``sender_ptr[n_pad] == n_edges``; the
padded slots follow, in order.  The card's SDDMM backward
(``ops/segment.sddmm``) walks them as ``row_ptr`` walks the in-edges.

``symmetric`` records that every directed edge is stored with its reverse
and the same weight (graphs built with ``symmetrize=True``, or from a
symmetric dense matrix).  Only then may the ELL and block-ELL SpMMs reuse
their forward as their backward (``ops/segment.py``).

A graph that bands carries a block-ELL plan (``ops/block_ell.py``): the
``bell_*`` tensors and the static geometry ``bell_block``/``bell_wp``.  A
graph that is not symmetric carries the plan of its transpose as well
(``bell_t_*``), which its backward runs on; when either does not plan,
neither is attached.  ``reorder_perm`` records a locality relabeling:
original node ``i`` lives at id ``reorder_perm[i]``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

# Rows with degree above this skip the ELL path (COO index_add_ instead).
ELL_MAX_DEGREE = 64

_PLAN_TENSORS = (
    "senders", "weights", "mask", "out_senders", "out_receivers",
    "out_weights", "out_mask",
)
_TENSOR_FIELDS = (
    "senders", "receivers", "weights", "edge_mask", "row_ptr", "degrees",
    "node_mask", "n_nodes", "n_edges", "sender_order", "sender_ptr",
    "ell_senders", "ell_weights", "ell_mask",
    *(f"bell_{f}" for f in _PLAN_TENSORS),
    *(f"bell_t_{f}" for f in _PLAN_TENSORS),
    "reorder_perm",
)
_STATIC_FIELDS = ("bell_block", "bell_wp", "bell_t_block", "bell_t_wp")


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
    scalars (directed edge count), ``sender_order`` int32 [e_pad] and
    ``sender_ptr`` int32 [n_pad + 1] (the real edges by sender; None on a
    graph not built by ``_build_padded_coo``), ELL tables [n_pad, width] or
    None.
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
    sender_order: torch.Tensor | None = None  # int32 [e_pad]
    sender_ptr: torch.Tensor | None = None    # int32 [n_pad + 1]
    ell_senders: torch.Tensor | None = None   # int32 [n_pad, width]
    ell_weights: torch.Tensor | None = None   # float32 [n_pad, width]
    ell_mask: torch.Tensor | None = None      # float32 [n_pad, width]
    # block-ELL plan of A (ops/block_ell.py); None when the graph does not band
    bell_senders: torch.Tensor | None = None         # int32 [n_pad, bw]
    bell_weights: torch.Tensor | None = None         # f32 [n_pad, bw], 0 pad
    bell_mask: torch.Tensor | None = None            # f32 [n_pad, bw]
    bell_out_senders: torch.Tensor | None = None     # int32 [o_pad]
    bell_out_receivers: torch.Tensor | None = None   # int32 [o_pad]
    bell_out_weights: torch.Tensor | None = None     # f32 [o_pad], 0 pad
    bell_out_mask: torch.Tensor | None = None        # f32 [o_pad]
    bell_block: int | None = None
    bell_wp: int | None = None
    # plan of Aᵀ, only for a graph that is not symmetric
    bell_t_senders: torch.Tensor | None = None
    bell_t_weights: torch.Tensor | None = None
    bell_t_mask: torch.Tensor | None = None
    bell_t_out_senders: torch.Tensor | None = None
    bell_t_out_receivers: torch.Tensor | None = None
    bell_t_out_weights: torch.Tensor | None = None
    bell_t_out_mask: torch.Tensor | None = None
    bell_t_block: int | None = None
    bell_t_wp: int | None = None
    reorder_perm: torch.Tensor | None = None         # int32 [n_pad]
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
    block_ell: bool | str = "auto",
) -> Graph:
    """Assemble a `Graph` from host-side directed COO arrays.

    ``ell_width``: None = this graph's max degree (when ≤ ELL_MAX_DEGREE);
    0 = no ELL tables; a positive width lets a dataset share one width.

    ``block_ell``: attach a block-ELL plan when the graph bands; ``"auto"``
    tries only for n_pad ≥ 4096, ``True`` always, ``False`` never.
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

    sender_order = np.arange(e_pad, dtype=np.int32)
    sender_order[:m] = np.argsort(src, kind="stable")
    sender_ptr = np.zeros(n_pad + 1, dtype=np.int32)
    np.cumsum(np.bincount(src, minlength=n_pad), out=sender_ptr[1:])

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

    plan = {}
    if ell_width > 0 and _wants_plan(block_ell, n_pad):
        plan = _plan_fields(src, dst, w, n_pad, symmetric) or {}

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
        sender_order=torch.from_numpy(sender_order),
        sender_ptr=torch.from_numpy(sender_ptr),
        symmetric=symmetric,
        **ell,
        **plan,
    )


def _wants_plan(block_ell: bool | str, n_pad: int) -> bool:
    """``block_ell``: ``True`` always plans, ``"auto"`` from n_pad 4096 on."""
    return block_ell is True or (block_ell == "auto" and n_pad >= 4096)


def _bell_fields(plan, prefix: str = "bell_") -> dict:
    """Graph fields of a ``BlockEllPlan``."""
    fields = {f"{prefix}{f}": torch.from_numpy(getattr(plan, f)) for f in _PLAN_TENSORS}
    return {**fields, f"{prefix}block": plan.block, f"{prefix}wp": plan.wp}


def _plan_fields(src, dst, w, n_pad: int, symmetric: bool, **plan_kwargs) -> dict | None:
    """Plan fields of A (and of Aᵀ when A is not symmetric), or None when
    either does not plan."""
    from gcn_maxcut_tpu_torch.ops.block_ell import plan_block_ell

    plan = plan_block_ell(src, dst, w, n_pad, **plan_kwargs)
    if plan is None:
        return None
    if symmetric:
        return _bell_fields(plan)
    plan_t = plan_block_ell(dst, src, w, n_pad, **plan_kwargs)
    if plan_t is None:
        return None
    return {**_bell_fields(plan), **_bell_fields(plan_t, "bell_t_")}


def graph_from_edges(
    edges: Sequence[Tuple[int, int]] | np.ndarray,
    n_nodes: int,
    *,
    weights: Sequence[float] | np.ndarray | None = None,
    n_pad: int | None = None,
    e_pad: int | None = None,
    symmetrize: bool = True,
    ell_width: int | None = None,
    block_ell: bool | str = "auto",
    reorder: str = "off",
) -> Graph:
    """Build a padded `Graph` from an undirected edge list of (u, v) pairs;
    with ``symmetrize`` (the default) both directions are stored.

    ``reorder``: ``"off"`` keeps the ids; ``"rcm"`` relabels by reverse
    Cuthill–McKee; ``"auto"`` does so only when a plan is wanted
    (``block_ell``) but the raw order does not plan, and keeps the RCM
    graph only if it plans.  A kept permutation relabels node ``i`` to
    ``g.reorder_perm[i]``.  Callers with pinned ids (terminals) reorder at
    the spec level instead (``data.reorder.rcm_reorder``, then
    ``normalize_terminals``).
    """
    if reorder not in ("off", "auto", "rcm"):
        raise ValueError(f"unknown reorder {reorder!r}")
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    w = (
        np.ones(e.shape[0], dtype=np.float32)
        if weights is None
        else np.asarray(weights, dtype=np.float32)
    )

    n_pad = n_pad if n_pad is not None else round_up(n_nodes, 8)

    def build(e2: np.ndarray, perm: np.ndarray | None = None) -> Graph:
        if symmetrize:
            src = np.concatenate([e2[:, 0], e2[:, 1]])
            dst = np.concatenate([e2[:, 1], e2[:, 0]])
            w2 = np.concatenate([w, w])
        else:
            src, dst, w2 = e2[:, 0], e2[:, 1], w
        ep_ = e_pad if e_pad is not None else round_up(src.shape[0], 128)
        g = _build_padded_coo(
            src.astype(np.int32), dst.astype(np.int32), w2, n_nodes, n_pad, ep_,
            ell_width, symmetric=symmetrize, block_ell=block_ell,
        )
        if perm is not None:
            perm_pad = np.arange(n_pad, dtype=np.int32)
            perm_pad[: perm.shape[0]] = perm
            g = dataclasses.replace(g, reorder_perm=torch.from_numpy(perm_pad))
        return g

    if reorder == "off" or n_nodes < 2 or not e.size:
        return build(e)
    if reorder == "auto":
        g = build(e)
        if g.bell_block is not None or not _wants_plan(block_ell, n_pad):
            return g
    from gcn_maxcut_tpu_torch.data.reorder import rcm_permutation

    perm = rcm_permutation(e, n_nodes)
    g_rcm = build(perm[e], perm)
    if reorder == "rcm" or g_rcm.bell_block is not None:
        return g_rcm
    return g


def graph_from_dense(
    adj: np.ndarray,
    *,
    n_pad: int | None = None,
    e_pad: int | None = None,
    ell_width: int | None = None,
    block_ell: bool | str = "auto",
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
        ell_width, symmetric=bool(np.array_equal(adj, adj.T)), block_ell=block_ell,
    )


def attach_block_ell(g: Graph, **plan_kwargs) -> Graph:
    """Plan an existing single `Graph` from its real COO edges; the graph
    comes back unchanged when it does not band (check ``g.bell_block``)."""
    mask = g.edge_mask.cpu().numpy() > 0
    plan = _plan_fields(
        g.senders.cpu().numpy()[mask], g.receivers.cpu().numpy()[mask],
        g.weights.cpu().numpy()[mask], g.n_pad, g.symmetric, **plan_kwargs,
    )
    if plan is None:
        return g
    return dataclasses.replace(g, **{
        k: (v.to(g.device) if isinstance(v, torch.Tensor) else v) for k, v in plan.items()
    })


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
    """Stack equally padded graphs into a leading batch dimension.  Graphs
    must agree on which fields they carry and on the block-ELL geometry; a
    graph without ``reorder_perm`` gets the identity when others have one."""
    shapes = {(g.n_pad, g.e_pad) for g in graphs}
    if len(shapes) != 1:
        raise ValueError(f"graphs must share padded shapes, got {shapes}")
    static = {tuple(getattr(g, f) for f in _STATIC_FIELDS) for g in graphs}
    if len(static) != 1:
        raise ValueError(f"graphs disagree on block-ELL geometry {_STATIC_FIELDS}: {static}")
    if any(g.reorder_perm is not None for g in graphs):
        ident = torch.arange(graphs[0].n_pad, dtype=torch.int32)
        graphs = [
            g if g.reorder_perm is not None
            else dataclasses.replace(g, reorder_perm=ident.to(g.device))
            for g in graphs
        ]
    fields = {}
    for f in _TENSOR_FIELDS:
        vals = [getattr(g, f) for g in graphs]
        if any(v is None for v in vals):
            if not all(v is None for v in vals):
                raise ValueError(f"graphs disagree on having {f}")
            fields[f] = None
        else:
            fields[f] = torch.stack(vals)
    return Graph(
        **fields, **dict(zip(_STATIC_FIELDS, static.pop())),
        symmetric=all(g.symmetric for g in graphs),
    )
