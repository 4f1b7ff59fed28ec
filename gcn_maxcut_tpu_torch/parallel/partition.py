"""Graph partitioning for node-sharded (giant single graph) parallelism.

Port of ``gcn_maxcut_tpu/parallel/partition.py``.  One graph's nodes are
split into D shards; shard d owns its nodes and their incoming edges, and
the edges are grouped by the hop distance of their sender's shard around
the ring (group s: senders on shard (d + s) mod D), so the ring schedule of
``parallel/spmm.py`` aggregates group s when shard (d + s)'s rows arrive.

Partitioners: contiguous ranges, BFS-grown blocks and the native multilevel
(METIS-style) partition, whose imbalance cap is not enforced: nothing here
assumes balanced shards, ``n_shard`` is the largest shard rounded up.

``shard_graph`` builds a ``ShardedGraph`` of host (CPU) tensors, one tensor
set per shard with the JAX package's field names; ``ShardedGraph.to(mesh)``
moves shard d's set onto ``mesh.devices[d]``.  The buffers are equal array
for array to the JAX package's stacked ``[D, ...]`` fields (shard d's
tensor against ``jax_field[d]``).  Two assembly lanes give the same arrays:
the native O(E) counting sort (``native/bindings.shard_assembly_native``)
and the numpy lexsort lane, which alone offers the per-shard RCM relabel
and the hop-0 block-ELL plan.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Tuple

import numpy as np
import torch

from gcn_maxcut_tpu_torch.core.graph import round_up
from gcn_maxcut_tpu_torch.parallel.mesh import Mesh

Shards = Tuple[torch.Tensor, ...]

_FIELDS = ("senders", "receivers", "weights", "edge_mask", "degrees", "node_mask",
           "ell_senders", "ell_weights", "ell_mask", "bell_senders", "bell_weights",
           "bell_out_senders", "bell_out_receivers", "bell_out_weights")


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """A node-sharded graph: each tensor field holds one tensor per shard.

    Shard d's edge group s holds the edges whose receiver d owns and whose
    sender shard (d + s) mod D owns; senders are local indices in their
    own shard, receivers local indices in d.  Per shard: ``senders``,
    ``receivers`` int32 and ``weights``, ``edge_mask`` float32
    ``[D, e_group]``; ``degrees``, ``node_mask`` float32 ``[n_shard]``;
    the optional ELL tables ``[D, n_shard, ell_w]`` (receiver-major,
    padding slots: sender n_shard − 1, weight 0); the optional hop-0
    block-ELL plan (``bell_*``: table ``[n_shard, bw]``, outliers
    ``[o_pad]``; one geometry ``bell_block``/``bell_wp`` for every shard).
    ``symmetric``: the directed COO was checked to equal its transpose.
    """

    senders: Shards
    receivers: Shards
    weights: Shards
    edge_mask: Shards
    degrees: Shards
    node_mask: Shards
    n_nodes: int
    ell_senders: Shards | None = None
    ell_weights: Shards | None = None
    ell_mask: Shards | None = None
    bell_senders: Shards | None = None
    bell_weights: Shards | None = None
    bell_out_senders: Shards | None = None
    bell_out_receivers: Shards | None = None
    bell_out_weights: Shards | None = None
    bell_block: int | None = None
    bell_wp: int | None = None
    symmetric: bool = True

    @property
    def num_shards(self) -> int:
        return len(self.senders)

    @property
    def n_shard(self) -> int:
        return self.node_mask[0].shape[-1]

    @property
    def e_group(self) -> int:
        return self.senders[0].shape[-1]

    def to(self, mesh: Mesh) -> "ShardedGraph":
        """Shard d's tensors on ``mesh.devices[d]``."""
        if mesh.size != self.num_shards:
            raise ValueError(f"a mesh of {mesh.size} devices for {self.num_shards} shards")
        moved = {
            f: tuple(t.to(dev) for t, dev in zip(getattr(self, f), mesh.devices))
            for f in _FIELDS if getattr(self, f) is not None
        }
        return dataclasses.replace(self, **moved)


def _shards(a: np.ndarray | None) -> Shards | None:
    """A stacked [D, ...] host array as D CPU tensors."""
    return None if a is None else tuple(torch.from_numpy(np.ascontiguousarray(s)) for s in a)


def partition_nodes_contiguous(n: int, num_shards: int) -> np.ndarray:
    """Owner shard of each node: equal contiguous ranges."""
    n_shard = -(-n // num_shards)
    return np.minimum(np.arange(n) // n_shard, num_shards - 1)


def partition_nodes_bfs(
    senders: np.ndarray, receivers: np.ndarray, n: int, num_shards: int
) -> np.ndarray:
    """BFS-grown blocks of ceil(n / D) nodes, each grown from the lowest-id
    unassigned node; leftovers go to the last shard.  O(n + E) host-side."""
    order = np.argsort(senders, kind="stable")
    r_sorted = receivers[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, senders[order] + 1, 1)
    np.cumsum(indptr, out=indptr)

    target = -(-n // num_shards)
    owner = np.full(n, -1, dtype=np.int64)
    next_seed = 0
    for shard in range(num_shards):
        count = 0
        queue: deque[int] = deque()
        while count < target:
            if not queue:
                while next_seed < n and owner[next_seed] != -1:
                    next_seed += 1
                if next_seed >= n:
                    break
                queue.append(next_seed)
                owner[next_seed] = shard
                count += 1
            v = queue.popleft()
            for e in range(indptr[v], indptr[v + 1]):
                u = r_sorted[e]
                if owner[u] == -1 and count < target:
                    owner[u] = shard
                    count += 1
                    queue.append(u)
    owner[owner == -1] = num_shards - 1
    return owner


def partition_nodes_metis(
    senders: np.ndarray,
    receivers: np.ndarray,
    n: int,
    num_shards: int,
    weights: np.ndarray | None = None,
    imbalance: float = 0.03,
    seed: int = 0,
) -> np.ndarray:
    """Multilevel (METIS-style) partition by the native toolkit
    (``gt_metis_partition``).  ``imbalance`` is its target; the toolkit
    does not enforce it."""
    from gcn_maxcut_tpu_torch.native.bindings import metis_partition_native

    return metis_partition_native(senders, receivers, n, num_shards,
                                  weights=weights, imbalance=imbalance, seed=seed)


def partition_quality(owner: np.ndarray, senders: np.ndarray, receivers: np.ndarray) -> dict:
    """Edge-cut quality of a node -> shard assignment: the fraction of
    directed edges across shards, max shard size over the mean, edges per
    ring hop distance and the shard sizes."""
    owner = np.asarray(owner)
    num_shards = int(owner.max()) + 1 if owner.size else 1
    send_shard = owner[senders]
    recv_shard = owner[receivers]
    cross = send_shard != recv_shard
    hops = (send_shard - recv_shard) % num_shards
    sizes = np.bincount(owner, minlength=num_shards)
    return {
        "num_shards": num_shards,
        "cross_shard_edge_fraction": float(cross.mean()) if cross.size else 0.0,
        "imbalance": float(sizes.max() / max(sizes.mean(), 1e-9)),
        "edges_by_hop": np.bincount(hops, minlength=num_shards).tolist(),
        "shard_sizes": sizes.tolist(),
    }


def is_symmetric_coo(senders: np.ndarray, receivers: np.ndarray, weights: np.ndarray) -> bool:
    """True iff the directed COO multiset equals its transpose
    ({(s, r, w)} == {(r, s, w)}), by the native toolkit's O(E) hash."""
    if senders.shape[0] != receivers.shape[0]:
        return False
    from gcn_maxcut_tpu_torch.native.bindings import symmetry_check_native

    return symmetry_check_native(senders, receivers, weights)


def shard_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    n: int,
    num_shards: int,
    weights: np.ndarray | None = None,
    owner: np.ndarray | None = None,
    edge_pad_multiple: int = 128,
    build_ell: bool = True,
    check_symmetry: bool = True,
    ell_budget_bytes: int = 1 << 30,
    use_native: bool = True,
    local_reorder: str = "off",
    block_ell: bool = False,
    block_ell_outlier_frac: float = 0.05,
) -> Tuple[ShardedGraph, np.ndarray]:
    """Build a host ``ShardedGraph`` from directed COO arrays; returns
    ``(sharded_graph, global_to_local)`` with ``global_to_local[v] =
    owner[v]·n_shard + local index of v``.

    ``owner``: node -> shard (default contiguous).  ``check_symmetry``:
    verify Aᵀ = A once (False asserts it), which gates the symmetric
    backward of ``spmm.sharded_spmm_sym``.  ``local_reorder="rcm"``:
    RCM-relabel each shard's nodes by its intra-shard subgraph (SciPy's
    RCM); ``block_ell``: plan the hop-0 group of every shard for K1 with one
    shared geometry (``n_shard`` then a multiple of 1024), only on a
    symmetric graph, because the hop-0 backward reuses the forward (a
    diagonal block of a symmetric A is symmetric).  A graph that is not
    symmetric, or a shard whose local subgraph does not band, keeps the
    gather tables.  Both options take the numpy lane.  With a relabel,
    "shard 0 rows 0..k-1" (the terminals) are not global nodes 0..k-1;
    decode through ``global_to_local``.
    """
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    w = (np.ones(senders.shape[0], dtype=np.float32) if weights is None
         else np.asarray(weights, dtype=np.float32))
    symmetric = is_symmetric_coo(senders, receivers, w) if check_symmetry else True
    if owner is None:
        owner = partition_nodes_contiguous(n, num_shards)
    owner = np.asarray(owner, dtype=np.int64)

    if use_native and n < (1 << 31) and local_reorder == "off" and not block_ell:
        from gcn_maxcut_tpu_torch.native.bindings import shard_assembly_native

        res = shard_assembly_native(
            senders, receivers, owner, n, num_shards, weights=weights,
            edge_pad_multiple=edge_pad_multiple, build_ell=build_ell,
            ell_budget_bytes=ell_budget_bytes,
        )
        node_mask = (np.arange(res["n_shard"])[None, :]
                     < res["shard_sizes"][:, None]).astype(np.float32)
        sg = ShardedGraph(
            senders=_shards(res["S"]), receivers=_shards(res["R"]),
            weights=_shards(res["W"]), edge_mask=_shards(res["M"]),
            degrees=_shards(res["degrees"]), node_mask=_shards(node_mask),
            n_nodes=int(n),
            ell_senders=_shards(res["ES"]), ell_weights=_shards(res["EW"]),
            ell_mask=_shards(res["EM"]), symmetric=symmetric,
        )
        return sg, owner * res["n_shard"] + res["local"]

    shard_sizes = np.bincount(owner, minlength=num_shards)
    # K1's geometry needs a divisor block of n_shard: any multiple of 1024
    n_shard = round_up(int(shard_sizes.max()), 1024 if block_ell else 8)

    # local index: rank of the node among its shard's members (stable)
    node_order = np.argsort(owner, kind="stable")
    starts = np.concatenate([[0], np.cumsum(shard_sizes)[:-1]])
    local = np.empty(n, dtype=np.int64)
    local[node_order] = np.arange(n) - np.repeat(starts, shard_sizes)

    if local_reorder == "rcm":
        from gcn_maxcut_tpu_torch.data.reorder import rcm_permutation

        intra = owner[senders] == owner[receivers]
        for sdx in range(num_shards):
            sz = int(shard_sizes[sdx])
            if sz == 0:
                continue
            sel = intra & (owner[senders] == sdx)
            e_loc = np.stack([local[senders[sel]], local[receivers[sel]]], axis=1)
            perm = rcm_permutation(e_loc, sz)
            members = np.nonzero(owner == sdx)[0]
            local[members] = perm[local[members]]
    elif local_reorder != "off":
        raise ValueError(f"unknown local_reorder {local_reorder!r}")

    recv_shard = owner[receivers]
    group = (owner[senders] - recv_shard) % num_shards  # ring hop distance
    r_loc_all = local[receivers]

    # one lexsort by (receiver shard, group, local receiver); every
    # per-(d, s) quantity falls out of bincounts and run offsets
    e_sorted = np.lexsort((r_loc_all, group, recv_shard))
    ds_key = (recv_shard * num_shards + group)[e_sorted]
    counts_flat = np.bincount(ds_key, minlength=num_shards * num_shards)
    e_group = round_up(int(counts_flat.max()) if counts_flat.size else 0, edge_pad_multiple)
    bucket_starts = np.concatenate([[0], np.cumsum(counts_flat)[:-1]])
    pos = np.arange(e_sorted.size) - np.repeat(bucket_starts, counts_flat)

    S = np.full((num_shards, num_shards, e_group), n_shard - 1, dtype=np.int32)
    R = np.full_like(S, n_shard - 1)
    W = np.zeros((num_shards, num_shards, e_group), dtype=np.float32)
    M = np.zeros_like(W)
    flat = ds_key * e_group + pos
    S.reshape(-1)[flat] = local[senders[e_sorted]]
    R.reshape(-1)[flat] = r_loc_all[e_sorted]
    W.reshape(-1)[flat] = w[e_sorted]
    M.reshape(-1)[flat] = 1.0

    # ELL width: the largest per-(shard, group) in-degree.  No tables when
    # the three of them (4 B a slot each) exceed the byte budget, or when
    # that width is far above the mean occupied in-degree (one hub pads
    # every row of every group)
    dsr_key = ds_key * n_shard + r_loc_all[e_sorted]
    deg_group_flat = np.bincount(dsr_key, minlength=num_shards * num_shards * n_shard)
    ell_w = int(deg_group_flat.max()) if deg_group_flat.size else 0
    occupied = deg_group_flat[deg_group_flat > 0]
    mean_deg = float(occupied.mean()) if occupied.size else 0.0
    ell_bytes = 3 * 4 * num_shards * num_shards * n_shard * ell_w
    use_ell = (build_ell and ell_w > 0 and ell_bytes <= ell_budget_bytes
               and ell_w <= max(8.0, 8.0 * mean_deg))
    ES = EW = EM = None
    if use_ell:
        ES = np.full((num_shards, num_shards, n_shard, ell_w), n_shard - 1, np.int32)
        EW = np.zeros((num_shards, num_shards, n_shard, ell_w), np.float32)
        EM = np.zeros_like(EW)
        # slot = index within the run of equal (d, s, r_loc)
        run_starts = np.concatenate([[0], np.cumsum(np.bincount(dsr_key))[:-1]])
        ell_flat = dsr_key * ell_w + np.arange(e_sorted.size) - run_starts[dsr_key]
        ES.reshape(-1)[ell_flat] = local[senders[e_sorted]]
        EW.reshape(-1)[ell_flat] = w[e_sorted]
        EM.reshape(-1)[ell_flat] = 1.0

    degrees = np.bincount(recv_shard * n_shard + r_loc_all,
                          minlength=num_shards * n_shard).astype(np.float32)
    node_mask = (np.arange(n_shard)[None, :] < shard_sizes[:, None]).astype(np.float32)

    bell = (_plan_local_block_ell(S, R, W, M, num_shards, n_shard,
                                  max_outlier_frac=block_ell_outlier_frac)
            if block_ell and symmetric else None)

    sg = ShardedGraph(
        senders=_shards(S), receivers=_shards(R), weights=_shards(W), edge_mask=_shards(M),
        degrees=_shards(degrees.reshape(num_shards, n_shard)), node_mask=_shards(node_mask),
        n_nodes=int(n), ell_senders=_shards(ES), ell_weights=_shards(EW),
        ell_mask=_shards(EM), symmetric=symmetric, **(bell or {}),
    )
    return sg, owner * n_shard + local


def _plan_local_block_ell(S, R, W, M, num_shards, n_shard, max_outlier_frac: float = 0.05):
    """Per-shard block-ELL plans of the hop-0 groups with one geometry.

    Plans each shard's local subgraph with ``ops.block_ell.plan_block_ell``,
    re-plans the shards whose half-window is below the largest at that one
    (same n_shard and wp give the same block), and pads the tables and
    outlier lists to the widest.  Returns the ``bell_*`` fields, or None
    when a shard's local subgraph does not band (the gather tables stay).
    """
    from gcn_maxcut_tpu_torch.ops.block_ell import plan_block_ell

    def shard_coo(d):
        msk = M[d, 0] > 0
        return S[d, 0][msk], R[d, 0][msk], W[d, 0][msk]

    plans = []
    for d in range(num_shards):
        plan = plan_block_ell(*shard_coo(d), n_shard, max_outlier_frac=max_outlier_frac)
        if plan is None:
            return None
        plans.append(plan)
    wp_u = max(p.wp for p in plans)
    for d, p in enumerate(plans):
        if p.wp != wp_u:
            plans[d] = plan_block_ell(*shard_coo(d), n_shard, force_wp=wp_u,
                                      max_outlier_frac=max_outlier_frac)
            if plans[d] is None:
                return None
    if len({p.block for p in plans}) != 1:
        return None
    bw_u = max(p.senders.shape[1] for p in plans)
    o_u = max(p.out_senders.shape[0] for p in plans)

    def pad_tab(a, fill):
        return np.pad(a, ((0, 0), (0, bw_u - a.shape[1])), constant_values=fill)

    def pad_out(a, fill):
        return np.pad(a, (0, o_u - a.shape[0]), constant_values=fill)

    def stack(fn):
        return _shards(np.stack([fn(p) for p in plans]))

    return dict(
        bell_senders=stack(lambda p: pad_tab(p.senders, n_shard - 1)),
        bell_weights=stack(lambda p: pad_tab(p.weights, 0.0)),
        bell_out_senders=stack(lambda p: pad_out(p.out_senders, n_shard - 1)),
        bell_out_receivers=stack(lambda p: pad_out(p.out_receivers, n_shard - 1)),
        bell_out_weights=stack(lambda p: pad_out(p.out_weights, 0.0)),
        bell_block=plans[0].block,
        bell_wp=wp_u,
    )
