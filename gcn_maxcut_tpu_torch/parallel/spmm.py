"""Node-sharded SpMM over a device ring: the all-gather and ring schedules.

Port of ``gcn_maxcut_tpu/parallel/spmm.py``.  ``y[r] = Σ w_e · x[s]`` with
nodes and feature rows sharded over a ``parallel.mesh.Mesh``: ``xs[d]`` is
shard d's ``[n_shard, F]`` block on ``mesh.devices[d]``, and one Python
process drives every shard, as one ``shard_map`` drives the JAX program.

  * ``sharded_spmm_allgather``: every shard first receives all D blocks,
    then aggregates its D edge groups.
  * ``sharded_spmm_ring``: D hops; at hop s shard d aggregates edge group s
    from the block it holds, shard (d + s) mod D's, and receives the next
    one from its right neighbour (the JAX ``ppermute`` to the left).

Both add the groups in hop order.  A block moves with ``.to(device)``, as
``ops/halo.halo_exchange`` moves rows; on a ring of one card that is no
copy.  Nothing overlaps the transfers with the aggregation: the JAX
overlap is XLA's scheduling, and no multi-card machine shows one here.

Each group aggregates by one of three routes (``_group_aggregate``): hop 0
on K1 (``ops/block_ell.block_ell_spmm``: the hand-written CUDA kernel on
a CUDA tensor, its plain version on the CPU) when ``shard_graph`` attached
a plan, else the ELL gather tables, else the COO ``index_add_``.  The TPU
path padded x to 128 lanes before its kernel; K1 takes any width.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from gcn_maxcut_tpu_torch.ops.block_ell import block_ell_spmm
from gcn_maxcut_tpu_torch.ops.segment import _ell_sum
from gcn_maxcut_tpu_torch.parallel.mesh import Mesh
from gcn_maxcut_tpu_torch.parallel.partition import ShardedGraph

Blocks = List[torch.Tensor]


def _group_aggregate(sg: ShardedGraph, d: int, s: int, x_src: torch.Tensor) -> torch.Tensor:
    """Edge group ``s`` of shard ``d`` from the source shard's rows
    ``x_src`` [n_shard, F]."""
    if s == 0 and sg.bell_senders is not None:
        return block_ell_spmm(
            x_src.float(), sg.bell_senders[d], sg.bell_weights[d], sg.bell_out_senders[d],
            sg.bell_out_receivers[d], sg.bell_out_weights[d], sg.n_shard,
            sg.bell_block, sg.bell_wp,
        )
    if sg.ell_senders is not None:
        return _ell_sum(x_src, sg.ell_senders[d][s], sg.ell_weights[d][s])
    msgs = x_src[sg.senders[d][s]] * (sg.weights[d][s] * sg.edge_mask[d][s])[:, None]
    out = torch.zeros((sg.n_shard, x_src.shape[-1]), dtype=msgs.dtype, device=msgs.device)
    return out.index_add(0, sg.receivers[d][s], msgs)


def sharded_spmm_allgather(sg: ShardedGraph, xs: Sequence[torch.Tensor], mesh: Mesh) -> Blocks:
    """All-gather schedule: each shard receives every block, then sums its
    groups in hop order."""
    D = mesh.size
    outs = []
    for d, dev in enumerate(mesh.devices):
        xg = [x.to(dev) for x in xs]
        out = _group_aggregate(sg, d, 0, xg[d])
        for s in range(1, D):
            out = out + _group_aggregate(sg, d, s, xg[(d + s) % D])
        outs.append(out)
    return outs


def sharded_spmm_ring(sg: ShardedGraph, xs: Sequence[torch.Tensor], mesh: Mesh) -> Blocks:
    """Ring schedule: at hop s shard d holds shard (d + s) mod D's block,
    aggregates group s from it and receives the next block from shard
    d + 1 (which held shard (d + s + 1)'s)."""
    D = mesh.size
    bufs = list(xs)
    outs = [_group_aggregate(sg, d, 0, bufs[d]) for d in range(D)]
    for s in range(1, D):
        bufs = [bufs[(d + 1) % D].to(dev) for d, dev in enumerate(mesh.devices)]
        outs = [out + _group_aggregate(sg, d, s, buf)
                for d, (out, buf) in enumerate(zip(outs, bufs))]
    return outs


def make_sharded_spmm(schedule: str = "ring") -> Callable:
    if schedule == "ring":
        return sharded_spmm_ring
    if schedule == "allgather":
        return sharded_spmm_allgather
    raise ValueError(f"unknown schedule {schedule!r}")


class _SymmetricSpmm(torch.autograd.Function):
    """y = A·x with dx = A·dy (Aᵀ = A): the backward runs the same
    schedule on the cotangent, so no scatter runs."""

    @staticmethod
    def forward(ctx, sg, mesh, schedule, *xs):
        ctx.sg, ctx.mesh, ctx.schedule = sg, mesh, schedule
        return tuple(make_sharded_spmm(schedule)(sg, xs, mesh))

    @staticmethod
    def backward(ctx, *dys):
        dxs = make_sharded_spmm(ctx.schedule)(ctx.sg, [dy.contiguous() for dy in dys], ctx.mesh)
        return (None, None, None, *dxs)


def sharded_spmm_sym(
    sg: ShardedGraph, xs: Sequence[torch.Tensor], mesh: Mesh, schedule: str = "ring"
) -> Blocks:
    """Sharded SpMM with the symmetric-adjacency backward.  Only for a graph
    ``shard_graph`` found symmetric; the edge weights get no gradient."""
    return list(_SymmetricSpmm.apply(sg, mesh, schedule, *xs))


def _aggregate(sg: ShardedGraph, xs: Sequence[torch.Tensor], mesh: Mesh, schedule: str) -> Blocks:
    # the symmetric backward only where Aᵀ = A was checked; any other graph
    # takes autograd's backward through the schedule, Aᵀ·dy
    if sg.symmetric:
        return sharded_spmm_sym(sg, xs, mesh, schedule)
    return make_sharded_spmm(schedule)(sg, xs, mesh)


def sharded_gcn_conv(
    w: torch.Tensor,
    b: torch.Tensor,
    sg: ShardedGraph,
    xs: Sequence[torch.Tensor],
    mesh: Mesh,
    schedule: str = "ring",
) -> Blocks:
    """GraphConv (DGL ``norm='both'``) on a node-sharded graph, the same
    math as ``models.gcn.gcn_conv_apply`` with per-shard degrees.  ``w``,
    ``b`` may live on one device; each shard uses its own copy, so autograd
    sums their gradients over the shards.  The projection goes first when
    it narrows (in > out: fewer operations in the aggregation).  The JAX
    function preferred a 128-lane-aligned aggregation width when a plan
    was attached; this changes only the order of the float sums.
    """
    in_f, out_f = w.shape
    norms = [torch.rsqrt(torch.clamp(deg, min=1.0))[:, None] for deg in sg.degrees]
    ws = [w.to(dev) for dev in mesh.devices]
    bs = [b.to(dev) for dev in mesh.devices]
    hs = [x * nm for x, nm in zip(xs, norms)]
    if in_f > out_f:
        hs = _aggregate(sg, [h @ wd for h, wd in zip(hs, ws)], mesh, schedule)
    else:
        hs = [h @ wd for h, wd in zip(_aggregate(sg, hs, mesh, schedule), ws)]
    return [h * nm + bd for h, nm, bd in zip(hs, norms, bs)]


def sharded_cut_edgeform(
    sg: ShardedGraph, ss: Sequence[torch.Tensor], mesh: Mesh, schedule: str = "ring"
) -> torch.Tensor:
    """Relaxed cut (Σ_E w − ⟨S, A_w S⟩)/2 on the sharded SpMM, on the first
    mesh device.  Equal to ``parallel.giant.sharded_cut``; its backward is
    the sharded SpMM's."""
    dev0 = mesh.devices[0]
    total_w = sum(torch.sum(w * m).to(dev0) for w, m in zip(sg.weights, sg.edge_mask))
    a_s = _aggregate(sg, ss, mesh, schedule)
    same = sum(torch.sum(s * a).to(dev0) for s, a in zip(ss, a_s))
    return (total_w - same) / 2.0
