"""The SDDMM's sender-order table and its routes, on the CPU.

The card's op (``ops/segment.py``, ``csrc/sddmm.cu``) sums each node's real
edges in ascending edge id: its in-edges by ``row_ptr``, its out-edges by
the sender-order table that ``core/graph._build_padded_coo`` builds.  Here:
the table against a numpy reference, through batching, indexing and
``.to``; the walk written out in numpy float32, which gives the plain op's
CPU gradients bit for bit (the CPU accumulates the gathers' gradients in
edge order); the plain op unchanged and the CPU route on it; the wrapper's
operand rules.  The kernels themselves run in ``test_torch_port_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gcn_maxcut_tpu_torch.core.graph import graph_from_dense, graph_from_edges, pad_graph_batch
from gcn_maxcut_tpu_torch.data.generate import generate_graph_dataset
from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
from gcn_maxcut_tpu_torch import ops as tops
from gcn_maxcut_tpu_torch.objectives.cut_loss import relaxed_cut_value
from gcn_maxcut_tpu_torch.ops import segment as tseg
from gcn_maxcut_tpu_torch.ops.launches import LAUNCHES


def _graphs():
    """Symmetric, directed (repeats, self loops), dense-built, and edgeless
    graphs, each with padded slots."""
    rng = np.random.default_rng(0)
    dense = (rng.random((30, 30)) < 0.2) * rng.random((30, 30))
    return {
        "symmetric": graph_from_edges(rng.integers(0, 50, (120, 2)), 50, e_pad=384),
        "directed": graph_from_edges(rng.integers(0, 40, (200, 2)), 40, symmetrize=False,
                                     e_pad=256),
        "dense": graph_from_dense(dense.astype(np.float32)),
        "edgeless": graph_from_edges(np.zeros((0, 2), np.int64), 10),
    }


def _reference_table(senders: np.ndarray, m: int, n_pad: int, e_pad: int):
    """Edge ids grouped by sender, ascending in a group, real edges first;
    then the padded slots in order; pointers over the real edges."""
    groups = [[i for i in range(m) if senders[i] == u] for u in range(n_pad)]
    order = [i for grp in groups for i in grp] + list(range(m, e_pad))
    ptr = np.concatenate([[0], np.cumsum([len(grp) for grp in groups])])
    return np.asarray(order, np.int32), ptr.astype(np.int32)


@pytest.mark.parametrize("kind", ["symmetric", "directed", "dense", "edgeless"])
def test_the_sender_order_table_equals_a_numpy_reference(kind):
    g = _graphs()[kind]
    m = int(g.n_edges)
    order, ptr = _reference_table(g.senders.numpy(), m, g.n_pad, g.e_pad)
    assert g.sender_order.dtype == g.sender_ptr.dtype == torch.int32
    np.testing.assert_array_equal(g.sender_order.numpy(), order)
    np.testing.assert_array_equal(g.sender_ptr.numpy(), ptr)
    assert int(g.sender_ptr[-1]) == m
    # every real edge once, in a group that is its sender's
    so, sp, s = g.sender_order.numpy(), g.sender_ptr.numpy(), g.senders.numpy()
    assert sorted(so[:m]) == list(range(m))
    for u in range(g.n_pad):
        ids = so[sp[u]:sp[u + 1]]
        assert (s[ids] == u).all() and (np.diff(ids) > 0).all()


def test_the_table_survives_batching_indexing_and_to():
    specs, _ = generate_graph_dataset(3, 20, 30, 3, 5, base_seed=4)
    graphs = process_graphs(specs, DataConfig(max_nodes=32)).graphs
    batch = pad_graph_batch([graphs[k] for k in sorted(graphs)])
    assert batch.sender_order.shape == (3, batch.e_pad)
    assert batch.sender_ptr.shape == (3, batch.n_pad + 1)
    moved = batch.to(torch.device("cpu"))
    for i, k in enumerate(sorted(graphs)):
        for g in (batch.index(i), moved.index(i)):
            assert torch.equal(g.sender_order, graphs[k].sender_order)
            assert torch.equal(g.sender_ptr, graphs[k].sender_ptr)
    with pytest.raises(ValueError, match="disagree on having sender_order"):
        pad_graph_batch([graphs[0], dataclasses.replace(graphs[1], sender_order=None)])


def _walk(g, x: np.ndarray, y: np.ndarray, de: np.ndarray):
    """The kernel's backward in numpy float32: for each (node, class), its
    real out-edges by the sender-order table and its real in-edges by
    ``row_ptr``, ascending, each product and sum rounded on its own."""
    f = np.float32
    s, r, mask = g.senders.numpy(), g.receivers.numpy(), g.edge_mask.numpy()
    so, sp, rp, m = g.sender_order.numpy(), g.sender_ptr.numpy(), g.row_ptr.numpy(), int(g.n_edges)
    dx, dy = np.zeros_like(x), np.zeros_like(y)
    for u in range(g.n_pad):
        for i in so[sp[u]:sp[u + 1]]:
            dx[u] = (dx[u] + f(de[i] * mask[i]) * y[r[i]]).astype(f)
        for i in range(rp[u], min(rp[u + 1], m)):
            dy[u] = (dy[u] + f(de[i] * mask[i]) * x[s[i]]).astype(f)
    return dx, dy


@pytest.mark.parametrize("kind", ["symmetric", "directed", "dense", "edgeless"])
def test_the_kernels_walk_gives_the_plain_cpu_gradients(kind):
    g = _graphs()[kind]
    rng = np.random.default_rng(1)
    x, y = (rng.standard_normal((g.n_pad, 3)).astype(np.float32) for _ in range(2))
    de = rng.standard_normal(g.e_pad).astype(np.float32)
    xt, yt = torch.tensor(x, requires_grad=True), torch.tensor(y, requires_grad=True)
    gx, gy = torch.autograd.grad(tseg.sddmm_plain(g, xt, yt), [xt, yt], torch.tensor(de))
    dx, dy = _walk(g, x, y, de)
    np.testing.assert_array_equal(gx.numpy(), dx)
    np.testing.assert_array_equal(gy.numpy(), dy)
    # one tensor as x and y: the two walks added once
    st = torch.tensor(x, requires_grad=True)
    (gs,) = torch.autograd.grad(tseg.sddmm_plain(g, st, st), [st], torch.tensor(de))
    dx, dy = _walk(g, x, x, de)
    np.testing.assert_array_equal(gs.numpy(), (dx + dy).astype(np.float32))


def test_the_cpu_route_is_the_plain_op_and_launches_nothing():
    g = _graphs()["symmetric"]
    rng = np.random.default_rng(2)
    s = torch.softmax(torch.tensor(rng.standard_normal((g.n_pad, 3)), dtype=torch.float32), -1)
    before = dict(LAUNCHES)
    e = tseg.sddmm(g, s, s)
    assert tops.sddmm is tseg.sddmm and LAUNCHES == before
    want = (s[g.senders.long()] * s[g.receivers.long()]).sum(-1) * g.edge_mask
    assert torch.equal(e, want) and torch.equal(e, tseg.sddmm_plain(g, s, s))
    assert (e[int(g.n_edges):] == 0).all()
    # the cut loss on the CPU: the plain op's value and gradient
    a = s.clone().requires_grad_(True)
    b = s.clone().requires_grad_(True)
    cut = relaxed_cut_value(g, a)
    ref = torch.sum(g.weights * (g.edge_mask - tseg.sddmm_plain(g, b, b) * g.edge_mask)) / 2
    assert torch.equal(cut, ref)
    assert torch.equal(*(torch.autograd.grad(v, [t])[0] for v, t in ((cut, a), (ref, b))))


def test_the_cards_operand_rules_refuse_what_the_kernels_do_not_take():
    """``_sddmm_check`` (it launches nothing) on CPU tensors: each rule raises
    before the last one, which wants the operands on a card."""
    graphs = process_graphs(generate_graph_dataset(2, 20, 20, 3, 3, base_seed=1)[0],
                            DataConfig(max_nodes=24)).graphs
    g = graphs[0]
    x = torch.rand(g.n_pad, 3)
    with pytest.raises(ValueError, match="sender-order"):
        tseg._sddmm_check(dataclasses.replace(g, sender_ptr=None), x, x)
    with pytest.raises(ValueError, match="not a batch"):
        tseg._sddmm_check(pad_graph_batch([graphs[0], graphs[1]]), x, x)
    with pytest.raises(ValueError, match="contiguous torch.int32"):
        tseg._sddmm_check(dataclasses.replace(g, sender_order=g.sender_order.long()), x, x)
    with pytest.raises(ValueError, match="float32"):
        tseg._sddmm_check(g, x.double(), x.double())
    with pytest.raises(ValueError, match="float32"):
        tseg._sddmm_check(g, x, x.half())
    with pytest.raises(ValueError, match=r"\[n_pad"):
        tseg._sddmm_check(g, x[:5], x[:5])
    with pytest.raises(ValueError, match=r"\[n_pad"):
        tseg._sddmm_check(g, x, torch.rand(g.n_pad, 4))
    with pytest.raises(ValueError, match="contiguous"):
        tseg._sddmm_check(g, x, torch.rand(3, g.n_pad).T)
    with pytest.raises(ValueError, match="one card"):
        tseg._sddmm_check(g, x, x)
