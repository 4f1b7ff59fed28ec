"""The greedy climb's two orders and its route (``ops/climb.py``,
``baselines/local_search.py``), on the CPU.

``csrc/climb.cu`` climbs each start alone to its end; the lockstep loop
climbs all starts together.  Each start makes exactly min(moves to its
local optimum, max_steps) moves either way, which is what the kernel rests
on: here ``greedy_climb_plain``, the kernel's order in plain PyTorch, is
held to the lockstep climb bit for bit.  The kernel itself runs only on
the card (``tests/test_torch_port_cuda.py``).
"""

import types

import numpy as np
import pytest
import torch

from gcn_maxcut_tpu_torch.baselines import local_search as tls
from gcn_maxcut_tpu_torch.core.graph import graph_from_edges
from gcn_maxcut_tpu_torch.data.generate import random_regular_edges
from gcn_maxcut_tpu_torch.objectives.cut_loss import hard_cut_value
from gcn_maxcut_tpu_torch.ops import climb as tclimb

STEPS = [1, 5, 16, 17, 500]


def _graph(weighted: bool):
    """A 6-regular graph on 90 nodes padded to 96, unit or non-integer
    weights (the same weight both ways)."""
    rng = np.random.default_rng(3)
    edges = np.asarray(random_regular_edges(90, 6, 3))
    w = rng.uniform(0.1, 2.0, len(edges)).astype(np.float32) if weighted else None
    return graph_from_edges(edges, 90, weights=w, n_pad=96)


def _starts(n_pad: int, count: int, seed: int) -> torch.Tensor:
    starts = torch.tensor(np.random.default_rng(seed).integers(0, 3, (count, n_pad)))
    starts[:, :3] = torch.arange(3)
    return starts


@pytest.fixture(scope="module", params=["unit", "weighted"])
def case(request):
    g = _graph(request.param == "weighted")
    starts = torch.cat([_starts(g.n_pad, 5, 1), torch.zeros((1, g.n_pad), dtype=torch.int64)])
    full, moves = tclimb.greedy_climb(g, starts, max_steps=500)
    assert int(moves.max()) < 500                        # every start reached its optimum
    return g, starts, moves


@pytest.mark.parametrize("max_steps", STEPS)
def test_each_start_alone_equals_the_lockstep_climb(case, max_steps):
    """The kernel's order (each start to its end) against all starts in
    lockstep, with the cap cutting climbs short at 1, 5, 16 and 17."""
    g, starts, full_moves = case
    alone, moves = tclimb.greedy_climb(g, starts, max_steps=max_steps)
    lockstep, cut = tls.greedy_flip_local_search(g, starts, max_steps=max_steps)
    assert torch.equal(alone, lockstep)
    assert torch.equal(hard_cut_value(g, alone), cut)
    assert torch.equal(moves, torch.clamp(full_moves, max=max_steps))
    if max_steps < 500:
        assert (full_moves > max_steps).any()            # the cap stopped a climb


def test_the_zero_start_breaks_its_ties_as_argmax_does(case):
    """An all-zero start: its first moves share the best gain, taken at the
    lowest flat index (node, then class)."""
    g, _, _ = case
    zero = torch.zeros((1, g.n_pad), dtype=torch.int64)
    one, moves = tclimb.greedy_climb(g, zero, max_steps=1)
    gains = tclimb.move_gains(g, zero[0], 3, 3).reshape(-1)
    first = int(torch.nonzero(gains == gains.max())[0])
    assert int(moves[0]) == 1 and int(one[0, first // 3]) == first % 3
    assert torch.equal(one, tls.greedy_flip_local_search(g, zero, max_steps=1)[0])


def test_csr_order_sums_equal_the_coo_index_add():
    """The kernel's W: each row summed from 0 in CSR order, a float32
    multiply and add a term, equals the plain step's COO ``index_add`` bit
    for bit, with non-integer weights."""
    g = _graph(True)
    asn = _starts(g.n_pad, 1, 2)[0]
    want = tclimb.class_weights(g, asn, 3).numpy()
    s, w, m, rp = (g.senders.numpy(), g.weights.numpy(), g.edge_mask.numpy(), g.row_ptr.numpy())
    got = np.zeros((g.n_pad, 3), np.float32)
    for i in range(g.n_pad):
        for e in range(rp[i], min(rp[i + 1], int(g.n_edges))):
            a = int(asn[s[e]])
            got[i, a] = np.float32(got[i, a] + np.float32(w[e] * m[e]))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _fake(device: str, n_pad: int, symmetric: bool):
    return types.SimpleNamespace(device=torch.device(device), n_pad=n_pad, symmetric=symmetric)


@pytest.mark.parametrize("n_pad,k,symmetric,device,kernel", [
    (1000, 3, True, "cuda", True),        # the decode's graphs
    (14_519, 3, True, "cuda", True),      # the largest start a block holds at k = 3
    (14_520, 3, True, "cuda", False),     # one row more: the captured route
    (11_615, 4, True, "cuda", True),      # the largest at k = 4
    (11_616, 4, True, "cuda", False),
    (1000, 3, False, "cuda", False),      # not symmetric: needs the transposed list
    (1000, 3, True, "cpu", False),        # the CPU climbs in lockstep, eagerly
])
def test_the_route_is_the_kernel_for_symmetric_graphs_that_fit(n_pad, k, symmetric, device,
                                                               kernel):
    """The start's W and asn, (k + 1)·4 bytes a row, and the reduction's
    132 bytes within the block's 232,448."""
    assert tls._on_kernel(_fake(device, n_pad, symmetric), k) is kernel
    assert tclimb.kernel_fits(n_pad, k, symmetric) is (kernel or device == "cpu")
    assert (tclimb.smem_bytes(n_pad, k) <= 232_448) is (kernel or not symmetric or
                                                         device == "cpu")


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    g = _graph(False)
    starts = _starts(g.n_pad, 2, 0)
    with pytest.raises(ValueError, match="int64"):
        tclimb._check(g, starts.int(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        tclimb._check(g, starts.t().contiguous().t(), 3)
    with pytest.raises(ValueError, match="int64"):
        tclimb._check(g, starts[:, :-1].contiguous(), 3)
    with pytest.raises(ValueError, match="symmetric"):
        tclimb._check(graph_from_edges([(0, 1), (1, 2)], 3, n_pad=96, symmetrize=False),
                      starts, 3)
    with pytest.raises(ValueError, match="limit"):
        tclimb._check(g, starts, 4000)
    tclimb._check(g, starts, 3)                          # the decode's operands pass
