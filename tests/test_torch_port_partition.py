"""Port parity: partitioners and the node-sharded graph (``parallel/partition.py``).

The JAX package's ``shard_graph`` and the port's run on the same numpy COO
arrays; every field of the port's ``ShardedGraph`` (shard d's tensor) is
held equal to the JAX field's ``[d]`` slice, on both assembly lanes, and
``global_to_local`` equal.  Only the JAX planner runs (numpy), never a
Pallas kernel.  The RCM lane is compared on this machine only: SciPy's RCM
differs between versions.
"""

import numpy as np
import pytest
import torch

from gcn_maxcut_tpu.data.generate import random_regular_edges
from gcn_maxcut_tpu.parallel import partition as jpart
from gcn_maxcut_tpu_torch.bench.microbench import banded_random_edges
from gcn_maxcut_tpu_torch.parallel import partition as tpart
from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh

ARRAYS = ("senders", "receivers", "weights", "edge_mask", "degrees", "node_mask",
          "ell_senders", "ell_weights", "ell_mask", "bell_senders", "bell_weights",
          "bell_out_senders", "bell_out_receivers", "bell_out_weights")


def _coo(edges):
    return (np.concatenate([edges[:, 0], edges[:, 1]]),
            np.concatenate([edges[:, 1], edges[:, 0]]))


def _assert_same(got, ref, skip=()):
    tsg, tg2l = got
    jsg, jg2l = ref
    np.testing.assert_array_equal(tg2l, jg2l)
    assert (tsg.num_shards, tsg.n_shard, tsg.e_group, tsg.n_nodes, tsg.symmetric) == (
        jsg.num_shards, jsg.n_shard, jsg.e_group, int(jsg.n_nodes), jsg.symmetric)
    assert (tsg.bell_block, tsg.bell_wp) == (jsg.bell_block, jsg.bell_wp)
    for f in ARRAYS:
        if f in skip:
            continue
        a, b = getattr(tsg, f), getattr(jsg, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        b = np.asarray(b)
        assert len(a) == b.shape[0], f
        for d, t in enumerate(a):
            assert t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), b[d], err_msg=f"{f}[{d}]")


def test_partitioners_match_jax():
    s, r = _coo(random_regular_edges(600, 6, seed=1))
    for D in (1, 3, 4):
        np.testing.assert_array_equal(tpart.partition_nodes_contiguous(600, D),
                                      jpart.partition_nodes_contiguous(600, D))
        np.testing.assert_array_equal(tpart.partition_nodes_bfs(s, r, 600, D),
                                      jpart.partition_nodes_bfs(s, r, 600, D))
        np.testing.assert_array_equal(tpart.partition_nodes_metis(s, r, 600, D, seed=2),
                                      jpart.partition_nodes_metis(s, r, 600, D, seed=2))


def test_partition_quality_matches_jax():
    s, r = _coo(banded_random_edges(512, 4, 15, 0))
    rng = np.random.default_rng(0)
    for owner in (tpart.partition_nodes_contiguous(512, 8), rng.integers(0, 5, 512),
                  tpart.partition_nodes_metis(s, r, 512, 4)):
        assert tpart.partition_quality(owner, s, r) == jpart.partition_quality(owner, s, r)


def test_is_symmetric_coo_matches_jax():
    s, r = _coo(random_regular_edges(100, 4, seed=3))
    w = np.ones(s.shape[0], np.float32)
    w_bad = w.copy()
    w_bad[3] = 2.0
    for args, expect in (((s, r, w), True), ((s, r, w_bad), False),
                         ((s[:-1], r[:-1], w[:-1]), False), ((s, r[:-1], w), False)):
        assert tpart.is_symmetric_coo(*args) is expect
        assert jpart.is_symmetric_coo(*args) is expect


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("D", [1, 2, 4])
def test_shard_graph_matches_jax(D, use_native):
    n = 300
    s, r = _coo(random_regular_edges(n, 6, seed=4))
    w = np.random.default_rng(5).random(s.shape[0]).astype(np.float32)   # not symmetric
    owner = jpart.partition_nodes_bfs(s, r, n, D)
    for kw in (dict(), dict(weights=w, owner=owner), dict(build_ell=False, owner=owner),
               dict(edge_pad_multiple=32)):
        _assert_same(tpart.shard_graph(s, r, n, D, use_native=use_native, **kw),
                     jpart.shard_graph(s, r, n, D, use_native=use_native, **kw))


def test_shard_graph_lanes_agree_on_unbalanced_metis_shards():
    # METIS does not enforce its imbalance cap: n_shard is the largest shard
    n = 1000
    s, r = _coo(banded_random_edges(n, 6, 31, 2))
    owner = tpart.partition_nodes_metis(s, r, n, 3, imbalance=0.0)
    sizes = np.bincount(owner, minlength=3)
    native = tpart.shard_graph(s, r, n, 3, owner=owner)
    assert native[0].n_shard >= sizes.max()
    _assert_same(native, jpart.shard_graph(s, r, n, 3, owner=owner))
    _assert_same(tpart.shard_graph(s, r, n, 3, owner=owner, use_native=False), native)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_shard_graph_rcm_lane_matches_jax(D):
    s, r = _coo(random_regular_edges(256, 4, seed=6))
    _assert_same(tpart.shard_graph(s, r, 256, D, local_reorder="rcm"),
                 jpart.shard_graph(s, r, 256, D, local_reorder="rcm"))
    with pytest.raises(ValueError, match="local_reorder"):
        tpart.shard_graph(s, r, 256, D, local_reorder="metis")


@pytest.mark.parametrize("D,reorder", [(2, "off"), (4, "rcm")])
def test_shard_graph_block_ell_plan_matches_jax(D, reorder):
    # a banded graph whose ids are shuffled only within small blocks: every
    # shard's hop-0 subgraph bands, so each gets a plan of one geometry
    n = 8192
    s, r = _coo(banded_random_edges(n, 8, 63, 1))
    got = tpart.shard_graph(s, r, n, D, local_reorder=reorder, block_ell=True)
    assert got[0].bell_block is not None and got[0].n_shard % 1024 == 0
    _assert_same(got, jpart.shard_graph(s, r, n, D, local_reorder=reorder, block_ell=True))


def test_shard_graph_block_ell_expander_keeps_gather_tables():
    # shards of a random regular graph are expanders even after RCM
    n = 8192
    s, r = _coo(random_regular_edges(n, 8, seed=7))
    got = tpart.shard_graph(s, r, n, 2, local_reorder="rcm", block_ell=True)
    assert got[0].bell_senders is None and got[0].ell_senders is not None
    _assert_same(got, jpart.shard_graph(s, r, n, 2, local_reorder="rcm", block_ell=True))


def test_asymmetric_graph_gets_no_hop0_plan():
    # the banded graph with one direction of each edge: Aᵀ ≠ A.  The JAX
    # package plans hop 0 here anyway (its backward then computes A·dy); the
    # port keeps the gather tables, and every other field is the JAX one
    n = 8192
    e = banded_random_edges(n, 8, 63, 1)
    s, r = e[:, 0], e[:, 1]
    got = tpart.shard_graph(s, r, n, 2, block_ell=True)
    ref = jpart.shard_graph(s, r, n, 2, block_ell=True)
    assert not got[0].symmetric and not ref[0].symmetric
    assert got[0].bell_senders is None and got[0].bell_block is None
    assert ref[0].bell_senders is not None
    _assert_same(got, (ref[0].replace(bell_block=None, bell_wp=None), ref[1]),
                 skip=[f for f in ARRAYS if f.startswith("bell_")])


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_hub_trips_the_ell_skew_ceiling_in_both_packages(use_native):
    # a ring plus one hub joined to every 4th node: the hub's in-degree (64)
    # is far above the mean occupied in-degree, so neither package builds
    # ELL tables; without the hub both do
    n = 256
    ring = np.stack([np.arange(n), (np.arange(n) + 1) % n], axis=1)
    spokes = np.stack([np.zeros(n // 4, np.int64), np.arange(1, n, 4)], axis=1)
    for edges, has_ell in ((ring, True), (np.concatenate([ring, spokes]), False)):
        s, r = _coo(edges)
        got = tpart.shard_graph(s, r, n, 2, use_native=use_native)
        assert (got[0].ell_senders is not None) is has_ell
        _assert_same(got, jpart.shard_graph(s, r, n, 2, use_native=use_native))


def test_sharded_graph_moves_each_shard_onto_its_mesh_device():
    s, r = _coo(random_regular_edges(64, 4, seed=8))
    sg, _ = tpart.shard_graph(s, r, 64, 2)
    placed = sg.to(make_mesh(devices=["cpu"] * 2))
    assert all(t.device == torch.device("cpu") for t in placed.senders + placed.ell_senders)
    with pytest.raises(ValueError, match="mesh of 3"):
        sg.to(make_mesh(devices=["cpu"] * 3))
