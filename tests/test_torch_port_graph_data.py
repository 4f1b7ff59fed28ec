"""Port parity: graph generation, terminal normalisation and the padded
Graph container give exactly the JAX package's values for the same seed."""

import numpy as np
import pytest
import torch

import gcn_maxcut_tpu.core.graph as jgraph
import gcn_maxcut_tpu.data.generate as jgen
import gcn_maxcut_tpu.data.process as jproc
import gcn_maxcut_tpu_torch.core.graph as tgraph
import gcn_maxcut_tpu_torch.data.generate as tgen
import gcn_maxcut_tpu_torch.data.process as tproc

FIELDS = (
    "senders", "receivers", "weights", "edge_mask", "row_ptr", "degrees",
    "node_mask", "n_nodes", "n_edges", "ell_senders", "ell_weights",
    "ell_mask",
)
# the port's own fields, which the JAX package's graph does not carry: the
# sender-order table of the card's SDDMM backward (ops/segment.sddmm)
PORT_FIELDS = ("sender_order", "sender_ptr")


def assert_graph_equal(gj, gt):
    for f in PORT_FIELDS:
        assert not hasattr(gj, f) and getattr(gt, f) is not None, f
    for f in FIELDS:
        a, b = getattr(gj, f), getattr(gt, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a, b = np.asarray(a), b.numpy()
            assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("n,d,seed", [(40, 3, 0), (60, 6, 7), (101, 4, 123)])
def test_random_regular_edges_same_as_jax(n, d, seed):
    np.testing.assert_array_equal(
        jgen.random_regular_edges(n, d, seed=seed),
        tgen.random_regular_edges(n, d, seed=seed),
    )


def test_gnp_and_terminals_same_as_jax():
    np.testing.assert_array_equal(
        jgen.gnp_edges(50, 0.2, seed=3), tgen.gnp_edges(50, 0.2, seed=3)
    )
    assert jgen.generate_unique_terminals(50, 3, seed=9) == \
        tgen.generate_unique_terminals(50, 3, seed=9)
    for gt in ("reg", "prob"):
        sj = jgen.generate_graph(36, 4, gt, p=0.2, seed=5)
        st = tgen.generate_graph(36, 4, gt, p=0.2, seed=5)
        np.testing.assert_array_equal(sj.edges, st.edges)
        assert sj.terminals == st.terminals and sj.degree == st.degree


@pytest.mark.parametrize(
    "terminals", [[5, 9, 2], [2, 0, 1], [1, 2, 0], [0, 7, 1], [0, 1, 2]]
)
def test_terminal_normalisation_same_as_jax(terminals):
    edges = tgen.random_regular_edges(12, 3, seed=1)
    np.testing.assert_array_equal(
        jproc.terminal_permutation(12, terminals),
        tproc.terminal_permutation(12, terminals),
    )
    sj = jproc.normalize_terminals(jgen.GraphSpec(12, edges, terminals))
    st = tproc.normalize_terminals(tgen.GraphSpec(12, edges, terminals))
    np.testing.assert_array_equal(sj.edges, st.edges)
    assert sj.terminals == st.terminals == [0, 1, 2]


def test_dataset_pipeline_same_fields_as_jax():
    gj, _ = jgen.generate_graph_dataset(4, 30, 46, 3, 6, base_seed=11)
    gt, tt = tgen.generate_graph_dataset(4, 30, 46, 3, 6, base_seed=11)
    assert sorted(gj) == sorted(gt)
    dj = jproc.process_graphs(gj, jproc.DataConfig(max_nodes=64))
    dt = tproc.process_graphs(gt, tproc.DataConfig(max_nodes=64))
    for k in sorted(dj.graphs):
        np.testing.assert_array_equal(dj.specs[k].edges, dt.specs[k].edges)
        assert_graph_equal(dj.graphs[k], dt.graphs[k])
        assert dt.graphs[k].symmetric
    bj = jgraph.pad_graph_batch([dj.graphs[k] for k in sorted(dj.graphs)])
    bt = tgraph.pad_graph_batch([dt.graphs[k] for k in sorted(dt.graphs)])
    assert_graph_equal(bj, bt)
    assert_graph_equal(dj.graphs[2], bt.index(2))
    for values in ("weights", "mask"):
        for width in (None, 20, 64):
            np.testing.assert_array_equal(
                np.asarray(jgraph.dense_adjacency(dj.graphs[1], width, values)),
                tgraph.dense_adjacency(dt.graphs[1], width, values).numpy(),
            )


def test_graph_from_dense_and_edges_options_same_as_jax():
    rng = np.random.default_rng(4)
    a = np.triu((rng.random((30, 30)) < 0.2) * rng.random((30, 30)), 1)
    sym = (a + a.T).astype(np.float32)
    assert_graph_equal(jgraph.graph_from_dense(sym), tgraph.graph_from_dense(sym))
    assert tgraph.graph_from_dense(sym).symmetric
    asym = a.astype(np.float32)
    gt = tgraph.graph_from_dense(asym, n_pad=40, e_pad=256, ell_width=8)
    assert_graph_equal(
        jgraph.graph_from_dense(asym, n_pad=40, e_pad=256, ell_width=8), gt
    )
    assert not gt.symmetric
    edges = tgen.random_regular_edges(20, 4, seed=2)
    w = rng.random(edges.shape[0]).astype(np.float32)
    kw = dict(weights=w, n_pad=24, symmetrize=False, ell_width=0)
    gt = tgraph.graph_from_edges(edges, 20, **kw)
    assert_graph_equal(jgraph.graph_from_edges(edges, 20, **kw), gt)
    assert not gt.symmetric
    gr = tgraph.graph_from_edges(edges, 20, reorder="rcm")
    assert_graph_equal(jgraph.graph_from_edges(edges, 20, reorder="rcm"), gr)
    np.testing.assert_array_equal(
        gr.reorder_perm.numpy(),
        np.asarray(jgraph.graph_from_edges(edges, 20, reorder="rcm").reorder_perm))
    with pytest.raises(ValueError, match="reorder"):
        tgraph.graph_from_edges(edges, 20, reorder="metis")
    with pytest.raises(ValueError, match="ell_width"):
        tgraph.graph_from_edges(edges, 20, ell_width=2)
    assert isinstance(gt.to("cpu").senders, torch.Tensor)
