"""Port parity: npz datasets, checkpoints, and the trainer's checkpoints and
resume against ``gcn_maxcut_tpu/{data/io,train/checkpoint,train/loop}.py``.

Files written by either package load in the other.  The optimizer-state
names are read from files the JAX package writes, not listed here.
Training starts both frameworks from the same weights; loss histories
agree at rtol 1e-4, as in ``tests/test_torch_port_train_decode.py``.
"""

import jax
import numpy as np
import pytest
import torch

import gcn_maxcut_tpu.core.graph as jgraph
import gcn_maxcut_tpu.data as jdata
import gcn_maxcut_tpu.data.io as jio
import gcn_maxcut_tpu.train as jtrain
import gcn_maxcut_tpu.train.checkpoint as jckpt
import gcn_maxcut_tpu_torch.core.graph as tgraph
import gcn_maxcut_tpu_torch.data.generate as tgen
import gcn_maxcut_tpu_torch.data.io as tio
import gcn_maxcut_tpu_torch.data.process as tproc
import gcn_maxcut_tpu_torch.train.checkpoint as tckpt
import gcn_maxcut_tpu_torch.train.loop as tloop
from gcn_maxcut_tpu_torch.convert import params_from_jax
from gcn_maxcut_tpu_torch.train.config import TrainingConfig

N_PAD = 64


@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_graphs=3, min_nodes=40, max_nodes=56, min_degree=3,
              max_degree=6, base_seed=21)
    dj = jdata.process_graphs(jdata.generate_graph_dataset(**kw)[0],
                              jdata.DataConfig(max_nodes=N_PAD))
    dt = tproc.process_graphs(tgen.generate_graph_dataset(**kw)[0],
                              tproc.DataConfig(max_nodes=N_PAD))
    bj = jgraph.pad_graph_batch([dj.graphs[k] for k in sorted(dj.graphs)])
    bt = tgraph.pad_graph_batch([dt.graphs[k] for k in sorted(dt.graphs)])
    return dj, dt, bj, bt


def _assert_same_dataset(a, b):
    assert sorted(a.specs) == sorted(b.specs)
    assert a.config.__dict__ == b.config.__dict__
    for k in a.specs:
        sa, sb = a.specs[k], b.specs[k]
        assert (sa.n_nodes, list(sa.terminals), sa.degree) == \
            (sb.n_nodes, list(sb.terminals), sb.degree)
        np.testing.assert_array_equal(sa.edges, sb.edges)
        assert (sa.weights is None) == (sb.weights is None)
        if sa.weights is not None:
            np.testing.assert_array_equal(sa.weights, sb.weights)
        for f in ("senders", "receivers", "weights", "edge_mask", "node_mask"):
            np.testing.assert_array_equal(np.asarray(getattr(a.graphs[k], f)),
                                          np.asarray(getattr(b.graphs[k], f)))


def test_datasets_load_across_packages(datasets, tmp_path):
    dj, dt, _, _ = datasets
    spec = tgen.GraphSpec(n_nodes=6, edges=np.array([[0, 3], [1, 4], [2, 5], [3, 4]]),
                          terminals=[3, 4, 5],
                          weights=np.array([1.0, 2.0, 0.5, 3.0], np.float32))
    dt_w = tproc.process_graphs({**dt.specs, 7: spec}, dt.config)   # one weighted graph
    tio.save_dataset(dt_w, tmp_path / "port.npz")
    _assert_same_dataset(jio.load_dataset(tmp_path / "port.npz"), dt_w)
    jio.save_dataset(dj, tmp_path / "jax.npz")
    _assert_same_dataset(tio.load_dataset(tmp_path / "jax.npz"), dj)
    _assert_same_dataset(tio.load_dataset(tmp_path / "port.npz"), dt_w)
    # the reference's text format, and the pickle helpers
    (tmp_path / "g.txt").write_text("[2, 0, 1]\n0 1 2.5\n3 1\n\n2 3 1\n")
    a, b = tio.load_text_graph(tmp_path / "g.txt"), jio.load_text_graph(tmp_path / "g.txt")
    assert (a.n_nodes, a.terminals) == (b.n_nodes, b.terminals) == (4, [2, 0, 1])
    np.testing.assert_array_equal(a.edges, b.edges)
    np.testing.assert_array_equal(a.weights, b.weights)
    tio.save_object({"x": [1, 2]}, tmp_path / "o.pkl")
    assert tio.load_object(tmp_path / "o.pkl") == jio.load_object(tmp_path / "o.pkl")


def _jax_checkpoint(datasets, path, feature_mode, epochs=3):
    """A JAX-trained checkpoint (Adam moments nonzero) and its templates."""
    cfg = jtrain.TrainingConfig(n_nodes=N_PAD, seed=4, number_epochs=epochs,
                                feature_mode=feature_mode, learning_rate=5e-3)
    state = jtrain.setup_train_state(cfg)
    params = state.params
    opt_state = state.opt_state
    for _ in range(epochs):
        grads = jax.tree_util.tree_map(lambda p: 0.1 * np.ones_like(p), params)
        updates, opt_state = state.optimizer.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    jckpt.save_checkpoint(path, params=params, opt_state=opt_state, epoch=epochs - 1,
                          loss_history=[-3.0, -4.5, -5.0], embed=params["embed"], config=cfg)
    return cfg, params, opt_state


@pytest.mark.parametrize("feature_mode", ["adjacency", "embedding"])
def test_checkpoints_load_across_packages(datasets, tmp_path, feature_mode):
    path = tmp_path / "jax_ck.npz"
    cfg_j, params_j, opt_j = _jax_checkpoint(datasets, path, feature_mode)
    with np.load(path) as f:
        opt_keys = sorted(k for k in f.files if k.startswith("opt:"))
    cfg_t = TrainingConfig(n_nodes=N_PAD, seed=9, feature_mode=feature_mode)
    state = tloop.setup_train_state(cfg_t, device="cpu")
    assert sorted("opt:" + k for k in tckpt.flatten_tree(state.opt_state())) == opt_keys

    # JAX -> port: every leaf, the optimizer state and the meta
    params, opt, embed, meta = tckpt.load_checkpoint(path, state.params(), state.opt_state(),
                                                     state.embed)
    flat_j = {k: np.asarray(v) for k, v in jckpt._flatten_with_paths(params_j).items()}
    for k, v in tckpt.flatten_tree(params).items():
        np.testing.assert_array_equal(v.numpy(), flat_j[k])
    np.testing.assert_array_equal(embed.numpy(), flat_j["embed"])
    flat_opt_j = {k: np.asarray(v) for k, v in jckpt._flatten_with_paths(opt_j).items()}
    for k, v in tckpt.flatten_tree(opt).items():
        np.testing.assert_array_equal(v.numpy(), flat_opt_j[k])
    assert meta["epoch"] == 2 and meta["loss_history"] == [-3.0, -4.5, -5.0]
    assert meta["config"] == TrainingConfig.from_json(cfg_j.to_json())
    state.load(params, opt)
    assert state.optimizer.count == 3
    assert float(state.optimizer.nu[0].abs().sum()) > 0

    # port -> JAX: the JAX loader takes the port's file with its own templates
    out = tckpt.save_checkpoint(tmp_path / "port_ck", params=state.params(),
                                opt_state=state.opt_state(), epoch=5,
                                loss_history=[1.0], config=cfg_t)
    assert out.name == "port_ck.npz"
    tmpl = jtrain.setup_train_state(cfg_j)
    pj, oj, _, mj = jckpt.load_checkpoint(out, tmpl.params, tmpl.opt_state)
    for k, v in jckpt._flatten_with_paths(pj).items():
        np.testing.assert_array_equal(np.asarray(v), flat_j[k])
    for k, v in jckpt._flatten_with_paths(oj).items():
        np.testing.assert_array_equal(np.asarray(v), flat_opt_j[k])
    assert mj["epoch"] == 5 and mj["config"] == cfg_j.__class__.from_json(cfg_t.to_json())


def test_checkpoint_bf16_leaves_and_shape_check(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) / 7, "b": torch.ones(2)}
    path = tckpt.save_checkpoint(tmp_path / "bf", params=tree)
    with np.load(path) as f:
        assert f["params:a"].dtype == np.float32
    got, _, _, _ = tckpt.load_checkpoint(path, tree)
    assert got["a"].dtype == torch.bfloat16 and torch.equal(got["a"], tree["a"])
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_checkpoint(path, {"a": torch.zeros(3, 2), "b": torch.ones(2)})
    assert tckpt.checkpoint_name("d/m", 3, -12.5) == jckpt.checkpoint_name("d/m", 3, -12.5)
    assert tckpt.checkpoint_name("d/m") == jckpt.checkpoint_name("d/m") == "d/final_m"


def _train_both(datasets, tmp_path, resume=None, **cfg):
    _, _, bj, bt = datasets
    kw = dict(n_nodes=N_PAD, dropout=0.0, seed=3, learning_rate=5e-3, patience=100, **cfg)
    state = jtrain.setup_train_state(jtrain.TrainingConfig(**kw))
    start = jax.tree_util.tree_map(np.asarray, state.params)
    kj = dict(kw, save_directory=str(tmp_path / "jax" / "m")) if "save_frequency" in cfg else kw
    kt = dict(kw, save_directory=str(tmp_path / "port" / "m")) if "save_frequency" in cfg else kw
    rj = jtrain.train_model(bj, jtrain.TrainingConfig(**kj), state=state,
                            resume_from=None if resume is None else resume[0])
    st = tloop.setup_train_state(TrainingConfig(**kt), params=params_from_jax(start, "cpu"),
                                 device="cpu")
    rt = tloop.train_model(bt, TrainingConfig(**kt), state=st,
                           resume_from=None if resume is None else resume[1])
    return rj, rt


def test_training_writes_the_jax_checkpoints(datasets, tmp_path):
    rj, rt = _train_both(datasets, tmp_path, number_epochs=5, save_frequency=2)
    np.testing.assert_allclose(rt[4], rj[4], rtol=1e-4)
    names_j = sorted(p.name for p in (tmp_path / "jax").iterdir())
    names_t = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names_t == names_j and len(names_t) == 4      # epochs 0, 2, 4 and final
    # the final checkpoint holds the best epoch's parameters
    tmpl = tloop.setup_train_state(TrainingConfig(n_nodes=N_PAD), device="cpu")
    params, _, _, meta = tckpt.load_checkpoint(tmp_path / "port" / "final_m.npz",
                                               tmpl.params())
    for k, v in tckpt.flatten_tree(params).items():
        torch.testing.assert_close(v, tckpt.flatten_tree(rt[0])[k])
    assert meta["epoch"] == 4 and len(meta["loss_history"]) == 5


def test_resume_continues_like_jax(datasets, tmp_path):
    _train_both(datasets, tmp_path, number_epochs=5, save_frequency=2)
    ck = next((tmp_path / "jax").glob("epoch_2_*")).name
    rj, rt = _train_both(datasets, tmp_path / "r", number_epochs=9,
                         resume=(tmp_path / "jax" / ck, tmp_path / "jax" / ck))
    assert len(rj[4]) == len(rt[4]) == 9 and rt[2] == rj[2] == 8
    np.testing.assert_allclose(rt[4], rj[4], rtol=1e-4)
    # from the port's own checkpoint of the same epoch
    _, rt2 = _train_both(datasets, tmp_path / "r2", number_epochs=9,
                         resume=(tmp_path / "jax" / ck, tmp_path / "port" / ck))
    np.testing.assert_allclose(rt2[4], rj[4], rtol=1e-4)
    assert rt2[1] == pytest.approx(rj[1], rel=1e-4)
