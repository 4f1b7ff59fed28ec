"""Port parity: the training variants (batched steps, the cosine schedule,
the quantile and entropy losses), cosine-schedule checkpoints and resume,
and ``train_from_files``, against the JAX package's ``train_model``.

Training starts both frameworks from the same weights (the JAX package's
``setup_train_state``, copied through ``params_from_jax``), with dropout 0.
Loss histories agree at rtol 1e-4, the contract of
``tests/test_torch_port_train_decode.py``.
"""

import jax
import numpy as np
import pytest

import gcn_maxcut_tpu.core.graph as jgraph
import gcn_maxcut_tpu.data as jdata
import gcn_maxcut_tpu.data.io as jio
import gcn_maxcut_tpu.train as jtrain
import gcn_maxcut_tpu.train.checkpoint as jckpt
import gcn_maxcut_tpu_torch.core.graph as tgraph
import gcn_maxcut_tpu_torch.data.generate as tgen
import gcn_maxcut_tpu_torch.data.process as tproc
import gcn_maxcut_tpu_torch.train.checkpoint as tckpt
import gcn_maxcut_tpu_torch.train.loop as tloop
from gcn_maxcut_tpu_torch.convert import params_from_jax
from gcn_maxcut_tpu_torch.train.config import TrainingConfig

N_PAD = 64
N_GRAPHS = 3
GEN = dict(num_graphs=N_GRAPHS, min_nodes=40, max_nodes=56, min_degree=3, max_degree=6,
           base_seed=21)


@pytest.fixture(scope="module")
def batches():
    dj = jdata.process_graphs(jdata.generate_graph_dataset(**GEN)[0],
                              jdata.DataConfig(max_nodes=N_PAD))
    dt = tproc.process_graphs(tgen.generate_graph_dataset(**GEN)[0],
                              tproc.DataConfig(max_nodes=N_PAD))
    return (jgraph.pad_graph_batch([dj.graphs[k] for k in sorted(dj.graphs)]),
            tgraph.pad_graph_batch([dt.graphs[k] for k in sorted(dt.graphs)]))


def _steps_per_epoch(kw):
    return N_GRAPHS if kw.get("step_mode", "per_graph") == "per_graph" else 1


def _train_both(batches, tmp_path=None, resume=None, **cfg):
    """JAX ``train_model`` and the port's from one start; ``resume`` is the
    (JAX, port) checkpoint each continues from."""
    bj, bt = batches
    kw = {**dict(n_nodes=N_PAD, dropout=0.0, seed=3, learning_rate=5e-3, patience=100), **cfg}
    spe = _steps_per_epoch(kw)
    state = jtrain.setup_train_state(jtrain.TrainingConfig(**kw), steps_per_epoch=spe)
    start = jax.tree_util.tree_map(np.asarray, state.params)
    kj, kt = dict(kw), dict(kw)
    if "save_frequency" in cfg:
        kj["save_directory"] = str(tmp_path / "jax" / "m")
        kt["save_directory"] = str(tmp_path / "port" / "m")
    rj = jtrain.train_model(bj, jtrain.TrainingConfig(**kj), state=state,
                            resume_from=None if resume is None else resume[0])
    st = tloop.setup_train_state(TrainingConfig(**kt), steps_per_epoch=spe,
                                 params=params_from_jax(start, "cpu"), device="cpu")
    rt = tloop.train_model(bt, TrainingConfig(**kt), state=st,
                           resume_from=None if resume is None else resume[1])
    return rj, rt


VARIANTS = {
    "batched": dict(step_mode="batched"),
    "batched-sparse": dict(step_mode="batched", aggregation="sparse"),
    "batched-embedding": dict(step_mode="batched", feature_mode="embedding",
                              learning_rate=2e-2),
    "cosine-per_graph": dict(lr_schedule="cosine", learning_rate=2e-2,
                             lr_final_fraction=0.1),
    "cosine-batched": dict(lr_schedule="cosine", step_mode="batched", learning_rate=2e-2),
    "quantile": dict(loss_mode="quantile"),
    "quantile-penalty": dict(loss_mode="quantile", use_penalty=True, penalty=5.0),
    "entropy": dict(entropy_weight=0.5),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_training_matches_jax(batches, variant):
    rj, rt = _train_both(batches, number_epochs=10, **VARIANTS[variant])
    assert len(rt[4]) == len(rj[4]) == 10
    np.testing.assert_allclose(rt[4], rj[4], rtol=1e-4)
    assert rt[1] == pytest.approx(rj[1], rel=1e-4)
    assert rt[2] == rj[2]
    assert rt[4][-1] < rt[4][0]                       # the variant trains


def test_variant_early_stop_matches_jax(batches):
    rj, rt = _train_both(batches, number_epochs=40, learning_rate=3e-2, patience=2,
                         step_mode="batched", lr_schedule="cosine", entropy_weight=0.5)
    assert len(rj[4]) < 40, "early stopping did not fire"
    assert rt[2] == rj[2] and len(rt[4]) == len(rj[4])
    np.testing.assert_allclose(rt[4], rj[4], rtol=1e-4)
    for layer in ("conv1", "conv2"):
        for k in ("w", "b"):
            np.testing.assert_allclose(rt[0][layer][k].numpy(), np.asarray(rj[0][layer][k]),
                                       rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("feature_mode", ["adjacency", "embedding"])
def test_cosine_checkpoints_load_across_packages(tmp_path, feature_mode):
    cfg = jtrain.TrainingConfig(n_nodes=N_PAD, seed=4, number_epochs=5, learning_rate=5e-3,
                                lr_schedule="cosine", feature_mode=feature_mode)
    state = jtrain.setup_train_state(cfg, steps_per_epoch=2)
    params, opt_state = state.params, state.opt_state
    for _ in range(3):
        grads = jax.tree_util.tree_map(lambda p: 0.1 * np.ones_like(p), params)
        updates, opt_state = state.optimizer.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    path = jckpt.save_checkpoint(tmp_path / "jax_ck", params=params, opt_state=opt_state,
                                 epoch=2, loss_history=[-1.0, -2.0, -3.0], config=cfg)
    with np.load(path) as f:
        opt_keys = sorted(k for k in f.files if k.startswith("opt:"))
    count_key = "opt:.inner_state/1/.count" if feature_mode == "adjacency" else "opt:1/.count"
    assert count_key in opt_keys

    cfg_t = TrainingConfig(**{k: getattr(cfg, k) for k in
                              ("n_nodes", "seed", "number_epochs", "learning_rate",
                               "lr_schedule", "feature_mode")})
    st = tloop.setup_train_state(cfg_t, steps_per_epoch=2, device="cpu")
    assert sorted("opt:" + k for k in tckpt.flatten_tree(st.opt_state())) == opt_keys
    # JAX -> port
    p, o, _, _ = tckpt.load_checkpoint(path, st.params(), st.opt_state())
    st.load(p, o)
    assert st.optimizer.count == 3
    flat_j = {k: np.asarray(v) for k, v in jckpt._flatten_with_paths(opt_state).items()}
    for k, v in tckpt.flatten_tree(st.opt_state()).items():
        np.testing.assert_array_equal(v.numpy(), flat_j[k])
    # port -> JAX
    out = tckpt.save_checkpoint(tmp_path / "port_ck", params=st.params(),
                                opt_state=st.opt_state(), epoch=2, config=cfg_t)
    tmpl = jtrain.setup_train_state(cfg, steps_per_epoch=2)
    _, oj, _, _ = jckpt.load_checkpoint(out, tmpl.params, tmpl.opt_state)
    for k, v in jckpt._flatten_with_paths(oj).items():
        np.testing.assert_array_equal(np.asarray(v), flat_j[k])


def test_cosine_resume_continues_like_jax(batches, tmp_path):
    kw = dict(lr_schedule="cosine", learning_rate=2e-2, save_frequency=2)
    _train_both(batches, tmp_path, number_epochs=5, **kw)
    ck = next((tmp_path / "jax").glob("epoch_2_*")).name
    rj, rt = _train_both(batches, tmp_path / "r", number_epochs=9,
                         resume=(tmp_path / "jax" / ck, tmp_path / "port" / ck), **kw)
    assert len(rj[4]) == len(rt[4]) == 9 and rt[2] == rj[2] == 8
    np.testing.assert_allclose(rt[4], rj[4], rtol=1e-4)


def test_train_from_files_matches_jax(tmp_path, monkeypatch):
    paths = []
    for i, seed in enumerate((5, 9)):
        specs, _ = jdata.generate_graph_dataset(**dict(GEN, num_graphs=2, base_seed=seed))
        paths.append(tmp_path / f"ds{i}.npz")
        jio.save_dataset(jdata.process_graphs(specs, jdata.DataConfig(max_nodes=N_PAD)),
                         paths[-1])
    kw = dict(number_epochs=6, learning_rate=1e-2, seed=2, step_mode="batched")
    rj = jtrain.train_from_files([str(p) for p in paths], **kw)
    start = jtrain.setup_train_state(jtrain.TrainingConfig(n_nodes=N_PAD, **kw)).params
    setup = tloop.setup_train_state

    def from_jax_start(config, steps_per_epoch=1, params=None, device=None):
        return setup(config, steps_per_epoch, params_from_jax(start, "cpu"), device)

    monkeypatch.setattr(tloop, "setup_train_state", from_jax_start)
    rt = tloop.train_from_files([str(p) for p in paths], device="cpu", **kw)
    assert len(rt[4]) == len(rj[4]) == 6
    np.testing.assert_allclose(rt[4], rj[4], rtol=1e-4)
    assert rt[2] == rj[2]
