"""Port parity: the training loop, early stopping, the decoders, the
randomized baseline and the pipeline command.

Training starts both frameworks from the same weights (the JAX package's
``setup_train_state``, copied through ``params_from_jax``).  Loss histories
agree at rtol 1e-4: the loss is the hard cut of the STE one-hot, so a
disagreement would show as a jump of whole edges, not as noise.  Sampling
is compared exactly on uniforms copied from ``jax.random.uniform``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcn_maxcut_tpu.core.graph as jgraph
import gcn_maxcut_tpu.data as jdata
import gcn_maxcut_tpu.eval.decode as jdec
import gcn_maxcut_tpu.train as jtrain
import gcn_maxcut_tpu_torch.core.graph as tgraph
import gcn_maxcut_tpu_torch.data.generate as tgen
import gcn_maxcut_tpu_torch.data.process as tproc
import gcn_maxcut_tpu_torch.eval.decode as tdec
import gcn_maxcut_tpu_torch.train.loop as tloop
from gcn_maxcut_tpu_torch.baselines.randomized import randomized_k_way_maxcut
from gcn_maxcut_tpu_torch.cli import main
from gcn_maxcut_tpu_torch.convert import params_from_jax
from gcn_maxcut_tpu_torch.objectives.cut_loss import hard_cut_value
from gcn_maxcut_tpu_torch.train.config import TrainingConfig


@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_graphs=3, min_nodes=40, max_nodes=56, min_degree=3,
              max_degree=6, base_seed=21)
    dj = jdata.process_graphs(jdata.generate_graph_dataset(**kw)[0],
                              jdata.DataConfig(max_nodes=64))
    dt = tproc.process_graphs(tgen.generate_graph_dataset(**kw)[0],
                              tproc.DataConfig(max_nodes=64))
    assert len({s.degree for s in dt.specs.values()}) > 1   # mixed degrees
    bj = jgraph.pad_graph_batch([dj.graphs[k] for k in sorted(dj.graphs)])
    bt = tgraph.pad_graph_batch([dt.graphs[k] for k in sorted(dt.graphs)])
    return dj, dt, bj, bt


def _train_both(datasets, **cfg):
    _, _, bj, bt = datasets
    kw = dict(n_nodes=64, dropout=0.0, seed=3, **cfg)
    state = jtrain.setup_train_state(jtrain.TrainingConfig(**kw))
    start = jax.tree_util.tree_map(np.asarray, state.params)
    rj = jtrain.train_model(bj, jtrain.TrainingConfig(**kw), state=state)
    cfg_t = TrainingConfig(**kw)
    st = tloop.setup_train_state(cfg_t, params=params_from_jax(start, "cpu"), device="cpu")
    rt = tloop.train_model(bt, cfg_t, state=st)
    return rj, rt


@pytest.mark.parametrize("aggregation", ["auto", "sparse"])
def test_training_history_matches_jax(datasets, aggregation):
    rj, rt = _train_both(datasets, number_epochs=10, learning_rate=5e-3,
                         patience=100, aggregation=aggregation)
    assert len(rt[4]) == len(rj[4]) == 10
    np.testing.assert_allclose(rt[4], rj[4], rtol=1e-4)
    assert rt[1] == pytest.approx(rj[1], rel=1e-4)
    assert rt[2] == rj[2]


def test_early_stopping_and_best_restore_match_jax(datasets):
    rj, rt = _train_both(datasets, number_epochs=60, learning_rate=2e-2, patience=2)
    assert len(rj[4]) < 60, "early stopping did not fire"
    assert rt[2] == rj[2] and len(rt[4]) == len(rj[4])
    np.testing.assert_allclose(rt[4], rj[4], rtol=1e-4)
    for layer in ("conv1", "conv2"):
        for k in ("w", "b"):
            np.testing.assert_allclose(
                rt[0][layer][k].numpy(), np.asarray(rj[0][layer][k]),
                rtol=1e-4, atol=1e-6,
            )


def test_evaluate_model_matches_jax(datasets):
    _, _, bj, bt = datasets
    cfg = jtrain.TrainingConfig(n_nodes=64)
    params = jtrain.setup_train_state(cfg).params
    ej = jtrain.evaluate_model(params, bj, cfg)
    et = tloop.evaluate_model(params_from_jax(params, "cpu"), bt, TrainingConfig(n_nodes=64))
    assert et["num_graphs"] == ej["num_graphs"]
    assert et["total_loss"] == pytest.approx(ej["total_loss"], rel=1e-5)


def test_decoders_match_jax_on_copied_uniforms(datasets):
    dj, dt, _, _ = datasets
    gj, gt = dj.graphs[0], dt.graphs[0]
    logits = np.random.default_rng(5).normal(size=(gj.n_pad, 3)).astype(np.float32)
    probs_j = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    probs_t = torch.tensor(np.asarray(probs_j))
    np.testing.assert_array_equal(
        np.asarray(jdec.simple_assignment(probs_j)),
        tdec.simple_assignment(probs_t).numpy(),
    )
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, (200, gj.n_pad, 1)))
    samples_j = jdec.sample_partitions(probs_j, key, 200)
    samples_t = tdec.sample_partitions_from_uniforms(probs_t, torch.tensor(u))
    np.testing.assert_array_equal(np.asarray(samples_j), samples_t.numpy())
    asn_j, cut_j = jdec.post_process(gj, probs_j, key, iterations=200)
    asn_t, cut_t = tdec.best_of_samples(gt, samples_t)
    np.testing.assert_array_equal(np.asarray(asn_j), asn_t.numpy())
    assert float(cut_j) == float(cut_t)
    # the generator path draws its own uniforms with the same semantics
    asn, cut = tdec.post_process(gt, probs_t, torch.Generator().manual_seed(0), 50)
    assert float(hard_cut_value(gt, asn)) == float(cut)
    assert (asn[:3] == torch.arange(3)).all()


def test_randomized_baseline_replays_early_stop(datasets):
    g = datasets[1].graphs[1]
    asn, cut, used = randomized_k_way_maxcut(g, 3, 1000, patience=1000, chunk_size=256)
    assert used == 1000
    padded = torch.zeros(g.n_pad, dtype=torch.int64)
    padded[: asn.shape[0]] = torch.tensor(asn)
    assert float(hard_cut_value(g, padded)) == cut
    assert list(asn[:3]) == [0, 1, 2]
    _, cut2, used2 = randomized_k_way_maxcut(g, 3, 1000, patience=5, threshold=1e9)
    assert used2 == 1 + 5 and cut2 > 0       # the first draw always improves on -inf


def test_pipeline_command_on_cpu(tmp_path, capsys):
    assert main([
        "pipeline", "--workdir", str(tmp_path), "--num-graphs", "4",
        "--nodes", "30", "--min-degree", "3", "--max-degree", "5",
        "--pad-to", "32", "--epochs", "5", "--device", "cpu",
    ]) == 0
    out = capsys.readouterr().out
    assert "Randomized baseline avg cut" in out
    assert list(tmp_path.glob("*_SUMMARY.md"))
