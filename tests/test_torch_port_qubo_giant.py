"""Port parity: the legacy QUBO loop (``train/qubo_loop.py``) and the packed
giant trainer's checkpoints and resume (``bench/giant_demo.py``), against
the JAX package.

The QUBO loop starts both frameworks from the JAX package's draw for the
seed; its loss is a smooth function of the probabilities, so histories
agree at rtol 1e-4 and the tracked bitstring exactly.  The packed trainer
runs at the JAX package's own resume test's size
(``tests/test_giant_banded.py``), its JAX side in Pallas interpret mode;
the port's resume reproduces its uninterrupted run exactly (the CPU sums in
one order), and a JAX checkpoint resumed in the port reaches the JAX
package's uninterrupted final cut at rtol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import gcn_maxcut_tpu.bench.giant_demo as jgiant
import gcn_maxcut_tpu.data as jdata
import gcn_maxcut_tpu.models.gcn as jgcn
import gcn_maxcut_tpu.train.qubo_loop as jqubo
import gcn_maxcut_tpu_torch.bench.giant_demo as tgiant
import gcn_maxcut_tpu_torch.data.generate as tgen
import gcn_maxcut_tpu_torch.data.process as tproc
import gcn_maxcut_tpu_torch.train.qubo_loop as tqubo
from gcn_maxcut_tpu_torch.convert import params_from_jax
from gcn_maxcut_tpu_torch.objectives.qubo import qubo_loss


def _jax_qubo_start(config, n_pad):
    """The JAX loop's initial parameters for ``config.seed``."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(config.seed))
    params = jgcn.gcn_dev_init(k1, config.dim_embedding, config.hidden_dim, 1)
    params["embed"] = jgcn.embedding_init(k2, n_pad, config.dim_embedding)
    return jax.tree_util.tree_map(np.asarray, params)


# (learning rate, patience, tolerance, epochs): the first stops early, at an
# epoch whose loss step clears the tolerance by 1e-4, far above float32 noise
QUBO_RUNS = {"early-stop": (3e-2, 3, 1e-3, 200), "full": (1e-2, 1000, 1e-4, 60)}


@pytest.mark.parametrize("run", list(QUBO_RUNS))
def test_qubo_loop_matches_jax(run):
    lr, patience, tolerance, epochs = QUBO_RUNS[run]
    spec_j = jdata.generate_graph(n=30, d=3, graph_type="reg", seed=6)
    spec_t = tgen.generate_graph(n=30, d=3, graph_type="reg", seed=6)
    gj = jdata.process_graphs([spec_j], jdata.DataConfig(max_nodes=32)).graphs[0]
    gt = tproc.process_graphs([spec_t], tproc.DataConfig(max_nodes=32)).graphs[0]
    kw = dict(dim_embedding=16, hidden_dim=8, learning_rate=lr, number_epochs=epochs,
              patience=patience, tolerance=tolerance, seed=1)
    _, rj = jqubo.run_gnn_training(gj, jqubo.QuboConfig(**kw))
    start = params_from_jax(_jax_qubo_start(jqubo.QuboConfig(**kw), gj.n_pad), "cpu")
    params, rt = tqubo.run_gnn_training(gt, tqubo.QuboConfig(**kw), device="cpu",
                                        params=start)
    assert set(rt) == set(rj)
    assert rt["epochs"] == rj["epochs"] and len(rt["loss_history"]) == rt["epochs"]
    if run == "early-stop":
        assert rt["epochs"] < epochs, "early stopping did not fire"
    np.testing.assert_allclose(rt["loss_history"], rj["loss_history"], rtol=1e-4)
    assert rt["best_cut"] == rj["best_cut"] > 0
    np.testing.assert_array_equal(rt["best_bitstring"].numpy(),
                                  np.asarray(rj["best_bitstring"]))
    assert float(qubo_loss(gt, rt["best_bitstring"].float())) == rt["best_loss"]
    assert rt["final_loss"] == rt["loss_history"][-1]
    assert set(params) == {"conv1", "conv2", "embed"}


def test_qubo_loop_runs_on_the_card_unless_told(monkeypatch):
    spec = tgen.generate_graph(n=30, d=3, graph_type="reg", seed=6)
    g = tproc.process_graphs([spec], tproc.DataConfig(max_nodes=32)).graphs[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tqubo.run_gnn_training(g, tqubo.QuboConfig(number_epochs=1))


GIANT = dict(n=1024, d=4, bandwidth=15, seed=0, agg_dtype=None, mu_dtype=None,
             epochs_per_call=2)


def test_packed_giant_resume_equals_uninterrupted_run(tmp_path):
    full = tgiant.train_banded_giant_packed(epochs=20, device="cpu", **GIANT)
    ck = str(tmp_path / "packed_ck")
    half = tgiant.train_banded_giant_packed(epochs=10, checkpoint_path=ck,
                                            checkpoint_every=4, device="cpu", **GIANT)
    # written after epochs 4 and 8 and at the end, each over the same file
    assert [w["epoch"] for w in half["checkpoint_writes"]] == [4, 8, 10]
    assert all(w["bytes"] > 0 for w in half["checkpoint_writes"])
    resumed = tgiant.train_banded_giant_packed(epochs=20, resume_from=ck, device="cpu",
                                               **GIANT)
    assert resumed["epochs"] == 20 and resumed["resumed_from_epoch"] == 10
    assert resumed["history"] == full["history"]
    assert resumed["final_cut"] == full["final_cut"]
    assert resumed["epoch_time_s"] > 0
    with pytest.raises(ValueError, match="already at epoch 10"):
        tgiant.train_banded_giant_packed(epochs=10, resume_from=ck, device="cpu", **GIANT)


def test_packed_giant_bf16_moment_survives_the_checkpoint(tmp_path):
    kw = dict(GIANT, mu_dtype="bfloat16", agg_dtype="bfloat16", epochs_per_call=1)
    full = tgiant.train_banded_giant_packed(epochs=8, device="cpu", **kw)
    ck = str(tmp_path / "bf16_ck")
    tgiant.train_banded_giant_packed(epochs=5, checkpoint_path=ck, device="cpu", **kw)
    with np.load(ck + ".npz") as f:
        assert f["opt:0/.mu/embed"].dtype == np.float32
        assert f["opt:0/.count"] == 5
    resumed = tgiant.train_banded_giant_packed(epochs=8, resume_from=ck, device="cpu", **kw)
    assert resumed["history"] == full["history"]


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    ck = str(tmp_path / "jax_ck")
    with pltpu.force_tpu_interpret_mode():
        full = jgiant.train_banded_giant_packed(epochs=12, **GIANT)
        jgiant.train_banded_giant_packed(epochs=6, checkpoint_path=ck, **GIANT)
    resumed = tgiant.train_banded_giant_packed(
        epochs=12, resume_from=ck, checkpoint_path=str(tmp_path / "port_ck"), device="cpu",
        **GIANT)
    assert resumed["epochs"] == 12 and resumed["resumed_from_epoch"] == 6
    assert len(resumed["history"]) == 12
    np.testing.assert_allclose(resumed["final_cut"], full["final_cut"], rtol=1e-5)
    # the port writes the JAX trainer's leaves, and the JAX trainer resumes from them
    with np.load(ck + ".npz") as fj, np.load(tmp_path / "port_ck.npz") as ft:
        assert sorted(fj.files) == sorted(ft.files)
        assert int(fj["opt:0/.count"]) == 6 and int(ft["opt:0/.count"]) == 12
