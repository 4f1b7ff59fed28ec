"""Port parity: the locality trainer (RCM → terminals → plan → train →
decode) and the SpMM microbenchmarks, at small sizes on the CPU.

The JAX side runs the JAX package's own functions in the same order on the
same edge list, from the same numpy parameters (``locality_params``).  At
the hidden width 64 and the class width 3 the JAX block-ELL path takes its
exact XLA fallback outside interpret mode, so no Pallas runs here.  Loss
histories agree at rtol 1e-4: the loss is the hard cut of the STE one-hot,
so a disagreement would show as whole edges.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gcn_maxcut_tpu.bench.microbench as jmicro
from gcn_maxcut_tpu import train as jtrain
from gcn_maxcut_tpu.core.graph import graph_from_edges, pad_graph_batch
from gcn_maxcut_tpu.data.generate import GraphSpec
from gcn_maxcut_tpu.data.process import normalize_terminals
from gcn_maxcut_tpu.data.reorder import rcm_permutation, rcm_reorder
from gcn_maxcut_tpu.eval.decode import simple_assignment
from gcn_maxcut_tpu.models.gcn import gcn_softmax_apply
from gcn_maxcut_tpu.objectives.cut_loss import hard_cut_value
from gcn_maxcut_tpu_torch.bench import locality as tloc
from gcn_maxcut_tpu_torch.bench import microbench as tmicro
from gcn_maxcut_tpu_torch.cli import main
from gcn_maxcut_tpu_torch.data import reorder as treorder

N = 4096
EPOCHS = 4


def _jax_run(n, epochs):
    spec_t = tloc.locality_spec(n)
    spec = GraphSpec(n_nodes=n, edges=spec_t.edges, terminals=spec_t.terminals, degree=8)
    spec = normalize_terminals(rcm_reorder(spec)[0])
    g = graph_from_edges(spec.edges, n, n_pad=n, block_ell=True)
    assert g.bell_block is not None
    cfg = jtrain.TrainingConfig(
        n_nodes=n, dim_embedding=128, hidden_dim=64, number_classes=3,
        learning_rate=1e-3, number_epochs=epochs, patience=20, dropout=0.0,
        feature_mode="embedding", aggregation="sparse", seed=0)
    state = jtrain.setup_train_state(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, tloc.locality_params(n))
    state = jtrain.TrainState(params, state.optimizer.init(params), cfg, state.optimizer)
    best, _, _, _, history = jtrain.train_model(pad_graph_batch([g]), cfg, state=state)
    probs = gcn_softmax_apply({"conv1": best["conv1"], "conv2": best["conv2"]}, g, best["embed"])
    return history, float(hard_cut_value(g, simple_assignment(probs))), g


def test_rcm_matches_jax():
    spec = tloc.locality_spec(N, seed=5)
    np.testing.assert_array_equal(treorder.rcm_permutation(spec.edges, N),
                                  rcm_permutation(spec.edges, N))
    jspec = GraphSpec(n_nodes=N, edges=spec.edges, terminals=spec.terminals, degree=8)
    (ts, tw), (js, jw) = treorder.rcm_reorder(spec), rcm_reorder(jspec)
    assert tw == jw and ts.terminals == js.terminals
    np.testing.assert_array_equal(ts.edges, js.edges)
    assert treorder.is_bandable(spec, 400) == (True, tw)
    assert treorder.graph_bandwidth(spec.edges) > 10 * tw   # the shuffle hid the band


def test_locality_trainer_matches_jax():
    jhist, jcut, jg = _jax_run(N, EPOCHS)
    r = tloc.train_locality(n=N, epochs=EPOCHS, device="cpu")
    assert (r["bell_block"], r["bell_wp"]) == (jg.bell_block, jg.bell_wp)
    assert r["n_outliers"] == int(np.asarray(jg.bell_out_mask).sum()) > 0
    assert len(r["history"]) == len(jhist) == EPOCHS
    np.testing.assert_allclose(r["history"], jhist, rtol=1e-4)
    assert r["final_cut"] == pytest.approx(jcut, rel=1e-4)
    assert r["final_cut"] > r["initial_cut"] == pytest.approx(-jhist[0], rel=1e-4)
    assert r["assignment"][:3].tolist() == [0, 1, 2]
    assert r["graph_digest"] == tloc.graph_digest(np.asarray(jg.senders), np.asarray(jg.receivers))


def test_reference_tool_trains_on_the_relabeling_it_is_given():
    path = Path(__file__).resolve().parent.parent / "tools" / "locality_reference.py"
    spec = importlib.util.spec_from_file_location("locality_reference", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    def digest(g):
        return tloc.graph_digest(np.asarray(g.senders), np.asarray(g.receivers))

    edges = tloc.locality_spec(N).edges
    own, own_w = tool.jax_locality_graph(N)
    given, given_w = tool.jax_locality_graph(N, perm=rcm_permutation(edges, N))
    assert digest(given) == digest(own) and given_w == own_w
    g_t, w_t = tloc.locality_graph(tloc.locality_spec(N))
    assert digest(g_t) == digest(own) and w_t == own_w
    flipped, flipped_w = tool.jax_locality_graph(N, perm=N - 1 - rcm_permutation(edges, N))
    assert digest(flipped) != digest(own) and flipped_w == own_w


def test_bench_spmm_returns_the_jax_keys(monkeypatch):
    stub = {"best_s": 1e-3, "mean_s": 1e-3, "spread_s": 0.0, "spread_frac": 0.0,
            "n": 1, "n_valid": 1}
    monkeypatch.setattr(jmicro, "_scan_timeit_stats", lambda *a, **k: dict(stub))
    kw = dict(n=2048, d=8, feature_dim=8)
    rj = jmicro.bench_spmm(**kw)
    rt = tmicro.bench_spmm(**kw, iters=2, device="cpu")
    assert set(rt) == set(rj) | {"device"} and rt["device"] == "cpu"
    assert (rt["bell_block"], rt["bell_wp"]) == (rj["bell_block"], rj["bell_wp"])
    assert set(rt["fwd_stats"]) == set(stub)
    for k in ("fraction_of_roofline_fwd", "fraction_of_roofline_fwdbwd",
              "expander_fraction_of_roofline_fwd", "expander_fraction_of_roofline_fwdbwd"):
        assert 0 < rt[k] <= 1


def test_bench_spmm_banded_keys_and_roofline():
    r = tmicro.bench_spmm_banded(n=2048, feature_dim=8, iters=2, n_big=4096, device="cpu")
    assert set(r) == {
        "n", "d", "feature_dim", "bandwidth", "fwd_time_s", "fwd_edges_per_s", "fwd_stats",
        "fwdbwd_time_s", "fwdbwd_edges_per_s", "fwdbwd_stats", "weighted_fwd_time_s",
        "weighted_fwd_edges_per_s", "weighted_fwd_stats", "banded_roofline_edges_per_s",
        "weighted_roofline_edges_per_s", "fraction_of_banded_roofline",
        "weighted_fraction_of_banded_roofline", "hbm_regime_n",
        "hbm_regime_fwd_edges_per_s", "hbm_regime_fwd_stats", "hbm_regime_gbps",
        "hbm_regime_weighted_fwd_edges_per_s", "hbm_regime_weighted_fwd_stats", "device",
    }
    assert tmicro.banded_offsets(8, 63) == tuple(
        int(o) for s in np.random.default_rng(0).choice(np.arange(1, 64), 4, replace=False)
        for o in (s, -s))
    assert 0 < r["fraction_of_banded_roofline"] <= 1
    with pytest.raises(ValueError, match="no figures"):
        tmicro.bench_spmm_banded(n=2048, chip="v5e", device="cpu")


def test_cli_bench_locality(capsys):
    assert main(["bench", "--what", "locality", "--n", "4096", "--epochs", "2",
                 "--device", "cpu"]) == 0
    r = json.loads(capsys.readouterr().out)["locality"]
    assert r["n"] == 4096 and r["epochs_run"] == 2 and len(r["history"]) == 2
    assert r["bell_block"] is not None and "assignment" not in r
