"""Port parity: the refine decoders, the class-relabeling search and the
evaluation harness against ``gcn_maxcut_tpu/eval/{decode,harness}.py``.

The sampled decoders are compared exactly on uniforms copied from
``jax.random.uniform``; the harness draws its own, so its sampled cuts are
compared by their contract (refined ≥ post-processed) and its
deterministic parts (forward pass, argmax decode, bucketing, analysis and
report text) by value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcn_maxcut_tpu.data as jdata
import gcn_maxcut_tpu.eval.decode as jdec
import gcn_maxcut_tpu.eval.harness as jharness
import gcn_maxcut_tpu.train as jtrain
import gcn_maxcut_tpu_torch.data.generate as tgen
import gcn_maxcut_tpu_torch.data.process as tproc
import gcn_maxcut_tpu_torch.eval.decode as tdec
import gcn_maxcut_tpu_torch.eval.harness as tharness
from gcn_maxcut_tpu_torch.convert import params_from_jax
from gcn_maxcut_tpu_torch.objectives.cut_loss import hard_cut_value

N_PAD = 64


@pytest.fixture(scope="module")
def data():
    kw = dict(num_graphs=4, min_nodes=36, max_nodes=60, min_degree=3,
              max_degree=6, base_seed=44)
    dj = jdata.process_graphs(jdata.generate_graph_dataset(**kw)[0],
                              jdata.DataConfig(max_nodes=N_PAD))
    dt = tproc.process_graphs(tgen.generate_graph_dataset(**kw)[0],
                              tproc.DataConfig(max_nodes=N_PAD))
    params = jtrain.setup_train_state(jtrain.TrainingConfig(n_nodes=N_PAD, seed=2)).params
    return dj, dt, params, params_from_jax(params, "cpu")


def _probs(n_pad, seed, sharpness):
    logits = np.random.default_rng(seed).normal(size=(n_pad, 3)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(logits * sharpness), axis=-1)
    return probs, torch.tensor(np.asarray(probs))


@pytest.mark.parametrize("starts", [1, 4, 6])
@pytest.mark.parametrize("case", ["soft", "tied"])
def test_refine_multi_start_matches_jax(data, starts, case):
    dj, dt, _, _ = data
    gj, gt = dj.graphs[1], dt.graphs[1]
    probs_j, probs_t = _probs(gj.n_pad, *{"soft": (4, 1.0), "tied": (7, 6.0)}[case])
    key = jax.random.PRNGKey(11)
    u = torch.tensor(np.asarray(jax.random.uniform(key, (200, gj.n_pad, 1))))
    if case == "tied":
        # the last start taken and the first left out have the same cut:
        # only the sort's order decides between two different samples
        cuts = torch.sort(hard_cut_value(gt, tdec.sample_partitions_from_uniforms(probs_t, u)))
        m = max(1, starts - 1)
        assert cuts.values[-m] == cuts.values[-m - 1]
    aj, cj = jdec.refine_multi_start(gj, probs_j, key, iterations=200, starts=starts)
    at, ct = tdec.refine_multi_start_from_uniforms(gt, probs_t, u, starts)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert float(ct) == float(cj)
    # the generator form: same semantics, and never below the best sample
    gen = torch.Generator().manual_seed(0)
    asn, cut = tdec.refine_multi_start(gt, probs_t, gen, 50, starts)
    assert float(hard_cut_value(gt, asn)) == float(cut)
    assert (asn[:3] == torch.arange(3)).all()


def test_refine_single_start_and_permutation_search_match_jax(data):
    dj, dt, _, _ = data
    gj, gt = dj.graphs[2], dt.graphs[2]
    probs_j, probs_t = _probs(gj.n_pad, 4, 1.0)
    start = np.asarray(jdec.simple_assignment(probs_j))
    aj, cj = jdec.refine_with_local_search(gj, jnp.asarray(start))
    at, ct = tdec.refine_with_local_search(gt, torch.tensor(start))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert float(ct) == float(cj)
    for pj, pt in (_probs(gj.n_pad, 4, 1.0), (probs_j * 0 + 1 / 3, probs_t * 0 + 1 / 3)):
        aj, cj = jdec.terminal_permutation_search(gj, pj)
        at, ct = tdec.terminal_permutation_search(gt, pt)
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        assert float(ct) == float(cj)


@pytest.mark.parametrize("refine_starts", [4, 1])
def test_single_graph_matches_jax_contract(data, refine_starts):
    dj, dt, params_j, params_t = data
    rj = jharness.test_single_graph(params_j, dj.graphs[0], jax.random.PRNGKey(0),
                                    refine=True, measure_times=False,
                                    refine_starts=refine_starts)
    rt = tharness.test_single_graph(params_t, dt.graphs[0], torch.Generator().manual_seed(0),
                                    refine=True, measure_times=refine_starts == 1,
                                    refine_starts=refine_starts)
    assert rt["success"] and rj["success"]
    assert set(rt) == set(rj)
    assert rt["simple_cut"] == rj["simple_cut"]
    np.testing.assert_array_equal(rt["simple_assignment"], rj["simple_assignment"])
    np.testing.assert_allclose(rt["node_probabilities"], rj["node_probabilities"],
                               rtol=1e-5, atol=1e-6)
    assert (rt["nodes"], rt["edges"], rt["terminals"]) == (rj["nodes"], rj["edges"],
                                                           rj["terminals"])
    assert rt["refined_cut"] >= rt["post_cut"]
    if refine_starts == 1:        # the host clock on the CPU
        assert rt["simple_time"] > 0 and rt["post_time"] > 0 and rt["refined_time"] > 0
    bad = tharness.test_single_graph({}, dt.graphs[0], torch.Generator())
    assert bad["success"] is False and set(bad) == {"success", "error", "nodes", "edges"}


def test_multiple_graphs_buckets_and_reports_like_jax(data, tmp_path, capsys):
    dj, dt, params_j, params_t = data
    sizes = [40, 50]
    res_j, by_j = jharness.test_multiple_graphs(params_j, dj, sizes, verbose=False,
                                                measure_times=False)
    res_t, by_t = tharness.test_multiple_graphs(params_t, dt, sizes, verbose=False,
                                                measure_times=False)
    assert len(res_t) < len(dt), "no graph was skipped"
    assert [(r["graph_name"], r["graph_size"]) for r in res_t] == \
        [(r["graph_name"], r["graph_size"]) for r in res_j]
    for s in sizes:
        assert by_t[s]["simple"]["cut_values"] == by_j[s]["simple"]["cut_values"]
        assert len(by_t[s]["post_processed"]["cut_values"]) == \
            len(by_j[s]["post_processed"]["cut_values"])

    # analysis and reports: equal on the same result list
    for r, t in zip(res_j, (0.01, 0.02, 0.03, 0.04)):
        r.update(simple_time=t, post_time=3 * t)
    for bucket in by_j.values():
        bucket["simple"]["times"] = [0.01] * len(bucket["simple"]["cut_values"])
        bucket["post_processed"]["times"] = [0.03] * len(bucket["simple"]["cut_values"])
    a_j = jharness.analyze_results(res_j, by_j, sizes)
    a_t = tharness.analyze_results(res_j, by_j, sizes)
    assert a_t == a_j
    assert tharness.print_analysis_report(a_t, sizes) == \
        jharness.print_analysis_report(a_j, sizes)
    assert tharness.analyze_results([], by_j, sizes) == jharness.analyze_results([], by_j, sizes)

    def body(text):
        return [line for line in text.splitlines() if not line.startswith("Generated:")]

    cfg = {"iterations": 200}
    assert body(tharness.generate_summary_report(a_t, cfg, {"n_nodes": 64})) == \
        body(jharness.generate_summary_report(a_j, cfg, {"n_nodes": 64}))

    # save/load round trip, readable by the JAX package's loader
    path = tharness.save_results(tmp_path / "r" / "res.json", res_t, by_t,
                                 tharness.analyze_results(res_t, by_t, sizes), cfg)
    loaded = tharness.load_results(path)
    assert loaded == jharness.load_results(path)
    assert [r["simple_cut"] for r in loaded["individual_results"]] == \
        [r["simple_cut"] for r in res_t]
    assert "node_probabilities" not in loaded["individual_results"][0]
    assert loaded["individual_results"][0]["simple_assignment"] == \
        res_t[0]["simple_assignment"].tolist()
    assert set(loaded) == {"individual_results", "results_by_size", "analysis",
                           "testing_config", "model_config", "timestamp"}
