"""Port parity: the classical solvers against the JAX package's.

``native/bindings`` (brute force, greedy, sweep), ``baselines/sweep``,
``baselines/exact`` (brute force, the flow min-cut, the batched SA chains,
the anytime and balanced solvers), the rest of ``baselines/randomized``,
``baselines/analysis`` and ``data/enhanced``.  Cuts of unit-weight graphs
are whole numbers, exact in float32, so results must be equal, not close.
The JAX package's SA draws are reproduced with its own key splits and
handed to the port's ``*_from_draws`` forms.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

import gcn_maxcut_tpu.baselines as jbase
import gcn_maxcut_tpu.baselines.analysis as janalysis
import gcn_maxcut_tpu.baselines.exact as jexact
import gcn_maxcut_tpu.baselines.randomized as jrand
import gcn_maxcut_tpu.data as jdata
import gcn_maxcut_tpu.data.enhanced as jenh
from gcn_maxcut_tpu.baselines.sweep import greedy_sweep_maxcut as j_sweep
from gcn_maxcut_tpu.native import bindings as jnat
import gcn_maxcut_tpu_torch.baselines as tbase
import gcn_maxcut_tpu_torch.baselines.analysis as tanalysis
import gcn_maxcut_tpu_torch.baselines.exact as texact
import gcn_maxcut_tpu_torch.baselines.local_search as tls
import gcn_maxcut_tpu_torch.baselines.randomized as trand
import gcn_maxcut_tpu_torch.data.enhanced as tenh
import gcn_maxcut_tpu_torch.data.generate as tgen
import gcn_maxcut_tpu_torch.data.process as tproc
from gcn_maxcut_tpu_torch.baselines.sweep import greedy_sweep_maxcut as t_sweep
from gcn_maxcut_tpu_torch.native import bindings as tnat
from gcn_maxcut_tpu_torch.objectives.cut_loss import hard_cut_value
from tests.oracle import brute_force_maxcut as oracle_brute_force


def _pair(n, d, seed, n_pad=None, num_graphs=1):
    """The same processed regular graphs in both packages."""
    kw = dict(num_graphs=num_graphs, min_nodes=n, max_nodes=n, min_degree=d,
              max_degree=d, base_seed=seed)
    dj = jdata.process_graphs(jdata.generate_graph_dataset(**kw)[0],
                              jdata.DataConfig(max_nodes=n_pad or n))
    dt = tproc.process_graphs(tgen.generate_graph_dataset(**kw)[0],
                              tproc.DataConfig(max_nodes=n_pad or n))
    return dj, dt


def _edges(gt):
    """The undirected edge list (src < dst) of a processed graph."""
    m = gt.edge_mask.numpy() > 0
    s, r = gt.senders.numpy()[m], gt.receivers.numpy()[m]
    keep = s < r
    return np.stack([s[keep], r[keep]], axis=1).astype(np.int64)


def _dense(gt):
    n = int(gt.n_nodes)
    adj = np.zeros((n, n))
    m = gt.edge_mask.numpy() > 0
    adj[gt.receivers.numpy()[m], gt.senders.numpy()[m]] = gt.weights.numpy()[m]
    return adj


# -- native bindings and the sweep ------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_native_solvers_match_jax(weighted):
    e = jdata.generate.random_regular_edges(14, 4, seed=3)
    w = np.random.default_rng(1).random(e.shape[0]).astype(np.float32) if weighted else None
    a_t, v_t = tnat.brute_force_maxcut_native(e, 14, weights=w)
    a_j, v_j = jnat.brute_force_maxcut_native(e, 14, weights=w)
    np.testing.assert_array_equal(a_t, a_j)
    assert v_t == v_j
    init = np.random.default_rng(2).integers(0, 3, 14)
    init[:3] = [0, 1, 2]
    for fn, kw in (("greedy_maxcut_native", {"max_steps": 50}),
                   ("greedy_sweep_native", {"max_sweeps": 7})):
        got = getattr(tnat, fn)(e, 14, init, weights=w, **kw)
        ref = getattr(jnat, fn)(e, 14, init, weights=w, **kw)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1:] == ref[1:]
    assert v_t >= tnat.greedy_maxcut_native(e, 14, init, weights=w)[1]


def test_native_brute_force_limits_and_checks():
    e = jdata.generate.random_regular_edges(60, 3, seed=0)
    with pytest.raises(ValueError, match="too large"):
        tnat.brute_force_maxcut_native(e, 60)
    with pytest.raises(ValueError, match="too large"):
        jnat.brute_force_maxcut_native(e, 60)
    with pytest.raises(ValueError, match="classes"):
        tnat.greedy_sweep_native(e, 60, np.full(60, 3))


def test_sweep_identical_to_jax():
    n = 3000
    e = tgen.random_regular_edges(n, 6, seed=4)
    rng = np.random.default_rng(4)
    init = rng.integers(0, 3, n)
    init[:3] = [0, 1, 2]
    a_t, c_t, s_t = t_sweep(e, n, init)
    a_j, c_j, s_j = j_sweep(e, n, init)
    np.testing.assert_array_equal(a_t, a_j)
    assert (c_t, s_t) == (c_j, s_j)
    assert c_t / e.shape[0] > 2 / 3 and s_t > 1
    np.testing.assert_array_equal(a_t[:3], [0, 1, 2])


# -- brute force ----------------------------------------------------------

@pytest.mark.parametrize("n", [10, 12, 14])
def test_brute_force_matches_jax(n):
    dj, dt = _pair(n, 3 if n % 2 == 0 else 4, 50 + n, n_pad=16)
    gj, gt = dj.graphs[0], dt.graphs[0]
    a_t, v_t = texact.brute_force_maxcut(gt, batch=1000)
    a_j, v_j = jexact.brute_force_maxcut(gj)
    np.testing.assert_array_equal(a_t, a_j)
    assert v_t == v_j
    # the batch size cannot change the answer (first optimal code overall)
    a_b, v_b = texact.brute_force_maxcut(gt, batch=4096)
    np.testing.assert_array_equal(a_b, a_t)
    assert v_b == v_t
    a_nat, v_nat = tnat.brute_force_maxcut_native(_edges(gt), n)
    assert v_nat == v_t
    np.testing.assert_array_equal(a_nat, a_t)
    if n == 10:
        v_o, _ = oracle_brute_force(_dense(gt), 3, fixed={0: 0, 1: 1, 2: 2})
        assert v_o == v_t
    assert float(hard_cut_value(gt, torch.as_tensor(np.pad(a_t, (0, gt.n_pad - n))))) == v_t


def test_brute_force_size_limit():
    _, dt = _pair(30, 3, 1)
    with pytest.raises(ValueError, match="too large"):
        texact.brute_force_maxcut(dt.graphs[0])


# -- the flow min-cut -----------------------------------------------------

def _flow_with_rule(gt, residual):
    """The port's flow min-cut with another rule for the nodes an ordering
    leaves: ``residual(order)`` names their class."""
    n, adj = int(gt.n_nodes), _dense(gt)
    best, best_val = None, -np.inf
    for order in itertools.permutations(range(3)):
        asn = texact._ordering_assignment(adj, order, residual(order))
        val = float(hard_cut_value(gt, torch.as_tensor(np.pad(asn, (0, gt.n_pad - n)))))
        if val > best_val:
            best, best_val = asn, val
    return best, best_val


FLOW_CASES = [(20, 3, s) for s in range(6)] + [(30, 6, s) for s in range(4)]


def test_flow_min_cut_against_jax():
    equal = 0
    for n, d, seed in FLOW_CASES:
        dj, dt = _pair(n, d, seed)
        gj, gt = dj.graphs[0], dt.graphs[0]
        a_j, v_j = jexact.recursive_flow_min_cut(gj)
        # the shared machinery under JAX's rule reproduces JAX exactly
        a_r, v_r = _flow_with_rule(gt, lambda order: 2)
        np.testing.assert_array_equal(a_r, a_j)
        assert v_r == v_j
        a_t, v_t = texact.recursive_flow_min_cut(gt)
        assert v_t >= v_j
        if v_t == v_j:
            np.testing.assert_array_equal(a_t, a_j)
            equal += 1
        np.testing.assert_array_equal(a_t[:3], [0, 1, 2])
        assert float(hard_cut_value(gt, torch.as_tensor(np.pad(a_t, (0, gt.n_pad - n))))) == v_t
    assert equal >= len(FLOW_CASES) // 2


def test_flow_residual_class_rule_changes_the_result():
    """JAX gives the nodes an ordering leaves to ``terminals[-1]``
    (``exact.py:150``), merging a class into another for every ordering
    that does not end in terminal 2.  Look for a graph where that rule
    changes the returned assignment: there it is a worse one than the
    ordering's own last terminal gives, so the port takes ``order[-1]``."""
    for seed in range(40):
        dj, dt = _pair(20, 3, seed)
        gj, gt = dj.graphs[0], dt.graphs[0]
        a_j, v_j = jexact.recursive_flow_min_cut(gj)
        a_t, v_t = texact.recursive_flow_min_cut(gt)
        if not np.array_equal(a_t, a_j):
            break
    else:
        pytest.fail("no graph where the residual-class rule changes the result")
    assert v_t > v_j
    assert sorted(set(a_t.tolist())) == [0, 1, 2]
    np.testing.assert_array_equal(a_t[:3], [0, 1, 2])
    a_l, v_l = _flow_with_rule(gt, lambda order: order[-1])
    np.testing.assert_array_equal(a_l, a_t)
    assert v_l == v_t


# -- the batched SA chains ------------------------------------------------

def _chain_draws(key, restarts, steps, n_pad, k=3, num_fixed=3):
    """The draws of ``exact._sa_restart_batch``'s chains: its key splits,
    then ``simulated_annealing``'s per-step splits."""
    def chain(key):
        k1, k2 = jax.random.split(key)
        init = jax.random.randint(k1, (n_pad,), 0, k)

        def one(key):
            s1, s2, s3 = jax.random.split(key, 3)
            return (jax.random.randint(s1, (), num_fixed, n_pad),
                    jax.random.randint(s2, (), 0, k), jax.random.uniform(s3))

        return (init, *jax.vmap(one)(jax.random.split(k2, steps)))

    return [torch.tensor(np.asarray(a)) for a in jax.vmap(chain)(jax.random.split(key, restarts))]


def test_sa_chains_on_jax_draws():
    dj, dt = _pair(40, 4, 9, n_pad=48)
    gj, gt = dj.graphs[0], dt.graphs[0]
    key = jax.random.PRNGKey(11)
    a_j, c_j = jexact._sa_restart_batch(gj, key, 3, 3, 300, 4)
    init, nodes, classes, u = _chain_draws(key, 4, 300, gt.n_pad)
    a_t, c_t = texact._sa_restart_batch_from_draws(gt, init, nodes, classes, u, 3, 3)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert float(c_t) == float(c_j)
    # each chain of the batch is the single-chain form on its own draws
    ids = torch.arange(gt.n_pad)
    starts = torch.where(ids < 3, ids, init.long())
    batch_asn, batch_cut = tls.simulated_annealing_from_draws(gt, starts, nodes, classes, u)
    for r in range(4):
        one_asn, one_cut = tls.simulated_annealing_from_draws(
            gt, starts[r], nodes[r], classes[r], u[r])
        assert torch.equal(one_asn, batch_asn[r]) and float(one_cut) == float(batch_cut[r])
    # the seeded form draws its own chains with the same semantics
    gen = torch.Generator().manual_seed(0)
    asn, cut = texact._sa_restart_batch(gt, gen, 3, 3, 100, 3)
    assert float(hard_cut_value(gt, asn)) == float(cut)
    assert (asn[:3] == torch.arange(3)).all()


# -- the anytime and balanced solvers -------------------------------------

def test_anytime_exact_branch_and_balanced_match_jax():
    dj, dt = _pair(12, 4, 21, n_pad=16)
    gj, gt = dj.graphs[0], dt.graphs[0]
    r_t = texact.anytime_solver(gt, time_limit=5)
    r_j = jexact.anytime_solver(gj, time_limit=5)
    assert set(r_t) == set(r_j)
    assert (r_t["method"], r_t["restarts"], r_t["cut_value"]) == \
        (r_j["method"], r_j["restarts"], r_j["cut_value"]) == ("exact_brute_force", 0, r_t["cut_value"])
    np.testing.assert_array_equal(r_t["assignment"], r_j["assignment"])
    b_t = texact.solver_balanced(gt, time_limit=2)
    b_j = jexact.solver_balanced(gj, time_limit=2)
    assert set(b_t) == set(b_j)
    np.testing.assert_array_equal(b_t["assignment"], b_j["assignment"])
    for key in ("cut_value", "method", "partition_sizes", "restarts"):
        assert b_t[key] == b_j[key]
    assert min(b_t["partition_sizes"]) >= 12 // 3


def test_anytime_sa_branch_solution_limit():
    _, dt = _pair(40, 4, 5, n_pad=48)
    gt = dt.graphs[0]
    res = texact.anytime_solver(gt, time_limit=60, sa_steps=150, batch_restarts=4,
                                solution_limit=10)
    assert set(res) == {"assignment", "cut_value", "solve_time", "method", "restarts"}
    assert res["method"] == "sa_anytime" and res["restarts"] == 10
    asn = torch.as_tensor(np.pad(res["assignment"], (0, gt.n_pad - 40)))
    assert float(hard_cut_value(gt, asn)) == res["cut_value"]
    rand = torch.randint(0, 3, (gt.n_pad,), generator=torch.Generator().manual_seed(0))
    rand[:3] = torch.arange(3)
    assert res["cut_value"] >= float(hard_cut_value(gt, rand))
    np.testing.assert_array_equal(res["assignment"][:3], [0, 1, 2])


# -- the randomized harnesses and the analysis ----------------------------

def _stub(g, k=3, max_iterations=1000, threshold=0.0, patience=100,
          fixed_terminals=True, num_terminals=3, seed=0, chunk_size=512):
    """A deterministic stand-in for ``randomized_k_way_maxcut``."""
    n = int(g.n_nodes)
    cut = float(10 * n + k + seed + (0 if fixed_terminals else 0.5))
    return np.arange(n) % k, cut, min(max_iterations, 7 + seed)


def test_randomized_harnesses_match_jax(monkeypatch):
    monkeypatch.setattr(jrand, "randomized_k_way_maxcut", _stub)
    monkeypatch.setattr(trand, "randomized_k_way_maxcut", _stub)
    dj, dt = _pair(24, 4, 2, num_graphs=3)
    ev_j = jrand.evaluate_algorithm_on_graphs([dj.graphs[i] for i in range(3)], seed=5)
    ev_t = trand.evaluate_algorithm_on_graphs([dt.graphs[i] for i in range(3)], seed=5)
    assert set(ev_t) == set(ev_j)
    for key in ("avg_cut", "std_cut", "cuts"):
        assert ev_t[key] == ev_j[key]
    assert len(ev_t["times"]) == 3 and ev_t["total_time"] >= 0

    kw = dict(node_sizes=(30, 40), k_values=(3, 4), degree=4, iterations=50, seed=1)
    b_j = jrand.benchmark_algorithm(**kw)
    b_t = trand.benchmark_algorithm(**kw, device="cpu")
    assert set(b_t) == set(b_j)
    for nk in b_j:
        for key in ("cut", "iterations_used", "normalized_cut"):
            assert b_t[nk][key] == b_j[nk][key]
    assert janalysis.analyze_benchmark_results(b_j, degree=4)["by_k"][3]["cut"] == \
        tanalysis.analyze_benchmark_results(b_t, degree=4)["by_k"][3]["cut"]

    f_j = jrand.test_fixed_terminals(dj.graphs[0], iterations=30)
    f_t = trand.test_fixed_terminals(dt.graphs[0], iterations=30)
    for mode in ("fixed", "free"):
        for key in ("cut", "iterations_used", "terminals_ok"):
            assert f_t[mode][key] == f_j[mode][key]
    assert jrand.quick_demo(n=30, d=4) == trand.quick_demo(n=30, d=4, device="cpu")


def test_randomized_harnesses_run_unstubbed():
    _, dt = _pair(24, 4, 2, num_graphs=2)
    ev = tbase.evaluate_algorithm_on_graphs([dt.graphs[0], dt.graphs[1]], max_iterations=64)
    assert ev["avg_cut"] > 0
    fixed = trand.test_fixed_terminals(dt.graphs[0], iterations=64)
    assert fixed["fixed"]["terminals_ok"] is True and fixed["free"]["terminals_ok"] is None
    assert trand.quick_demo(n=30, d=4, device="cpu")["edges"] == 60


def test_analyze_benchmark_results_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    results = {(n, k): {"cut": float(rng.integers(100, 900)), "time": float(rng.random())}
               for n in (100, 300, 200) for k in (3, 5)}
    s_j = janalysis.analyze_benchmark_results(results, degree=6,
                                              save_path=str(tmp_path / "j.png"))
    s_t = tanalysis.analyze_benchmark_results(results, degree=6,
                                              save_path=str(tmp_path / "t.png"))
    assert s_t == s_j
    assert (tmp_path / "t.png").stat().st_size > 0


# -- the baseline stats ---------------------------------------------------

def test_compute_baseline_stats_matches_jax():
    dj, dt = _pair(14, 4, 8, n_pad=16, num_graphs=2)
    s_j = jenh.compute_baseline_stats(dj, randomized_iterations=64, solver_time_limit=5)
    s_t = tenh.compute_baseline_stats(dt, randomized_iterations=64, solver_time_limit=5,
                                      device="cpu")
    assert dt.baseline_stats is s_t
    assert set(s_t) == set(s_j)
    for i in s_j:
        assert set(s_t[i]) == set(s_j[i])
        for key in ("n_nodes", "n_edges", "solver_cut", "solver_method"):
            assert s_t[i][key] == s_j[i][key]
        assert s_t[i]["flow_min_cut_value"] == texact.recursive_flow_min_cut(dt.graphs[i])[1]
        assert s_t[i]["flow_min_cut_value"] >= s_j[i]["flow_min_cut_value"]
        assert s_t[i]["solver_cut"] >= s_t[i]["randomized_cut"]


def test_exports_match_jax():
    assert tbase.__all__ == jbase.__all__
    assert all(callable(getattr(tbase, name)) for name in tbase.__all__)
