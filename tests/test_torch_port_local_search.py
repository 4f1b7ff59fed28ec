"""Port parity: the greedy flip, simulated annealing, BLS and the recursive
split against ``gcn_maxcut_tpu/baselines/local_search.py``.

Gains are sums of unit weights, whole numbers exact in float32, so
assignments and cuts must match exactly from the same starts and draws.
The JAX package's random draws are reproduced with its own key splits and
handed to the port's ``*_from_draws`` forms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcn_maxcut_tpu.baselines.local_search as jls
import gcn_maxcut_tpu.data as jdata
import gcn_maxcut_tpu_torch.baselines.local_search as tls
import gcn_maxcut_tpu_torch.data.generate as tgen
import gcn_maxcut_tpu_torch.data.process as tproc
import gcn_maxcut_tpu_torch.ops.climb as tclimb
from gcn_maxcut_tpu_torch.objectives.cut_loss import hard_cut_value

N_PAD = 64


@pytest.fixture(scope="module")
def graphs():
    kw = dict(num_graphs=3, min_nodes=40, max_nodes=60, min_degree=3,
              max_degree=6, base_seed=33)
    dj = jdata.process_graphs(jdata.generate_graph_dataset(**kw)[0],
                              jdata.DataConfig(max_nodes=N_PAD))
    dt = tproc.process_graphs(tgen.generate_graph_dataset(**kw)[0],
                              tproc.DataConfig(max_nodes=N_PAD))
    assert len({s.degree for s in dt.specs.values()}) > 1   # mixed degrees
    assert dt.graphs[0].n_pad == N_PAD
    return [(dj.graphs[k], dt.graphs[k]) for k in sorted(dt.graphs)]


def _starts(n_pad, count, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 3, (count, n_pad)).astype(np.int32)
    a[:, :3] = [0, 1, 2]
    return a


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_greedy_flip_matches_jax(graphs, idx):
    gj, gt = graphs[idx]
    start = _starts(gj.n_pad, 1, idx)[0]
    aj, cj = jls.greedy_flip_local_search(gj, jnp.asarray(start))
    at, ct = tls.greedy_flip_local_search(gt, torch.tensor(start))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert float(ct) == float(cj)
    # a step budget that ends the climb early stops both at the same move
    aj, cj = jls.greedy_flip_local_search(gj, jnp.asarray(start), max_steps=5)
    at, ct = tls.greedy_flip_local_search(gt, torch.tensor(start), max_steps=5)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert float(ct) == float(cj)


def test_batched_greedy_flip_matches_jax_vmap(graphs):
    gj, gt = graphs[1]
    starts = _starts(gj.n_pad, 4, 7)
    starts[3] = np.asarray(jls.greedy_flip_local_search(gj, jnp.asarray(starts[3]))[0])
    aj, cj = jax.vmap(lambda a: jls.greedy_flip_local_search(gj, a, max_steps=40))(
        jnp.asarray(starts))
    at, ct = tls.greedy_flip_local_search(gt, torch.tensor(starts), max_steps=40)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(at[3].numpy(), starts[3])   # a finished climb stays


def test_greedy_flip_reaches_local_optimum(graphs):
    _, gt = graphs[2]
    start = torch.tensor(_starts(gt.n_pad, 1, 3)[0])
    init_cut = float(hard_cut_value(gt, start))
    asn, cut = tls.greedy_flip_local_search(gt, start)
    assert float(cut) > init_cut
    assert float(hard_cut_value(gt, asn)) == float(cut)
    assert (asn[:3] == torch.arange(3)).all()
    assert float(tclimb.move_gains(gt, asn, 3, 3).max()) <= 1e-6


def _sa_draws(key, steps, n_pad, k=3, num_fixed=3):
    def one(key):
        k1, k2, k3 = jax.random.split(key, 3)
        return (jax.random.randint(k1, (), num_fixed, n_pad),
                jax.random.randint(k2, (), 0, k), jax.random.uniform(k3))

    return [np.asarray(a) for a in jax.vmap(one)(jax.random.split(key, steps))]


def test_simulated_annealing_on_jax_draws(graphs):
    gj, gt = graphs[0]
    start = _starts(gj.n_pad, 1, 11)[0]
    key = jax.random.PRNGKey(5)
    aj, cj = jls.simulated_annealing(gj, jnp.asarray(start), key, steps=300)
    nodes, classes, u = _sa_draws(key, 300, gj.n_pad)
    at, ct = tls.simulated_annealing_from_draws(
        gt, torch.tensor(start), torch.tensor(nodes), torch.tensor(classes), torch.tensor(u))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert float(ct) == float(cj)
    assert float(hard_cut_value(gt, at)) == float(ct)
    # the generator form draws its own proposals with the same semantics
    asn, cut = tls.simulated_annealing(gt, torch.tensor(start), torch.Generator().manual_seed(0),
                                       steps=100)
    assert float(hard_cut_value(gt, asn)) == float(cut)
    assert (asn[:3] == torch.arange(3)).all()


def _bls_draws(key, n_pad, rounds, size, k=3, num_fixed=3):
    key, sub = jax.random.split(key)
    initial = np.asarray(jax.random.randint(sub, (n_pad,), 0, k))
    nodes, classes = [], []
    for _ in range(rounds - 1):
        key, k1, k2 = jax.random.split(key, 3)
        nodes.append(np.asarray(jax.random.randint(k1, (size,), num_fixed, n_pad)))
        classes.append(np.asarray(jax.random.randint(k2, (size,), 0, k)))
    return initial, np.stack(nodes), np.stack(classes)


def test_breakout_local_search_on_jax_draws(graphs):
    gj, gt = graphs[2]
    rounds, size = 4, 8
    # the scatter of repeated nodes has no defined order in JAX: take a key
    # whose perturbations repeat no node
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        initial, nodes, classes = _bls_draws(key, gj.n_pad, rounds, size)
        if all(len(set(r)) == size for r in nodes):
            break
    aj, cj = jls.breakout_local_search(gj, key, rounds=rounds, perturbation_size=size)
    at, ct = tls.breakout_local_search_from_draws(
        gt, torch.tensor(initial), torch.tensor(nodes), torch.tensor(classes))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert float(ct) == float(cj)
    asn, cut = tls.breakout_local_search(gt, torch.Generator().manual_seed(1), rounds=3)
    assert float(hard_cut_value(gt, asn)) == float(cut)


def test_perturbation_last_write_wins():
    asn = torch.zeros(10, dtype=torch.int64)
    nodes = torch.tensor([4, 5, 4, 7, 5, 4])
    classes = torch.tensor([1, 2, 2, 1, 1, 0])
    out = tls._set_last_wins(asn, nodes, classes)
    expect = asn.clone()
    for n, c in zip(nodes.tolist(), classes.tolist()):
        expect[n] = c
    assert torch.equal(out, expect)
    assert torch.equal(asn, torch.zeros(10, dtype=torch.int64))   # input untouched


def _jax_sides_at(key, restarts, n_pad):
    def sides_at(path):
        k = key
        for side in path:
            _, k0, k1, _ = jax.random.split(k, 4)
            k = k0 if side == 0 else k1
        sub = jax.random.split(k, 4)[3]
        draws = jax.vmap(lambda kk: jax.random.randint(kk, (n_pad,), 0, 2))(
            jax.random.split(sub, restarts))
        return torch.tensor(np.asarray(draws))

    return sides_at


@pytest.mark.parametrize("terminals", [[0, 1, 2], [2, 0, 1, 5]], ids=["k3", "k4"])
def test_recursive_split_on_jax_draws(graphs, terminals):
    gj, gt = graphs[1]
    key = jax.random.PRNGKey(3)
    aj, cj = jls.multi_max_cut_recursive(gj, terminals, key, restarts=6)
    at, ct = tls.multi_max_cut_recursive_from_draws(
        gt, terminals, _jax_sides_at(key, 6, gj.n_pad))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert float(ct) == float(cj)
    asn, cut = tls.multi_max_cut_recursive(gt, terminals, torch.Generator().manual_seed(0))
    assert [int(asn[t]) for t in terminals] == list(range(len(terminals)))
    assert float(hard_cut_value(gt, asn)) == float(cut)
