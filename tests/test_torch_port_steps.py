"""Port parity: the step builders and one-device-call loops.

``train/loop.make_epoch_fn``, ``bench/microbench.bench_train_epoch``,
``bench/giant_demo.banded_gcn_conv``, the halo step builders of
``parallel/giant_banded.py``, the greedy climb and the SA chains, each
against the JAX package's function on the same inputs (numpy draws, the
JAX package's own key splits for the SA draws).  On the CPU every
``ChunkRunner`` runs its steps eagerly; the captured steps are held
against the eager ones by tests/test_torch_port_cuda.py on a card.

Tolerances: training losses and parameters rtol 1e-4 (the loss is the
hard cut of the STE one-hot, so a real disagreement is a jump of whole
edges); the banded conv rtol = atol = 1e-5 (float32 sums in other
orders); the halo builders' chunk losses rtol 1e-3, as
tests/test_torch_port_halo.py holds the trainers (the JAX plain builder
differentiates through a ``psum``, so its embedding gradient is the device
count times the true one, which Adam hides up to its eps); the climb and
the SA chains exactly (class weights are sums of unit weights, whole
numbers in float32).
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import gcn_maxcut_tpu.baselines.exact as jexact
import gcn_maxcut_tpu.baselines.local_search as jls
import gcn_maxcut_tpu.core.graph as jgraph
import gcn_maxcut_tpu.data as jdata
import gcn_maxcut_tpu.train as jtrain
from gcn_maxcut_tpu.bench import giant_demo as jgiant
from gcn_maxcut_tpu.models.gcn import gcn_conv_init
from gcn_maxcut_tpu.parallel import giant_banded as jgb
import gcn_maxcut_tpu_torch.baselines.exact as texact
import gcn_maxcut_tpu_torch.baselines.local_search as tls
import gcn_maxcut_tpu_torch.core.graph as tgraph
import gcn_maxcut_tpu_torch.data.generate as tgen
import gcn_maxcut_tpu_torch.data.process as tproc
import gcn_maxcut_tpu_torch.train.loop as tloop
from gcn_maxcut_tpu_torch.bench import giant_demo as tgiant
from gcn_maxcut_tpu_torch.bench import microbench as tmicro
from gcn_maxcut_tpu_torch.convert import params_from_jax
from gcn_maxcut_tpu_torch.parallel import giant as tpgiant
from gcn_maxcut_tpu_torch.parallel import giant_banded as tgb
from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh
from gcn_maxcut_tpu_torch.train.config import TrainingConfig

ROOT = Path(__file__).resolve().parent.parent


def _pair(n, d_lo, d_hi, seed, n_pad, num_graphs=1):
    kw = dict(num_graphs=num_graphs, min_nodes=n, max_nodes=n, min_degree=d_lo,
              max_degree=d_hi, base_seed=seed)
    dj = jdata.process_graphs(jdata.generate_graph_dataset(**kw)[0],
                              jdata.DataConfig(max_nodes=n_pad))
    dt = tproc.process_graphs(tgen.generate_graph_dataset(**kw)[0],
                              tproc.DataConfig(max_nodes=n_pad))
    return ([dj.graphs[k] for k in sorted(dj.graphs)],
            [dt.graphs[k] for k in sorted(dt.graphs)])


# -- make_epoch_fn and bench_train_epoch ----------------------------------

@pytest.fixture(scope="module")
def batches():
    gj, gt = _pair(48, 3, 6, 21, 64, num_graphs=3)
    return jgraph.pad_graph_batch(gj), tgraph.pad_graph_batch(gt)


@pytest.mark.parametrize("step_mode", ["per_graph", "batched"])
def test_make_epoch_fn_matches_jax(batches, step_mode):
    bj, bt = batches
    kw = dict(n_nodes=64, dropout=0.0, seed=3, learning_rate=1e-2, step_mode=step_mode)
    cfg_j = jtrain.TrainingConfig(**kw)
    state = jtrain.setup_train_state(cfg_j)
    start = jax.tree_util.tree_map(np.asarray, state.params)
    pj, _, lj = jtrain.make_epoch_fn(cfg_j, state.optimizer)(
        state.params, state.opt_state, bj, jax.random.PRNGKey(0), num_epochs=3)
    cfg_t = TrainingConfig(**kw)
    st = tloop.setup_train_state(cfg_t, params=params_from_jax(start, "cpu"), device="cpu")
    lt = tloop.make_epoch_fn(cfg_t, st)(bt, torch.Generator().manual_seed(0), 3)
    assert lt.shape == (3,) and lt.dtype == np.float32
    np.testing.assert_allclose(lt, np.asarray(lj), rtol=1e-4)
    got = st.params()
    for layer in ("conv1", "conv2"):
        for name in ("w", "b"):
            np.testing.assert_allclose(got[layer][name].numpy(), np.asarray(pj[layer][name]),
                                       rtol=1e-4, atol=1e-6)


def test_make_epoch_fn_chunks_and_calls_do_not_change_the_run(batches):
    """Seven epochs in one call, in chunks of 1 or of 3, or in calls of 3
    and 4, are the same epochs; another generator builds a new runner."""
    _, bt = batches
    cfg = TrainingConfig(n_nodes=64, seed=5, learning_rate=1e-2)
    start = tloop.setup_train_state(cfg, device="cpu").params()

    def run(max_chunk, calls):
        st = tloop.setup_train_state(cfg, params=start, device="cpu")
        fn = tloop.make_epoch_fn(cfg, st, max_chunk=max_chunk)
        gen = torch.Generator().manual_seed(0)
        losses = np.concatenate([fn(bt, gen, k) for k in calls])
        return losses, st.params(), fn

    ref, p_ref, fn = run(None, [7])
    assert fn.runner.max_chunk == cfg.epochs_per_call == 1
    for max_chunk, calls in ((3, [7]), (3, [3, 4]), (1, [3, 4])):
        losses, params, _ = run(max_chunk, calls)
        np.testing.assert_array_equal(losses, ref)
        assert torch.equal(params["conv1"]["w"], p_ref["conv1"]["w"])
    runner = fn.runner
    fn(bt, torch.Generator().manual_seed(0), 1)
    assert fn.runner is not runner                       # another generator
    assert fn(bt.to("cpu"), torch.Generator(), 0).shape == (0,)
    # the parts JAX's epoch_fn carries: its epoch and its inputs
    st = tloop.setup_train_state(cfg, params=start, device="cpu")
    fn = tloop.make_epoch_fn(cfg, st)
    loss = fn.run_epoch(fn.epoch_inputs(bt), torch.Generator().manual_seed(0))
    assert float(loss) == ref[0]


def _jax_result_keys(func: str) -> set:
    """Keys of the dict literal ``res`` in JAX's ``bench/microbench.py``."""
    tree = ast.parse((ROOT / "gcn_maxcut_tpu/bench/microbench.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "res"):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no res dict in {func}")


def test_bench_train_epoch_returns_jax_keys():
    res = tmicro.bench_train_epoch(num_graphs=2, n=30, max_nodes=32, epochs_timed=2,
                                   device="cpu")
    assert set(res) == _jax_result_keys("bench_train_epoch") | {"device"}
    stats = res["epoch_time_stats"]
    assert set(stats) == {"best_s", "mean_s", "spread_s", "n", "n_valid"}
    assert stats["n"] == 3 and 0 <= stats["n_valid"] <= 3
    if stats["n_valid"]:
        assert res["epoch_time_s"] == stats["best_s"] <= stats["mean_s"]
    assert res["compile_time_s"] > 0 and np.isfinite(res["final_epoch_loss"])


def test_bench_train_epoch_final_loss_is_k_hi_epochs_from_the_start():
    """As in the JAX package, the final loss is the last of k_hi = 20
    epochs from the initial parameters, not from where the timing left
    the state."""
    kw = dict(num_graphs=2, n=30, max_nodes=32)
    res = tmicro.bench_train_epoch(epochs_timed=2, device="cpu", **kw)
    batch, cfg, state = tmicro._recipe_setup(d_range=(6, 8), seed=1000,
                                             dev=torch.device("cpu"), **kw)
    losses = tloop.make_epoch_fn(cfg, state)(batch, torch.Generator().manual_seed(0), 20)
    assert res["final_epoch_loss"] == float(losses[-1])


# -- banded_gcn_conv --------------------------------------------------------

@pytest.mark.parametrize("in_f,out_f", [(16, 128), (128, 16), (128, 128)])
def test_banded_gcn_conv_matches_jax(in_f, out_f):
    n, offsets, d = 1024, (1, -1, 9, -9, 30, -30), 6
    params = gcn_conv_init(jax.random.PRNGKey(in_f + out_f), in_f, out_f)
    params = {"w": params["w"], "b": jnp.asarray(
        np.random.default_rng(0).normal(size=out_f).astype(np.float32))}
    x = np.random.default_rng(1).normal(size=(n, in_f)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jgiant.banded_gcn_conv(params, jnp.asarray(x), offsets, d))
    got = tgiant.banded_gcn_conv(params_from_jax(params, "cpu"), torch.tensor(x), offsets, d)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


# -- the halo step builders -------------------------------------------------

def _jax_halo_chunk(build, cfg, offsets, conv, embed, n_dev, rows, mu_dtype=None):
    """One chunk of the JAX builder ``build`` on the virtual CPU mesh."""
    jmesh = jgb.make_mesh(("graph",), devices=jax.devices()[:n_dev])
    embed = jax.device_put(jnp.asarray(embed), NamedSharding(jmesh, P("graph")))
    optimizer = optax.adam(cfg.learning_rate, mu_dtype=mu_dtype)
    opt_state = optimizer.init((conv, embed))
    step = build(jmesh, offsets, cfg, optimizer, rows)(opt_state)
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(step(conv, embed, opt_state)[3])


def _conv_params(seed, shapes):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return {"conv1": gcn_conv_init(k1, *shapes[0]), "conv2": gcn_conv_init(k2, *shapes[1])}, k3


def test_halo_giant_step_matches_jax_builder():
    n_dev, n_shard = 4, 128
    kw = dict(d=4, dim_embedding=16, hidden_dim=16, epochs_per_call=5, bandwidth=15,
              block=64, learning_rate=5e-3)
    offsets = tgiant.circulant_offsets(4, 15, 0)
    conv, k3 = _conv_params(0, [(16, 16), (16, 3)])
    embed = np.asarray(jax.random.normal(k3, (n_dev, n_shard, 16), jnp.float32) * 0.1)
    ref = _jax_halo_chunk(jgb.make_halo_giant_step, jgb.HaloGiantConfig(**kw), offsets,
                          conv, embed, n_dev, n_shard)
    ring = make_mesh(devices=["cpu"] * n_dev)
    cfg = tgb.HaloGiantConfig(**kw)
    state = tpgiant.GiantState.create({**conv, "embed": embed}, ring, cfg.learning_rate)
    step, _ = tgb.make_halo_giant_step(ring, offsets, cfg, state, n_shard)
    got = step()
    assert got.shape == (5,) and step.runner.eager_epochs == 5
    np.testing.assert_allclose(got, ref, rtol=1e-3)
    assert -got[-1] > -got[0]                             # the cut grew


def test_packed_halo_step_matches_jax_builder():
    n, n_dev, r, emb = 1024, 4, 8, 32
    kw = dict(d=4, dim_embedding=emb, learning_rate=5e-3, epochs_per_call=5, bandwidth=15,
              r=r, agg_dtype=None, mu_dtype=None)
    offsets = tgiant.circulant_offsets(4, 15, 0)
    m_shard = n // n_dev // r
    conv, k3 = _conv_params(0, [(emb, 16), (16, 16)])
    embed = np.asarray(jax.random.normal(k3, (n // r, r * emb), jnp.float32) * 0.1)
    ref = _jax_halo_chunk(jgb.make_packed_halo_step, jgb.PackedHaloGiantConfig(**kw), offsets,
                          conv, embed.reshape(n_dev, m_shard, r * emb), n_dev, m_shard)
    ring = make_mesh(devices=["cpu"] * n_dev)
    cfg = tgb.PackedHaloGiantConfig(**kw)
    state = tpgiant.GiantState.create(
        {**conv, "embed": embed.reshape(n_dev, m_shard, r * emb)}, ring, cfg.learning_rate)
    step, _ = tgb.make_packed_halo_step(ring, offsets, cfg, state, m_shard)
    got = step(5)
    np.testing.assert_allclose(got, ref, rtol=1e-3)


def test_halo_trainers_run_their_step_builders():
    """A trainer's history is its builder's chunks from the same start,
    equal bit for bit, the state moves only by its chunks, and the
    builder's decode is the trainer's assignment."""
    ring = make_mesh(devices=["cpu"] * 4)
    cfg = tgb.PackedHaloGiantConfig(d=4, bandwidth=15, epochs=6, epochs_per_call=3,
                                    agg_dtype=None, mu_dtype=None)
    p0 = tgiant.packed_params(1024, seed=0, device="cpu")
    res = tgb.train_halo_giant_packed(256, cfg, ring, params=p0, return_assignment=True)
    state = tpgiant.GiantState.create(
        {k: p0[k] for k in ("conv1", "conv2")} | {"embed": p0["embed"].reshape(4, 32, -1)},
        ring, cfg.learning_rate)
    step, decode = tgb.make_packed_halo_step(ring, tgiant.circulant_offsets(4, 15, 0), cfg,
                                             state, 32)
    hist = np.concatenate([step(), step()])
    np.testing.assert_array_equal(hist, np.asarray(res["history"], np.float32))
    assert step.runner.eager_epochs == 6
    np.testing.assert_array_equal(decode(), res["assignment"])


# -- the greedy climb and the SA chains ------------------------------------

@pytest.fixture(scope="module")
def climb_graph():
    gj, gt = _pair(100, 3, 6, 44, 128)
    return gj[0], gt[0]


@pytest.mark.parametrize("block", [16, 5])
@pytest.mark.parametrize("max_steps", [37, 500])
def test_climb_matches_jax_while_loop(climb_graph, monkeypatch, max_steps, block):
    """The lockstep climb in blocks of ``block`` steps (the last shorter)
    equals JAX's ``while_loop`` under ``vmap``: 37 steps stop the climbs
    part way, 500 let them reach their local optima."""
    gj, gt = climb_graph
    monkeypatch.setattr(tls, "_SYNC_EVERY", block)
    rng = np.random.default_rng(max_steps)
    starts = rng.integers(0, 3, (4, gt.n_pad)).astype(np.int32)
    starts[:, :3] = [0, 1, 2]
    aj, cj = jax.vmap(lambda a: jls.greedy_flip_local_search(gj, a, max_steps=max_steps))(
        jnp.asarray(starts))
    at, ct = tls.greedy_flip_local_search(gt, torch.tensor(starts), max_steps=max_steps)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    if max_steps == 37:                                  # the budget stopped a climb
        _, full = tls.greedy_flip_local_search(gt, torch.tensor(starts), max_steps=500)
        assert (ct < full).any()
    one, cut = tls.greedy_flip_local_search(gt, torch.tensor(starts[1]), max_steps=max_steps)
    assert torch.equal(one, at[1]) and float(cut) == float(ct[1])


def _chain_draws(key, restarts, steps, n_pad, k=3, num_fixed=3):
    """The draws of JAX's ``exact._sa_restart_batch`` chains: its key
    splits, then ``simulated_annealing``'s per-step splits."""
    def chain(key):
        k1, k2 = jax.random.split(key)
        init = jax.random.randint(k1, (n_pad,), 0, k)

        def one(key):
            s1, s2, s3 = jax.random.split(key, 3)
            return (jax.random.randint(s1, (), num_fixed, n_pad),
                    jax.random.randint(s2, (), 0, k), jax.random.uniform(s3))

        return (init, *jax.vmap(one)(jax.random.split(k2, steps)))

    return [torch.tensor(np.asarray(a)) for a in jax.vmap(chain)(jax.random.split(key, restarts))]


@pytest.mark.parametrize("block", [1024, 64])
def test_sa_chains_in_blocks_match_jax(monkeypatch, block):
    """R = 4 chains of 300 steps on JAX's draws, in one chunk or in chunks
    of 64 (the last of 44), read through the step index on the device."""
    gj, gt = _pair(40, 4, 4, 9, 48)
    gj, gt = gj[0], gt[0]
    monkeypatch.setattr(tls, "_SA_BLOCK", block)
    key = jax.random.PRNGKey(11)
    a_j, c_j = jexact._sa_restart_batch(gj, key, 3, 3, 300, 4)
    init, nodes, classes, u = _chain_draws(key, 4, 300, gt.n_pad)
    a_t, c_t = texact._sa_restart_batch_from_draws(gt, init, nodes, classes, u, 3, 3)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert float(c_t) == float(c_j)
