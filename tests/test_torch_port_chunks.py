"""``epochs_per_call`` in the port: chunks of epochs read once (CPU).

The port runs a trainer's epochs in chunks (``train/chunks.py``): on the
card one captured CUDA graph replayed an epoch at a time, on the CPU the
same code eagerly.  Checked here:

  * the recipe loop at K = 8 is bit for bit the loop at K = 1, with a
    stop inside a chunk, for ``per_graph`` and ``batched`` steps and the
    cosine schedule, and matches the JAX ``train_model`` at K = 8 from
    copied parameters (rtol 1e-4: history, final epoch, best loss, best
    parameters);
  * the giant, halo, k-way and hybrid trainers run the JAX package's
    number of epochs when K does not divide ``epochs`` (whole chunks; the
    single-chip giant trainers at least two), with histories at the
    tolerances of those trainers' own parity tests (the JAX kernels in
    interpret mode, the sharded ones under ``shard_map`` on the virtual CPU
    devices of tests/conftest.py);
  * every port config and function whose JAX counterpart has
    ``epochs_per_call`` has it, with the JAX default;
  * ``checked`` raises after a chunk that produced a NaN;
  * the capturable ``Adam`` is, step for step, the step written with
    Python numbers that it replaced (on the CPU; the card case is in
    tests/test_torch_port_cuda.py).
"""

import dataclasses
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import gcn_maxcut_tpu.bench.giant_demo as jdemo
import gcn_maxcut_tpu.core.graph as jgraph
import gcn_maxcut_tpu.data as jdata
import gcn_maxcut_tpu.parallel.giant as jgiant
import gcn_maxcut_tpu.parallel.giant_banded as jgb
import gcn_maxcut_tpu.parallel.hybrid as jhybrid
import gcn_maxcut_tpu.train as jtrain
import gcn_maxcut_tpu_torch.bench.giant_demo as tdemo
import gcn_maxcut_tpu_torch.core.graph as tgraph
import gcn_maxcut_tpu_torch.data.generate as tgen
import gcn_maxcut_tpu_torch.data.process as tproc
import gcn_maxcut_tpu_torch.parallel.giant as tgiant
import gcn_maxcut_tpu_torch.parallel.giant_banded as tgb
import gcn_maxcut_tpu_torch.parallel.hybrid as thybrid
import gcn_maxcut_tpu_torch.train.loop as tloop
from gcn_maxcut_tpu.data.generate import random_regular_edges
from gcn_maxcut_tpu.models.gcn import gcn_conv_init
from gcn_maxcut_tpu.parallel.mesh import make_mesh as jmake_mesh
from gcn_maxcut_tpu.parallel.partition import shard_graph as jshard_graph
from gcn_maxcut_tpu_torch.bench.locality import locality_params
from gcn_maxcut_tpu_torch.convert import params_from_jax
from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh
from gcn_maxcut_tpu_torch.train.chunks import ChunkRunner, chunk_sizes
from gcn_maxcut_tpu_torch.train.config import TrainingConfig
from gcn_maxcut_tpu_torch.train import optim
from gcn_maxcut_tpu_torch.train.optim import Adam, cosine_decay_schedule
from gcn_maxcut_tpu_torch.utils.debug import checked

# the bench packages export the function under the module's name
jkway = importlib.import_module("gcn_maxcut_tpu.bench.kway_sweep")
tkway = importlib.import_module("gcn_maxcut_tpu_torch.bench.kway_sweep")


@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_graphs=3, min_nodes=20, max_nodes=28, min_degree=3, max_degree=5,
              base_seed=4)
    dj = jdata.process_graphs(jdata.generate_graph_dataset(**kw)[0],
                              jdata.DataConfig(max_nodes=32))
    dt = tproc.process_graphs(tgen.generate_graph_dataset(**kw)[0],
                              tproc.DataConfig(max_nodes=32))
    bj = jgraph.pad_graph_batch([dj.graphs[k] for k in sorted(dj.graphs)])
    bt = tgraph.pad_graph_batch([dt.graphs[k] for k in sorted(dt.graphs)])
    return bj, bt


RECIPE = dict(n_nodes=32, number_epochs=40, learning_rate=2e-2, dropout=0.0, seed=3)
STOPS = {"per_graph": dict(patience=3, tolerance=8.0),      # the stop falls mid-chunk
         "batched": dict(patience=3, tolerance=8.0, step_mode="batched"),
         "cosine": dict(patience=100, lr_schedule="cosine", number_epochs=20),
         "dropout": dict(patience=3, tolerance=8.0, dropout=0.5)}


def _port_run(bt, K, **cfg):
    config = TrainingConfig(**{**RECIPE, **cfg, "epochs_per_call": K})
    return tloop.train_model(bt, config, device="cpu")


@pytest.mark.parametrize("case", list(STOPS))
def test_recipe_k8_is_bit_identical_to_k1(datasets, case):
    _, bt = datasets
    one, eight = (_port_run(bt, K, **STOPS[case]) for K in (1, 8))
    assert eight[4] == one[4] and eight[1] == one[1] and eight[2] == one[2]
    if case != "cosine":
        assert 0 < eight[2] < RECIPE["number_epochs"] - 1 and eight[2] % 8 != 7
    for layer in ("conv1", "conv2"):
        for k in ("w", "b"):
            assert torch.equal(eight[0][layer][k], one[0][layer][k])
    assert torch.equal(eight[3], one[3])


@pytest.mark.parametrize("case", ["per_graph", "batched"])
def test_recipe_k8_matches_jax_k8(datasets, case):
    bj, bt = datasets
    kw = {**RECIPE, **STOPS[case], "epochs_per_call": 8}
    state = jtrain.setup_train_state(jtrain.TrainingConfig(**kw))
    start = jax.tree_util.tree_map(np.asarray, state.params)
    rj = jtrain.train_model(bj, jtrain.TrainingConfig(**kw), state=state)
    cfg = TrainingConfig(**kw)
    steps = 3 if cfg.step_mode == "per_graph" else 1
    st = tloop.setup_train_state(cfg, steps, params=params_from_jax(start, "cpu"),
                                 device="cpu")
    rt = tloop.train_model(bt, cfg, state=st)
    assert rt[2] == rj[2] < RECIPE["number_epochs"] - 1
    np.testing.assert_allclose(rt[4], rj[4], rtol=1e-4)
    assert rt[1] == pytest.approx(rj[1], rel=1e-4)
    for layer in ("conv1", "conv2"):
        for k in ("w", "b"):
            np.testing.assert_allclose(rt[0][layer][k].numpy(), np.asarray(rj[0][layer][k]),
                                       rtol=1e-4, atol=1e-6)


def test_recipe_checkpoints_hold_their_epochs_state(datasets, tmp_path):
    """With checkpoints, chunks end at save epochs: the checkpoint of epoch
    e resumes to the uninterrupted run."""
    _, bt = datasets
    kw = dict(patience=100, number_epochs=12, save_frequency=5)
    full = _port_run(bt, 8, **kw, save_directory=str(tmp_path / "a" / "m"))
    ck = sorted((tmp_path / "a").glob("epoch_5_*.npz"))
    assert len(ck) == 1
    config = TrainingConfig(**{**RECIPE, **kw, "epochs_per_call": 8})
    resumed = tloop.train_model(bt, config, device="cpu", resume_from=str(ck[0]))
    assert resumed[4] == full[4]
    assert torch.equal(resumed[0]["conv1"]["w"], full[0]["conv1"]["w"])


def test_jax_chunk_end_checkpoint_resumes_off_the_run(datasets, tmp_path):
    """A reference fault the port does not copy: at K = 8 the JAX loop
    writes the chunk's last parameters under epoch 5's name, so resuming
    from that checkpoint leaves the uninterrupted run; the port's chunks
    end at save epochs and its resume stays on the run."""
    bj, bt = datasets
    kw = {**RECIPE, "patience": 100, "number_epochs": 12, "save_frequency": 5,
          "epochs_per_call": 8}
    state = jtrain.setup_train_state(jtrain.TrainingConfig(**kw))
    start = jax.tree_util.tree_map(np.asarray, state.params)
    full = jtrain.train_model(bj, jtrain.TrainingConfig(**kw, save_directory=str(tmp_path / "m")),
                              state=state)
    (ck,) = sorted(tmp_path.glob("epoch_5_*.npz"))
    resumed = jtrain.train_model(bj, jtrain.TrainingConfig(**kw), resume_from=str(ck))
    assert resumed[4][:6] == full[4][:6] and resumed[4][6:] != full[4][6:]
    cfg = TrainingConfig(**kw)
    state = tloop.setup_train_state(cfg, 3, params=params_from_jax(start, "cpu"), device="cpu")
    port = tloop.train_model(
        bt, dataclasses.replace(cfg, save_directory=str(tmp_path / "t" / "m")), state=state)
    np.testing.assert_allclose(port[4], full[4], rtol=1e-4)
    (ck,) = sorted((tmp_path / "t").glob("epoch_5_*.npz"))
    assert tloop.train_model(bt, cfg, device="cpu", resume_from=str(ck))[4] == port[4]


def _jax_packed_params(n, r, emb=32, G=16):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    return {"conv1": gcn_conv_init(k1, emb, G), "conv2": gcn_conv_init(k2, G, G),
            "embed": jax.random.normal(k3, (n // r, r * emb), jnp.float32) * 0.1}


def test_single_chip_giant_trainers_round_up_as_jax():
    """epochs = 3 at K = 2: JAX runs 2 whole chunks, 4 epochs; epochs = 1
    also runs two chunks (the second the first timed one)."""
    kw = dict(n=2048, bandwidth=31, epochs=3, epochs_per_call=2, agg_dtype=None,
              mu_dtype=None)
    with pltpu.force_tpu_interpret_mode():
        rj = jdemo.train_banded_giant_packed(**kw)
    rt = tdemo.train_banded_giant_packed(
        params=params_from_jax(_jax_packed_params(2048, 8), device="cpu"), device="cpu", **kw)
    assert rt["epochs"] == rj["epochs"] == len(rt["history"]) == 4
    np.testing.assert_allclose([rt["initial_cut"], rt["final_cut"]],
                               [rj["initial_cut"], rj["final_cut"]], rtol=1e-3)
    kw = dict(n=1024, bandwidth=31, epochs=1, epochs_per_call=2)
    with pltpu.force_tpu_interpret_mode():
        pj = jdemo.train_banded_giant(**kw)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = params_from_jax({"conv1": gcn_conv_init(k1, 32, 16), "conv2": gcn_conv_init(k2, 16, 3),
                              "embed": jax.random.normal(k3, (1024, 32), jnp.float32) * 0.1},
                             device="cpu")
    plain = tdemo.train_banded_giant(params=params, device="cpu", **kw)
    assert plain["epochs"] == pj["epochs"] == len(plain["history"]) == 4
    np.testing.assert_allclose(plain["final_cut"], pj["final_cut"], rtol=1e-3)
    assert chunk_sizes(0, 1, 2, first_two=True) == [2, 2]
    assert chunk_sizes(6, 12, 4) == [4, 4] and chunk_sizes(0, 10, 10) == [10]


def test_packed_giant_resume_runs_whole_chunks(tmp_path):
    kw = dict(n=1024, d=4, bandwidth=15, epochs_per_call=2, agg_dtype=None, mu_dtype=None,
              device="cpu")
    full = tdemo.train_banded_giant_packed(epochs=8, **kw)
    tdemo.train_banded_giant_packed(epochs=3, checkpoint_path=str(tmp_path / "ck"), **kw)
    resumed = tdemo.train_banded_giant_packed(epochs=7, resume_from=str(tmp_path / "ck"),
                                              **kw)
    # the 3-epoch run did 4 (two chunks); the resumed one chunk, to 8 = 4 + 4
    assert resumed["resumed_from_epoch"] == 4 and resumed["epochs"] == 8
    assert resumed["history"] == full["history"]


def test_halo_trainers_round_up_as_jax():
    n_dev, n_shard = 4, 128
    kw = dict(d=4, dim_embedding=16, hidden_dim=16, epochs=3, epochs_per_call=2,
              bandwidth=15, block=64, learning_rate=5e-3)
    jmesh = jgb.make_mesh(("graph",), devices=jax.devices()[:n_dev])
    with pltpu.force_tpu_interpret_mode():
        rj = jgb.train_halo_giant(n_shard, jgb.HaloGiantConfig(**kw), jmesh)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = params_from_jax({"conv1": gcn_conv_init(k1, 16, 16), "conv2": gcn_conv_init(k2, 16, 3),
                              "embed": jax.random.normal(k3, (n_dev * n_shard, 16)) * 0.1},
                             device="cpu")
    ring = make_mesh(devices=["cpu"] * n_dev)
    rt = tgb.train_halo_giant(n_shard, tgb.HaloGiantConfig(**kw), ring, params=params)
    assert rt["epochs"] == rj["epochs"] == len(rt["history"]) == 4
    np.testing.assert_allclose([rt["initial_cut"], rt["final_cut"]],
                               [rj["initial_cut"], rj["final_cut"]], rtol=1e-3)
    packed = tgb.train_halo_giant_packed(
        256, tgb.PackedHaloGiantConfig(d=4, bandwidth=15, epochs=3, epochs_per_call=2,
                                       agg_dtype=None, mu_dtype=None), ring)
    assert packed["epochs"] == len(packed["history"]) == 4


def _coo(edges):
    return (np.concatenate([edges[:, 0], edges[:, 1]]),
            np.concatenate([edges[:, 1], edges[:, 0]]))


def _conv_init(cfg):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    conv = {"conv1": gcn_conv_init(k1, cfg.dim_embedding, cfg.hidden_dim),
            "conv2": gcn_conv_init(k2, cfg.hidden_dim, cfg.num_classes)}
    return {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in conv.items()}, k3


def test_kway_trainer_rounds_up_as_jax(monkeypatch):
    """The node-sharded trainer of the k-way sweep at epochs = 5, K = 2 on
    a 4-shard ring: 6 epochs, each logged, as JAX."""
    n, D = 256, 4
    s, r = _coo(random_regular_edges(n, 4, seed=12))
    kw = dict(dim_embedding=16, hidden_dim=8, learning_rate=5e-3, number_epochs=5,
              epochs_per_call=2, log_every=1)
    jcfg = jgiant.GiantConfig(**kw)
    ref = jgiant.train_giant_graph(s, r, n, jcfg,
                                   mesh=jmake_mesh(("graph",), devices=jax.devices()[:D]))
    n_shard = jshard_graph(s, r, n, D)[0].n_shard
    conv, k3 = _conv_init(jcfg)
    p0 = {**conv, "embed": np.asarray(jax.random.normal(k3, (D, n_shard, 16), jnp.float32))}
    got = tgiant.train_giant_graph(s, r, n, tgiant.GiantConfig(**kw),
                                   mesh=make_mesh(devices=["cpu"] * D), params=p0)
    assert got["epochs"] == ref["epochs"] == 6 and len(got["loss_history"]) == 6
    np.testing.assert_allclose(got["loss_history"], ref["loss_history"], rtol=1e-3)
    seen = []

    def trainer(s, r, n, cfg, mesh, measure_throughput):     # the sweep's call, recorded
        seen.append(cfg)
        return tgiant.train_giant_graph(s, r, n, cfg, mesh)

    monkeypatch.setattr(tkway, "train_giant_graph", trainer)
    sweep = tkway.kway_sweep(n=256, d=4, ks=(3,), epochs=3, epochs_per_call=2,
                             dim_embedding=8, hidden_dim=4, device="cpu")
    assert seen[0].epochs_per_call == 2 and sweep[0]["k"] == 3


def test_hybrid_trainer_rounds_up_as_jax():
    n = 48
    kw = dict(dim_embedding=16, hidden_dim=16, number_epochs=5, epochs_per_call=2,
              learning_rate=5e-3, log_every=1)
    lists = [_coo(random_regular_edges(n, 6, seed=s)) for s in (1, 2)]
    ref = jhybrid.train_hybrid(lists, n, jgiant.GiantConfig(**kw), mesh_shape=(2, 4))
    cfg = tgiant.GiantConfig(**kw)
    n_shard = jshard_graph(*lists[0], n, 4)[0].n_shard
    conv, k3 = _conv_init(cfg)
    p0 = {**conv, "embed": np.asarray(jax.random.normal(k3, (2, 4, n_shard, 16), jnp.float32))}
    mesh = make_mesh(("data", "graph"), shape=(2, 4), devices=["cpu"] * 8)
    got = thybrid.train_hybrid(lists, n, cfg, mesh=mesh, params=p0)
    assert got["epochs"] == ref["epochs"] == 6 and len(got["loss_history"]) == 6
    np.testing.assert_allclose(got["loss_history"], ref["loss_history"], rtol=1e-3)
    np.testing.assert_allclose(got["per_graph_cuts"], ref["per_graph_cuts"], rtol=1e-3)


def _default(obj, name="epochs_per_call"):
    if dataclasses.is_dataclass(obj):
        return {f.name: f.default for f in dataclasses.fields(obj)}[name]
    return inspect.signature(obj).parameters[name].default


@pytest.mark.parametrize("pair", [
    (TrainingConfig, jtrain.TrainingConfig),
    (tgiant.GiantConfig, jgiant.GiantConfig),
    (tgb.HaloGiantConfig, jgb.HaloGiantConfig),
    (tgb.PackedHaloGiantConfig, jgb.PackedHaloGiantConfig),
    (tdemo.train_banded_giant, jdemo.train_banded_giant),
    (tdemo.train_banded_giant_packed, jdemo.train_banded_giant_packed),
    (tkway.kway_sweep, jkway.kway_sweep),
], ids=["TrainingConfig", "GiantConfig", "HaloGiantConfig", "PackedHaloGiantConfig",
        "train_banded_giant", "train_banded_giant_packed", "kway_sweep"])
def test_epochs_per_call_has_the_jax_default(pair):
    port, ref = pair
    assert _default(port) == _default(ref)


def test_make_giant_step_runs_chunks_of_any_length():
    n, D = 128, 2
    s, r = _coo(random_regular_edges(n, 4, seed=3))
    cfg = tgiant.GiantConfig(dim_embedding=8, hidden_dim=8, epochs_per_call=3)
    mesh = make_mesh(devices=["cpu"] * D)
    sg = tgiant.shard_graph(s, r, n, D)[0].to(mesh)
    p0 = locality_params(n, 8, 8, 3, 0)
    p0["embed"] = p0["embed"].reshape(D, n // D, -1)
    a, b = (tgiant.GiantState.create(p0, mesh, cfg.learning_rate) for _ in range(2))
    step_a = tgiant.make_giant_step(sg, mesh, cfg, a)
    step_b = tgiant.make_giant_step(sg, mesh, cfg, b, max_chunk=6)
    first = step_a()
    assert step_a.runner.max_chunk == 3 and first.shape == (3,)
    together = np.concatenate([first, step_a()])
    assert np.array_equal(step_b(6), together) and step_b.runner.eager_epochs == 6
    assert a.optimizer.count == b.optimizer.count == 6


def test_checked_raises_after_a_nan_chunk():
    w = torch.tensor([1.0, 2.0], requires_grad=True)
    opt = Adam([w], 0.1)
    poison = {"at": 3}

    def step():
        poison["at"] -= 1
        loss = (w * w).sum() * (float("nan") if poison["at"] == 0 else 1.0)
        opt.step(torch.autograd.grad(loss, [w]))
        return loss.detach()

    runner = ChunkRunner(step, ["cpu"], 4, optimizer=opt)
    run = checked(runner.run)
    losses, _ = run(2)                          # two finite epochs
    assert np.isfinite(losses).all()
    with pytest.raises(FloatingPointError, match="non-finite"):
        run(2)                                  # the third epoch's loss and gradient are NaN
    with pytest.raises(RuntimeError, match="before its first chunk"):
        checked(runner.run)
    with pytest.raises(TypeError):
        checked(lambda k: k)


def _python_number_adam(params, grads_seq, lr, b1=0.9, b2=0.999, eps=1e-8, mu_dtype=None):
    """The step written with Python numbers that the tables replaced."""
    mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    for count, grads in enumerate(grads_seq, start=1):
        rate = lr(count - 1) if callable(lr) else lr
        bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        for i, (p, g) in enumerate(zip(params, grads)):
            m = (1.0 - b1) * g + b1 * mu[i]
            v = (1.0 - b2) * (g * g) + b2 * nu[i]
            p.add_(((m / bc1) / (torch.sqrt(v / bc2) + eps)) * -rate)
            mu[i], nu[i] = m.to(mu[i].dtype), v
    return params, mu, nu


@pytest.mark.parametrize("case", ["constant", "cosine", "bf16_mu"])
def test_capturable_adam_equals_the_python_number_step(case):
    gen = torch.Generator().manual_seed(5)
    shapes = [(7, 5), (5,), ()]
    start = [torch.randn(s, generator=gen) for s in shapes]
    grads_seq = [[torch.randn(s, generator=gen) * 10 ** (i % 3 - 1) for s in shapes]
                 for i in range(25)]
    lr = cosine_decay_schedule(3e-2, 12, 0.05) if case == "cosine" else 3e-2
    mu_dtype = torch.bfloat16 if case == "bf16_mu" else None
    ref, mu, nu = _python_number_adam([p.clone() for p in start], grads_seq, lr,
                                      mu_dtype=mu_dtype)
    got = [p.clone() for p in start]
    opt = Adam(got, lr, mu_dtype=mu_dtype)
    for grads in grads_seq:
        opt.step(grads)
    assert opt.count == 25
    for a, b in zip(got + opt.mu + opt.nu, ref + mu + nu):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # past the tables' end the count is clamped where every value is constant
    late = Adam([torch.zeros(3)], lr)
    assert late._tables[:, -1].tolist() == late._tables[:, late._last].tolist()
    assert late._tables[1, -1] == late._tables[2, -1] == 1.0
    for b in (0.9, 0.999):                          # each table ends at 1
        assert np.float32(optim._bias_corrections(b)[-1]) == 1.0
    with pytest.raises(ValueError, match="schedule"):
        Adam([torch.zeros(1)], lambda t: 1e-3)
