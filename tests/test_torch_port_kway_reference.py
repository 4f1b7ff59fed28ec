"""The node-sharded trainer of BASELINE config 4 (``parallel/giant.
train_giant_graph``) against the benchmark's plain reference of that
configuration (``benchmark/reference/kway-100k.py``, loaded by path), on
the CPU from the same seeded weights (``bench.locality.locality_params``):
n = 512, d = 8, the configuration's widths (128 → 64 → k), k = 3 and 8,
on one shard and on a 4-shard CPU ring, 10 epochs in chunks of 5.

Tolerances, each over the reference's own scale:

* losses, relative: 1e-4.  Both sides sum the same float32 terms in
  another order (ELL gathers against ``index_add_``, rsqrt·rsqrt against
  one rsqrt a side); they read equal here, and a float32 reordering of a
  few thousand unit terms is ~1e-6.  Aggregations in bfloat16 read
  2.8e-3 or more, a dropped terminal pin 5.5e-3 or more.
* the first gradient, ‖g − g_ref‖ / ‖g_ref‖ by leaf: 1e-5.  Sound readings
  are ≤ 3e-7 (float32 reordering); bfloat16 aggregations read ≥ 1.3e-2,
  a dropped pin ≥ 1.2e-2.
* the final parameters, ‖p − p_ref‖ over the reference's change
  ‖p_ref − p0‖ by leaf: 2e-3.  Adam's first step is lr·sign(g), so an
  entry whose gradient lies within rounding of zero may step the other
  way: sound readings are ≤ 1.3e-4; bfloat16 aggregations read ≥ 3.4e-2,
  a dropped pin ≥ 3.6e-2.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import gcn_maxcut_tpu_torch.parallel.giant as pg
import gcn_maxcut_tpu_torch.parallel.spmm as spmm
from gcn_maxcut_tpu_torch.bench.locality import locality_params
from gcn_maxcut_tpu_torch.data.generate import random_regular_edges
from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh
from gcn_maxcut_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
N, DEGREE, EMB, HIDDEN, LR, EPOCHS, SEED = 512, 8, 128, 64, 1e-3, 10, 0
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-4, 1e-5, 2e-3


def _reference_module():
    path = ROOT / "benchmark" / "reference" / "kway-100k.py"
    spec = importlib.util.spec_from_file_location("kway_100k_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _reference_module()


@pytest.fixture(scope="module")
def edges():
    return random_regular_edges(N, DEGREE, seed=SEED)


def _config(k):
    return pg.GiantConfig(num_classes=k, dim_embedding=EMB, hidden_dim=HIDDEN,
                          learning_rate=LR, number_epochs=EPOCHS, epochs_per_call=5,
                          log_every=1)


def _run_program(monkeypatch, edges, k, shards, params):
    """``train_giant_graph`` on a CPU ring of ``shards``; its losses, its
    first gradient and its final parameters by leaf, the embedding's
    blocks joined in node order (contiguous partition)."""
    seen = {}
    real = pg.chunk_step

    def watched(loss_fn, leaves, optimizer, *args, **kw):
        seen["leaves"] = leaves
        step = optimizer.step

        def first(grads):
            seen.setdefault("grads", [g.detach().clone() for g in grads])
            return step(grads)

        optimizer.step = first
        return real(loss_fn, leaves, optimizer, *args, **kw)

    monkeypatch.setattr(pg, "chunk_step", watched)
    src = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int32)
    dst = np.concatenate([edges[:, 1], edges[:, 0]]).astype(np.int32)
    p = dict(params, embed=params["embed"].reshape(shards, N // shards, EMB))
    out = pg.train_giant_graph(src, dst, N, _config(k), mesh=make_mesh(devices=["cpu"] * shards),
                               params=p)

    def by_leaf(ts):
        d = dict(zip(REF.LEAVES[:4], ts[:4]))
        d["embed"] = torch.cat(list(ts[4:]))
        return {name: t.detach() for name, t in d.items()}

    return np.array(out["loss_history"]), by_leaf(seen["grads"]), by_leaf(seen["leaves"])


def _gaps(monkeypatch, edges, k, shards):
    params = locality_params(N, EMB, HIDDEN, k, SEED)
    want = REF.KWay(edges, N, k, LR, "cpu").train(params, EPOCHS)
    losses, grads, final = _run_program(monkeypatch, edges, k, shards, params)
    p0 = {name: torch.as_tensor(params[name[:5]][name[6:]] if "." in name else params[name])
          for name in REF.LEAVES}
    loss = float(np.max(np.abs(losses - want["losses"]) / np.abs(want["losses"])))
    grad = max(float((grads[n] - want["grad0"][n]).norm() / want["grad0"][n].norm())
               for n in REF.LEAVES)
    param = max(float((final[n] - want["params"][n]).norm() / (want["params"][n] - p0[n]).norm())
                for n in REF.LEAVES)
    return loss, grad, param


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_trainer_matches_the_plain_reference(monkeypatch, edges, k, shards):
    loss, grad, param = _gaps(monkeypatch, edges, k, shards)
    assert loss <= LOSS_TOL, loss
    assert grad <= GRAD_TOL, grad
    assert param <= PARAM_TOL, param


@pytest.mark.parametrize("fault", ["bfloat16_aggregation", "terminal_pin_dropped"])
def test_the_tolerances_fail_a_lower_precision_or_a_dropped_pin(monkeypatch, edges, fault):
    """Each tolerance fails with the fault planted in the program."""
    if fault == "bfloat16_aggregation":
        real = spmm._group_aggregate

        def bf16(sg, d, s, x):
            out = real(sg, d, s, x.to(torch.bfloat16).float())
            return out.to(torch.bfloat16).float()

        monkeypatch.setattr(spmm, "_group_aggregate", bf16)
    else:
        monkeypatch.setattr(pg, "pin_terminals", lambda p, k: p)
    loss, grad, param = _gaps(monkeypatch, edges, 3, 1)
    assert loss > LOSS_TOL and grad > GRAD_TOL and param > PARAM_TOL, (loss, grad, param)


def test_a_traced_call_records_the_sharded_spans(edges):
    src = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int32)
    dst = np.concatenate([edges[:, 1], edges[:, 0]]).astype(np.int32)
    config = pg.GiantConfig(num_classes=3, dim_embedding=16, hidden_dim=8, number_epochs=4,
                            epochs_per_call=2)
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = pg.train_giant_graph(src, dst, N, config, mesh=make_mesh(devices=["cpu"] * 2),
                                   return_assignment=True)
    spans = profiling.span_totals()
    profiling.reset()
    for name in ("sharded.partition", "sharded.assemble", "sharded.setup", "sharded.decode"):
        assert spans[name]["count"] == 1 and spans[name]["total_s"] > 0, name
    assert spans["chunk.run"]["count"] == 2
    assert out["assignment"].shape == (N,)
