"""The program's spans and counters (``utils/profiling.py``): recorded
while a ``torch.profiler`` session is active and only then, with host
totals and self times, and at the decode's stages and the chunk runner's
calls."""

import time

import numpy as np
import pytest
import torch

from gcn_maxcut_tpu_torch.data.generate import generate_graph_dataset
from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
from gcn_maxcut_tpu_torch.eval.harness import test_single_graph as decode_graph
from gcn_maxcut_tpu_torch.train.chunks import ChunkRunner
from gcn_maxcut_tpu_torch.train.config import TrainingConfig
from gcn_maxcut_tpu_torch.train.loop import setup_train_state
from gcn_maxcut_tpu_torch.utils import profiling

DECODE_SPANS = ("decode.graph", "decode.to_device", "decode.forward", "decode.rollouts",
                "decode.climb", "decode.readback")


@pytest.fixture(autouse=True)
def empty_totals():
    profiling.reset()
    yield
    profiling.reset()


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_nothing_is_recorded_without_a_profiler():
    with profiling.span("outer"):
        profiling.count("c", 3)
        torch.ones(4).sum()
    assert profiling.span_totals() == {} and profiling.counts() == {}


def test_a_span_is_a_profiler_event_and_its_total_counts():
    with _profiled() as prof:
        for _ in range(2):
            with profiling.span("stage"):
                torch.ones(8).sum()
        profiling.count("items", 2)
        profiling.count("items")
    assert "stage" in {e.name for e in prof.events()}
    totals = profiling.span_totals()
    assert set(totals) == {"stage"} and totals["stage"]["count"] == 2
    assert totals["stage"]["total_s"] > 0
    assert profiling.counts() == {"items": 3}
    with profiling.span("after"):
        profiling.count("items")
    assert set(profiling.span_totals()) == {"stage"} and profiling.counts() == {"items": 3}


def test_a_parents_self_time_is_its_total_less_its_childrens():
    with _profiled():
        with profiling.span("parent"):
            time.sleep(0.01)
            for _ in range(2):
                with profiling.span("child"):
                    time.sleep(0.005)
                    with profiling.span("grandchild"):
                        time.sleep(0.002)
    t = profiling.span_totals()
    assert t["child"]["count"] == 2 and t["grandchild"]["count"] == 2
    assert t["parent"]["self_s"] == pytest.approx(t["parent"]["total_s"] - t["child"]["total_s"],
                                                  abs=1e-9)
    assert t["child"]["self_s"] == pytest.approx(
        t["child"]["total_s"] - t["grandchild"]["total_s"], abs=1e-9)
    assert t["grandchild"]["self_s"] == t["grandchild"]["total_s"]
    assert t["parent"]["self_s"] >= 0.01


def test_trace_resets_the_totals_and_writes_the_spans(tmp_path):
    with _profiled():
        with profiling.span("before"):
            profiling.count("before")
    with profiling.trace(tmp_path):
        with profiling.span("inside"):
            torch.ones(8).sum()
    assert set(profiling.span_totals()) == {"inside"} and profiling.counts() == {}
    (chrome,) = tmp_path.glob("*.pt.trace.json")
    assert '"inside"' in chrome.read_text()


@pytest.fixture(scope="module")
def decode_case():
    specs, _ = generate_graph_dataset(num_graphs=1, min_nodes=40, max_nodes=40, min_degree=3,
                                      max_degree=5, base_seed=9)
    g = process_graphs(specs, DataConfig(max_nodes=64)).graphs[0]
    params = setup_train_state(TrainingConfig(n_nodes=64, seed=2), device="cpu").params()
    return g, params


def test_a_decoded_graph_records_each_stage_once_and_its_climb_steps(decode_case):
    g, params = decode_case
    with _profiled():
        res = decode_graph(params, g, torch.Generator().manual_seed(0), 50, refine=True,
                           measure_times=False)
    assert res["success"]
    totals = profiling.span_totals()
    assert {name: totals[name]["count"] for name in DECODE_SPANS} == dict.fromkeys(DECODE_SPANS, 1)
    stages = sum(totals[name]["total_s"] for name in DECODE_SPANS[1:])
    assert totals["decode.graph"]["total_s"] >= stages
    steps = profiling.counts()["climb.steps"]
    assert steps > 0 and "climb.captures" not in profiling.counts()      # no capture on the CPU
    untraced = decode_graph(params, g, torch.Generator().manual_seed(0), 50, refine=True,
                            measure_times=False)
    assert profiling.counts()["climb.steps"] == steps                  # off again
    for key in ("refined_assignment", "post_assignment", "node_probabilities"):
        np.testing.assert_array_equal(res[key], untraced[key])


def test_a_chunk_records_its_run_and_read_and_nothing_untraced():
    x = torch.zeros(())

    def step():
        x.add_(1.0)
        return x.clone()

    runner = ChunkRunner(step, ["cpu"], 4)
    runner.run(4)
    assert profiling.span_totals() == {}
    with _profiled():
        losses, _ = runner.run(3)
    np.testing.assert_array_equal(losses, [5.0, 6.0, 7.0])
    totals = profiling.span_totals()
    assert set(totals) == {"chunk.run", "chunk.read"}       # eager: no capture, no replays
    assert totals["chunk.run"]["count"] == totals["chunk.read"]["count"] == 1
    assert totals["chunk.run"]["self_s"] == pytest.approx(
        totals["chunk.run"]["total_s"] - totals["chunk.read"]["total_s"], abs=1e-9)
