"""The FLOP and byte counts behind train_mfu and k3_roofline, at tiny shapes."""

import json
from pathlib import Path

import pytest

from benchmark.counts import bytes as nbytes
from benchmark.counts import flops, peaks

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def test_linear_counts_a_backward_product_less_without_input_gradient():
    assert flops.linear(5, 3, 2, input_grad=True) == 3 * 2 * 5 * 3 * 2
    assert flops.linear(5, 3, 2, input_grad=False) == 2 * 2 * 5 * 3 * 2


@pytest.mark.parametrize("weighted, factor", [(False, 1), (True, 2)])
def test_aggregation_counts_edges_times_width(weighted, factor):
    assert flops.aggregation(10, 4, weighted) == 2 * 10 * 4 * factor


def test_gcn_layer_aggregates_at_the_narrower_side():
    assert flops.gcn_layer(6, 12, 8, 3, True) == flops.linear(6, 8, 3, True) + 2 * 12 * 3
    assert flops.gcn_layer(6, 12, 3, 8, True) == flops.linear(6, 3, 8, True) + 2 * 12 * 3


def test_recipe_graph_by_hand():
    n, e, i, h, k = 4, 8, 6, 3, 2
    want = (2 * 2 * n * i * h + 2 * e * h) + (3 * 2 * n * h * k + 2 * e * k) + 2 * e * k
    assert flops.recipe_graph(n, e, i, h, k) == want
    assert flops.recipe_epoch([(n, e), (n, e)], i, h, k) == 2 * want


def test_recipe_is_about_a_gigaflop_a_graph():
    c = json.loads((CONFIGS / "recipe-n500.json").read_text())
    one = flops.recipe_graph(500, 500 * 7, c["in_features"], c["hidden"], c["classes"])
    assert 1.0e9 < one < 1.02e9


def test_giant_epoch_is_3712_flops_a_node():
    c = json.loads((CONFIGS / "giant-packed-10m.json").read_text())
    got = flops.giant_epoch(c["nodes"], c["degree"], c["embedding"], c["hidden"], c["classes"])
    assert got == 3712 * c["nodes"]
    assert flops.giant_epoch(16, 8, 32, 16, 3) == 3712 * 16


def test_k3_bytes_read_and_write_each_stream_once():
    assert nbytes.banded_unit_call(10, 16, 2) == 2 * 10 * 16 * 2
    assert nbytes.giant_packed_epoch_k3(10) == 6 * 2 * 10 * 16 * 2


def test_peaks_by_device_name():
    assert peaks.peak("NVIDIA H100 80GB HBM3")["f32_flops"] == 67e12
    assert peaks.peak("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert peaks.peak("NVIDIA A100-SXM4-40GB") is None
