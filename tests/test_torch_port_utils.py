"""Port parity: the utils the trainers log, time and check with
(``utils/{logging,timing,profiling,debug}.py``) against the JAX package's
behaviour on the same inputs."""

import logging
import re

import numpy as np
import pytest
import torch

from gcn_maxcut_tpu.utils import debug as jdebug
from gcn_maxcut_tpu.utils import timing as jtiming
from gcn_maxcut_tpu_torch.utils import debug as tdebug
from gcn_maxcut_tpu_torch.utils import timing as ttiming
from gcn_maxcut_tpu_torch.utils.logging import get_logger
from gcn_maxcut_tpu_torch.utils.profiling import annotate, trace


def test_phase_timer_accumulates_and_summarises_as_jax():
    pt = ttiming.PhaseTimer()
    for name in ("train", "decode", "train"):
        with pt.phase(name):
            torch.ones(4).sum()
    assert list(pt.phases) == ["train", "decode"] and all(v > 0 for v in pt.phases.values())
    summaries = []
    for mod in (ttiming, jtiming):
        timer = mod.PhaseTimer()
        timer.phases = {"train": 2.25, "decode": 0.5}
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1] == "train: 2.25s\ndecode: 0.50s\ntotal: 2.75s"


def test_timer_measures_and_takes_nested_tensors():
    x = torch.ones(4)
    with ttiming.Timer(sync={"a": [x, (x * 2,)], "b": None}) as t:
        torch.cumsum(x, 0)
    assert t.elapsed > 0
    assert ttiming._cuda_devices({"a": [x], "b": 3}) == set()
    meta = torch.empty(2, device="meta")
    assert ttiming._cuda_devices([meta]) == set()


@pytest.mark.parametrize("tree,name", [
    ({"conv1": {"w": np.ones(3, np.float32), "b": np.array([1.0, np.nan], np.float32)}}, "params"),
    ([np.zeros(2, np.float32), (np.array([np.inf], np.float32),)], "tree"),
    ({"b": np.array([np.nan], np.float32), "a": np.array([-np.inf], np.float32)}, "grads"),
], ids=["dict", "nested-list", "sorted-keys"])
def test_assert_finite_names_the_path_as_jax(tree, name):
    with pytest.raises(FloatingPointError) as ref:
        jdebug.assert_finite(tree, name)
    torch_tree = _to_torch(tree)
    with pytest.raises(FloatingPointError) as got:
        tdebug.assert_finite(torch_tree, name)
    assert str(got.value) == str(ref.value)
    with pytest.raises(FloatingPointError, match=re.escape(str(ref.value))):
        tdebug.assert_finite(tree, name)             # numpy leaves too


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(tree)


def test_assert_finite_passes_finite_and_integer_leaves():
    tdebug.assert_finite({"w": torch.ones(2), "i": torch.tensor([3]), "n": None,
                          "a": np.arange(3)})


@pytest.mark.filterwarnings("ignore:Error detected in:UserWarning")
def test_debug_mode_catches_a_nan_gradient_and_restores():
    assert not torch.is_anomaly_enabled()
    x = torch.tensor([0.0], requires_grad=True)
    with tdebug.debug_mode():
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0.0 - 1.0).sum().backward()
    assert not torch.is_anomaly_enabled()


def test_trace_writes_a_timeline_with_the_annotation(tmp_path):
    with trace(tmp_path):
        with annotate("hybrid_epoch"):
            torch.ones(8).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    assert "hybrid_epoch" in files[0].read_text()


def test_get_logger_configures_the_package_logger_once():
    log = get_logger("gcn_maxcut_tpu_torch.parallel.hybrid")
    root = logging.getLogger("gcn_maxcut_tpu_torch")
    assert log.name == "gcn_maxcut_tpu_torch.parallel.hybrid"
    assert root.level == logging.INFO and len(root.handlers) == 1
    get_logger()
    assert len(root.handlers) == 1
    assert get_logger() is root
