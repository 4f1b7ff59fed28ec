"""The plain giant trainer (``bench/giant_demo.train_banded_giant``, node
order) against the benchmark's plain reference of its configuration
(``benchmark/reference/giant-plain-10m.py``, loaded by path), on the CPU
from the same seeded weights (``giant_demo.plain_params``): n = 4,096,
d = 8, bandwidth 63, the configuration's widths 32 → 16 → 3, 10 epochs in
chunks of 5.

Tolerances, each over the reference's own scale; readings on seeds 0, 1,
3 and 7, the test's seed 3 in brackets:

* losses, relative: 1e-6.  Both sides run the same float32 operations in
  the same order on the CPU (the plain banded sum is the reference's sum
  of rolls, the head the same softmax, pin and argmax), so the losses
  read equal (0 on every seed).  Aggregations on bfloat16 streams read
  ≥ 1.7e-3 (4.4e-3), a dropped terminal pin ≥ 6.3e-4 (3.5e-3).
* the first gradient, ‖g − g_ref‖ / ‖g_ref‖ by leaf: 1e-6.  Sound readings
  are ≤ 1.2e-7 (float32 reordering in autograd's sums); bfloat16 streams
  read ≥ 1.7e-2 (1.7e-2).  A dropped pin moves the first gradient only
  where a terminal's argmax is not its own class: 6.1e-3 on seed 3, as
  sound on seeds 1 and 7.
* the final parameters, ‖p − p_ref‖ over the reference's change
  ‖p_ref − p0‖ by leaf: 1e-4.  Adam rounds its bias corrections from the
  program's device tables where the reference uses Python numbers, and
  an entry whose gradient lies within rounding of zero may step the
  other way: sound readings are ≤ 1.1e-6 (3.9e-7); bfloat16 streams read
  ≥ 3.2e-2 (3.3e-2), a dropped pin ≥ 5.7e-3 (1.0e-2).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import gcn_maxcut_tpu_torch.bench.giant_demo as gd
from gcn_maxcut_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
N, DEGREE, BANDWIDTH, EMB, HIDDEN, CLASSES, LR, EPOCHS, SEED = 4096, 8, 63, 32, 16, 3, 1e-3, 10, 3
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-6, 1e-6, 1e-4
CONFIG = {"nodes": N, "degree": DEGREE, "classes": CLASSES, "learning_rate": LR}


def _reference_module():
    path = ROOT / "benchmark" / "reference" / "giant-plain-10m.py"
    spec = importlib.util.spec_from_file_location("giant_plain_10m_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _reference_module()


def _run_program(monkeypatch, params):
    """``train_banded_giant`` on the CPU; its losses, its first gradient and
    its final parameters by leaf."""
    seen = {}
    real = gd.chunk_step

    def watched(loss_fn, leaves, optimizer, *args, **kw):
        seen["leaves"] = leaves
        step = optimizer.step

        def first(grads):
            seen.setdefault("grads", [g.detach().clone() for g in grads])
            return step(grads)

        optimizer.step = first
        return real(loss_fn, leaves, optimizer, *args, **kw)

    monkeypatch.setattr(gd, "chunk_step", watched)
    out = gd.train_banded_giant(n=N, d=DEGREE, dim_embedding=EMB, hidden_dim=HIDDEN,
                                num_classes=CLASSES, learning_rate=LR, epochs=EPOCHS,
                                epochs_per_call=5, bandwidth=BANDWIDTH, seed=SEED,
                                params=params, device="cpu")

    def by_leaf(ts):
        return {name: t.detach() for name, t in zip(REF.LEAVES, ts)}

    return np.array(out["history"]), by_leaf(seen["grads"]), by_leaf(seen["leaves"])


def _gaps(monkeypatch):
    params = gd.plain_params(N, EMB, HIDDEN, CLASSES, SEED, "cpu")
    offsets = gd.circulant_offsets(DEGREE, BANDWIDTH, SEED)
    want = REF.Giant(CONFIG, offsets).train(params, EPOCHS)
    losses, grads, final = _run_program(monkeypatch, params)
    p0 = {name: params[name[:5]][name[6:]] if "." in name else params[name]
          for name in REF.LEAVES}
    assert len(losses) == EPOCHS
    loss = float(np.max(np.abs(losses - want["losses"]) / np.abs(want["losses"])))
    grad = max(float((grads[n] - want["grad0"][n]).norm() / want["grad0"][n].norm())
               for n in REF.LEAVES)
    param = max(float((final[n] - want["params"][n]).norm() / (want["params"][n] - p0[n]).norm())
                for n in REF.LEAVES)
    return loss, grad, param


def test_plain_giant_trainer_matches_the_plain_reference(monkeypatch):
    loss, grad, param = _gaps(monkeypatch)
    assert loss <= LOSS_TOL, loss
    assert grad <= GRAD_TOL, grad
    assert param <= PARAM_TOL, param


def test_the_reference_reports_the_norms_the_cell_compares():
    params = gd.plain_params(N, EMB, HIDDEN, CLASSES, SEED, "cpu")
    want = REF.Giant(CONFIG, gd.circulant_offsets(DEGREE, BANDWIDTH, SEED)).train(params, 2)
    assert len(want["losses"]) == 2 and set(want["first_grad"]) == set(REF.LEAVES)
    for name in REF.LEAVES:
        assert want["first_grad"][name] == pytest.approx(float(want["grad0"][name].norm()))
        p0 = params[name[:5]][name[6:]] if "." in name else params[name]
        assert want["change"][name] == pytest.approx(float((want["params"][name] - p0).norm()))


@pytest.mark.parametrize("fault", ["bfloat16_aggregation", "terminal_pin_dropped"])
def test_the_tolerances_fail_a_lower_precision_or_a_dropped_pin(monkeypatch, fault):
    """Each tolerance fails with the fault planted in the program."""
    if fault == "bfloat16_aggregation":
        real = gd.banded_spmm_unit

        def bf16(x, offsets):
            return real(x.to(torch.bfloat16), offsets).float()

        monkeypatch.setattr(gd, "banded_spmm_unit", bf16)
    else:
        monkeypatch.setattr(gd, "pin_terminals", lambda p: p)
    loss, grad, param = _gaps(monkeypatch)
    assert loss > LOSS_TOL and grad > GRAD_TOL and param > PARAM_TOL, (loss, grad, param)


def test_a_traced_call_records_the_giant_setup_span():
    """On the CPU the chunks run eagerly, so the capture span is the card
    case's (``test_cuda_a_traced_call_records_setup_and_capture``)."""
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        gd.train_banded_giant(n=512, d=4, bandwidth=15, epochs=4, epochs_per_call=2,
                              device="cpu")
    spans = profiling.span_totals()
    profiling.reset()
    assert spans["giant.setup"]["count"] == 1 and spans["giant.setup"]["total_s"] > 0
    assert spans["chunk.run"]["count"] == 2 and "chunk.capture" not in spans


@pytest.mark.cuda
def test_cuda_a_traced_call_records_setup_and_capture():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    profiling.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            gd.train_banded_giant(n=65536, epochs=4, epochs_per_call=2, device="cuda")
        spans = profiling.span_totals()
    finally:
        profiling.reset()
    assert spans["giant.setup"]["count"] == 1 and spans["chunk.capture"]["count"] == 1
    assert spans["chunk.replay"]["count"] == 2
