"""The recipe's training loop: ``train_model`` on the seeded training set,
one captured epoch a call (``epochs_per_call`` 1, the default of
``train`` and ``pipeline``), early stopping kept on but set past the
window.  The window opens after the warm-up epochs and closes at the
first epoch callback after ``--seconds``; ``epoch_ms`` is its length
over the epochs completed in it."""

from __future__ import annotations

from benchmark import harness
from benchmark.counts import flops
from benchmark.entries import recipe_common as rc


def run(cell: harness.Cell, ref, t0: float) -> harness.Outcome:
    import torch

    c, tr = cell.config, cell.traffic
    graphs = rc.training_graphs(cell)
    params0 = rc.init_weights(cell.seed, c, cell.device)
    check = tr["check_epochs"]
    info = {"flops_per_epoch": flops.recipe_epoch(
        [(g.n, 2 * g.n_edges) for g in graphs], c["in_features"], c["hidden"], c["classes"])}
    if cell.control:
        values = rc.training_values(ref, graphs, params0, c, cell.device, check, None)
        return harness.Outcome(0.0, {}, {}, info, values, 0, 0, 0)

    batch = rc.program_batch(graphs, c)
    config = rc.training_config(c, number_epochs=10**9, patience=10**9, seed=cell.seed % 2**31)
    window = rc.EpochWindow(tr["warmup_epochs"], cell.seconds,
                            tr["trace_epochs"] if cell.trace else None, cell.device)
    _, first = rc.run_training(cell, graphs, batch, params0, config, then=window)
    harness.synchronize(cell.device)
    peak = torch.cuda.max_memory_allocated() if cell.device.startswith("cuda") else 0
    prog = {"losses": first.losses, "grad": first.grad, "change": first.change}
    del batch, first
    harness.free_device()
    values = rc.training_values(ref, graphs, params0, c, cell.device, check, prog)
    return harness.Outcome(
        setup_s=window.start - t0,
        metrics={"epoch_ms": (window.end - window.start) * 1e3 / window.epochs},
        units={"epochs": window.epochs},
        info=info, values=values, attempted=window.epochs, failed=0,
        memory_peak_bytes=peak, trace=window.trace)
