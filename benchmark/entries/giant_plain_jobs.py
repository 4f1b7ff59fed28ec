"""Jobs of the plain giant trainer back to back, as ``bench --what giant
--giant-layout plain`` runs one: ``train_banded_giant`` at its defaults
(node order, float32 throughout), ``epochs_per_job`` epochs in chunks of
``epochs_per_call``, the jobs' graphs a pool of ``job_graphs`` circulant
graphs taken in an order drawn from ``--seed``, all from the same initial
weights drawn from it.  The set-up job, of ``epochs_per_call`` epochs,
builds the kernels and is the one the reference follows, under the watch
``giant_jobs.observed`` puts on the trainer's ``chunk_step``; the window
opens at the next job and closes when the job running at ``--seconds``
ends.  ``epoch_ms`` is the window over its epochs, so each job's start-up
and capture count.  The control, the reference on bfloat16 aggregation
streams, stands in the program's place."""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from benchmark import generator, harness
from benchmark.counts import flops, giant_plain
from benchmark.entries.giant_jobs import observed

CONTROL_STREAM = torch.bfloat16


def init_weights(seed: int, c: Dict[str, Any], device: str) -> Dict[str, Any]:
    """Glorot-uniform weights, zero biases and an N(0, 0.1²) embedding in
    the plain layout (embedding [n, emb], conv2 [hidden, classes]), drawn
    on the device from the seed."""
    gen = torch.Generator(device=device).manual_seed(
        generator.torch_seed(generator.rng(seed, generator.WEIGHTS)))
    out: Dict[str, Any] = {}
    for i, (a, b) in enumerate([(c["embedding"], c["hidden"]), (c["hidden"], c["classes"])], 1):
        lim = math.sqrt(6.0 / (a + b))
        out[f"conv{i}"] = {"w": torch.rand((a, b), generator=gen, device=device) * (2 * lim) - lim,
                           "b": torch.zeros(b, device=device)}
    out["embed"] = torch.randn((c["nodes"], c["embedding"]), generator=gen, device=device) * 0.1
    return out


def run(cell: harness.Cell, ref, t0: float) -> harness.Outcome:
    import gcn_maxcut_tpu_torch.bench.giant_demo as gd

    c, tr = cell.config, cell.traffic
    n, steps = c["nodes"], tr["epochs_per_call"]
    params0 = init_weights(cell.seed, c, cell.device)
    offsets = generator.circulant_offsets(c["degree"], c["bandwidth"],
                                          generator.job_seed(cell.seed, 0, tr["job_graphs"]))

    def job(i: int, epochs: int) -> Dict[str, Any]:
        return gd.train_banded_giant(
            n=n, d=c["degree"], dim_embedding=c["embedding"], hidden_dim=c["hidden"],
            num_classes=c["classes"], learning_rate=c["learning_rate"],
            epochs=epochs, epochs_per_call=steps, bandwidth=c["bandwidth"],
            seed=generator.job_seed(cell.seed, i, tr["job_graphs"]), params=params0,
            device=cell.device)

    info = {"flops_per_epoch": flops.giant_epoch(n, c["degree"], c["embedding"], c["hidden"],
                                                 c["classes"]),
            "k2_bytes_per_epoch": giant_plain.k2_epoch(n, c["hidden"]),
            "f3_bytes_per_epoch": giant_plain.f3_epoch(n, c["classes"])}
    jobs, window, trace = 0, (0.0, 0.0), None
    reading: Dict[str, Any] = {}
    if cell.control:
        reading.update(ref.Giant(c, offsets, CONTROL_STREAM).train(params0, steps))
        reading["grad"] = reading["first_grad"]
    else:
        with observed(gd, params0, reading):
            # one chunk's job: it builds the kernels, captures the chunk and
            # gives the steps the reference follows (the trainer runs at
            # least two chunks)
            reading["losses"] = job(0, steps)["history"][:steps]
        tracer = harness.TracedWindow(cell.device) if cell.trace else None
        if tracer is not None:
            tracer.start()
        start = harness.now()
        while True:
            job(jobs + 1, tr["epochs_per_job"])
            jobs += 1
            if tracer is not None:
                if jobs >= tr["trace_jobs"]:
                    trace = tracer.stop()
                    break
            elif harness.now() - start >= cell.seconds:
                break
        harness.synchronize(cell.device)
        window = (start, harness.now())
    peak = torch.cuda.max_memory_allocated() if cell.device.startswith("cuda") else 0
    harness.free_device()
    want = ref.Giant(c, offsets).train(params0, steps)
    kept = harness.kept_leaves(want["first_grad"])
    values = {
        "loss_gap": harness.loss_gap(reading["losses"], want["losses"]),
        "grad_gap": harness.leaf_gap(reading["grad"], want["first_grad"], kept),
        "change_gap": harness.leaf_gap(reading["change"], want["change"], kept),
    }
    epochs = jobs * tr["epochs_per_job"]
    return harness.Outcome(
        setup_s=window[0] - t0 if window[0] else 0.0,
        metrics={"epoch_ms": (window[1] - window[0]) * 1e3 / epochs} if epochs else {},
        units={"epochs": epochs, "jobs": jobs}, info=info, values=values,
        attempted=jobs, failed=0, memory_peak_bytes=peak, trace=trace)
