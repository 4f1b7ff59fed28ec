"""Jobs of the packed giant trainer back to back, as ``bench --what giant``
runs one: ``train_banded_giant_packed`` at its defaults, ``epochs_per_job``
epochs in chunks of ``epochs_per_call``, the jobs' graphs a pool of
``job_graphs`` circulant graphs taken in an order drawn from ``--seed``,
all from the same initial weights drawn from it.  The
set-up job, of ``epochs_per_call`` epochs, builds the kernels and is the
one the reference follows; the
window opens at the next job and closes when the job running at
``--seconds`` ends.  ``epoch_ms`` is the window over its epochs, so each
job's start-up and capture count."""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict

import torch

from benchmark import generator, harness
from benchmark.counts import bytes as nbytes
from benchmark.counts import flops

LEAVES = ("conv1.w", "conv1.b", "conv2.w", "conv2.b", "embed")


def init_weights(seed: int, c: Dict[str, Any], device: str) -> Dict[str, Any]:
    """Glorot-uniform weights (the classes padded to 16 lanes), zero biases
    and an N(0, 0.1²) embedding in the packed [n/r, r·emb] layout, drawn
    on the device from the seed."""
    gen = torch.Generator(device=device).manual_seed(
        generator.torch_seed(generator.rng(seed, generator.WEIGHTS)))
    lanes = c["lanes"]
    out: Dict[str, Any] = {}
    for i, (a, b) in enumerate([(c["embedding"], c["hidden"]), (c["hidden"], lanes)], 1):
        lim = math.sqrt(6.0 / (a + b))
        out[f"conv{i}"] = {"w": torch.rand((a, b), generator=gen, device=device) * (2 * lim) - lim,
                           "b": torch.zeros(b, device=device)}
    r = c["r"]
    out["embed"] = torch.randn((c["nodes"] // r, r * c["embedding"]), generator=gen,
                               device=device) * 0.1
    return out


def _leaf(params: Dict[str, Any], name: str) -> torch.Tensor:
    return params["embed"] if name == "embed" else params[name[:5]][name[6:]]


@contextlib.contextmanager
def observed(module, params0: Dict[str, Any], reading: Dict[str, Any]):
    """Inside, the trainer's ``chunk_step`` is watched: the first step's
    gradient norms are read from the optimizer after that step
    (``harness.watch_first_step``), and after the first chunk the
    parameters' change, outside the captured epochs; nothing else
    changes."""
    real = module.chunk_step

    def watched(loss_fn, leaves, optimizer, devices, per_call, *args, **kw):
        chunk = real(loss_fn, leaves, optimizer, devices, per_call, *args, **kw)
        if not reading:
            reading["grad"] = {}
            harness.watch_first_step(optimizer, list(LEAVES), reading["grad"])

        def first(k=per_call):
            out = chunk(k)
            if "change" not in reading:
                with torch.no_grad():
                    reading["change"] = {n: float((p.double() - _leaf(params0, n).double()).norm())
                                         for n, p in zip(LEAVES, leaves)}
            return out

        first.runner = chunk.runner
        return first

    module.chunk_step = watched
    try:
        yield reading
    finally:
        module.chunk_step = real


def run(cell: harness.Cell, ref, t0: float) -> harness.Outcome:
    import gcn_maxcut_tpu_torch.bench.giant_demo as gd

    c, tr = cell.config, cell.traffic
    n, steps = c["nodes"], tr["epochs_per_call"]
    params0 = init_weights(cell.seed, c, cell.device)

    def job(i: int, epochs: int, act_dtype=None) -> Dict[str, Any]:
        return gd.train_banded_giant_packed(
            n=n, d=c["degree"], dim_embedding=c["embedding"], hidden_dim=c["hidden"],
            num_classes=c["classes"], learning_rate=c["learning_rate"],
            epochs=epochs, epochs_per_call=steps, bandwidth=c["bandwidth"],
            r=c["r"], seed=generator.job_seed(cell.seed, i, tr["job_graphs"]),
            agg_dtype=c["aggregation_dtype"], act_dtype=act_dtype,
            mu_dtype=c["adam_mu_dtype"], params=params0, device=cell.device)

    info = {"flops_per_epoch": flops.giant_epoch(n, c["degree"], c["embedding"], c["hidden"],
                                                 c["classes"]),
            "k3_bytes_per_epoch": nbytes.giant_packed_epoch_k3(n, c["lanes"], 2)}
    reading: Dict[str, Any] = {}
    with observed(gd, params0, reading):
        # the control: the program's own lower precision, activations in bf16
        # one chunk's job: it builds K3, captures the chunk and gives the
        # steps the reference follows (the trainer runs at least two chunks)
        first = job(0, steps, act_dtype="bfloat16" if cell.control else None)
    reading["losses"] = first["history"][:steps]
    del first
    jobs, window, trace = 0, (0.0, 0.0), None
    if not cell.control:
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
    offsets = generator.circulant_offsets(c["degree"], c["bandwidth"],
                                          generator.job_seed(cell.seed, 0, tr["job_graphs"]))
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
