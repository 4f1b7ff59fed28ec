"""The k-way sweep of BASELINE config 4 on the node-sharded trainer, as
``bench --what kway`` runs it on a one-card machine: one d-regular graph
drawn from ``--seed`` in set-up, then jobs back to back, each one
``parallel.giant.train_giant_graph`` call on a ring of one card
(``epochs_per_job`` epochs in chunks of ``epochs_per_call``, the decoded
assignment returned), the classes cycling through the configuration's
list.  Each k's initial weights are drawn once from the seed, and every
job at that k starts from them.  Each job's partition, shard assembly,
state placement, capture and final decode count in the window, as a
user's call pays them.

Set-up runs one ``epochs_per_call`` job at the first and at the last k:
they build what the jobs run, and the reference follows both under the
watch ``giant_jobs.observed`` puts on the trainer's ``chunk_step``, and
``first_probs``'s on its first forward.  The
window opens at the next job and closes when the job running at
``--seconds`` ends; ``epoch_ms`` is the window over its jobs' epochs.
Every job's assignment is held, after the window, to what it states."""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict

import numpy as np
import torch

from benchmark import generator, harness
from benchmark.counts import flops
from benchmark.entries.giant_jobs import observed


def init_weights(seed: int, c: Dict[str, Any], k: int, device: str) -> Dict[str, Any]:
    """Glorot-uniform weights, zero biases and an N(0, 1) embedding in the
    trainer's layout (one shard: [1, n, emb]), drawn on the device from
    the seed and k."""
    gen = torch.Generator(device=device).manual_seed(
        generator.torch_seed(generator.rng(seed, generator.WEIGHTS, k)))
    out: Dict[str, Any] = {}
    for i, (a, b) in enumerate([(c["embedding"], c["hidden"]), (c["hidden"], k)], 1):
        lim = math.sqrt(6.0 / (a + b))
        out[f"conv{i}"] = {"w": torch.rand((a, b), generator=gen, device=device) * (2 * lim) - lim,
                           "b": torch.zeros(b, device=device)}
    out["embed"] = torch.randn((1, c["nodes"], c["embedding"]), generator=gen, device=device)
    return out


@contextlib.contextmanager
def first_probs(module, reading: Dict[str, Any]):
    """Inside, the trainer's first forward hands its softmax probabilities
    (before pinning, the shards' rows in order) to ``reading["probs"]`` as
    it pins them: an eager epoch's, before any capture.  Nothing else
    changes."""
    real = module._pin_and_ste

    def watched(probs, k):
        if "probs" not in reading:
            reading["probs"] = torch.cat([p.detach() for p in probs]).clone()
        return real(probs, k)

    module._pin_and_ste = watched
    try:
        yield reading
    finally:
        module._pin_and_ste = real


def answer_errors(assignment: np.ndarray, n: int, k: int) -> int:
    """Nodes whose returned class breaks what the answer states: n classes,
    each in [0, k), node i in class i for i < k (every node where the
    length is wrong)."""
    a = np.asarray(assignment)
    if a.shape != (n,):
        return n
    bad = (a < 0) | (a >= k)
    bad[:k] |= a[:k] != np.arange(k)
    return int(bad.sum())


def run(cell: harness.Cell, ref, t0: float) -> harness.Outcome:
    import gcn_maxcut_tpu_torch.parallel.giant as pg
    from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh

    c, tr = cell.config, cell.traffic
    n, d, ks, steps = c["nodes"], c["degree"], list(c["classes"]), tr["epochs_per_call"]
    if n % 8:
        raise ValueError(f"{n} nodes: one shard holds a multiple of 8 rows")
    edges = generator.regular_edges(n, d, generator.rng(cell.seed, generator.GRAPHS))
    src = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int32)
    dst = np.concatenate([edges[:, 1], edges[:, 0]]).astype(np.int32)
    params0 = {k: init_weights(cell.seed, c, k, cell.device) for k in ks}
    followed = (ks[0], ks[-1])

    def reference(k: int, tf32: bool = False) -> Dict[str, Any]:
        model = ref.KWay(edges, n, k, c["learning_rate"], cell.device)
        return model.train(params0[k], steps, tf32=tf32)

    def job(k: int, epochs: int, log_every: int = 20) -> Dict[str, Any]:
        config = pg.GiantConfig(
            num_classes=k, dim_embedding=c["embedding"], hidden_dim=c["hidden"],
            learning_rate=c["learning_rate"], number_epochs=epochs, epochs_per_call=steps,
            seed=cell.seed % 2**31, log_every=log_every)
        return pg.train_giant_graph(src, dst, n, config, mesh=make_mesh(devices=[cell.device]),
                                    params=params0[k], return_assignment=True)

    info: Dict[str, Any] = {}
    jobs, window, trace, answers = 0, (0.0, 0.0), None, []
    if cell.control:
        # the control, the reference in TF32, stands in the program's place
        prog = {k: reference(k, tf32=True) for k in followed}
        for p in prog.values():
            p["grad"], p["probs"] = p["first_grad"], p["probs0"]
    else:
        prog = {}
        for k in followed:
            reading: Dict[str, Any] = {}
            with observed(pg, params0[k], reading), first_probs(pg, reading):
                reading["losses"] = job(k, steps, log_every=1)["loss_history"][:steps]
            prog[k] = reading
        tracer = harness.TracedWindow(cell.device) if cell.trace else None
        if tracer is not None:
            tracer.start()
        start = harness.now()
        while True:
            k = ks[jobs % len(ks)]
            answers.append((k, job(k, tr["epochs_per_job"])["assignment"]))
            jobs += 1
            if tracer is not None:
                if jobs >= tr["trace_jobs"]:
                    trace = tracer.stop()
                    break
            elif harness.now() - start >= cell.seconds:
                break
        harness.synchronize(cell.device)
        window = (start, harness.now())
        info["flops_per_epoch"] = float(np.mean([flops.giant_epoch(n, d, c["embedding"],
                                                                   c["hidden"], k)
                                                 for k, _ in answers]))
    peak = torch.cuda.max_memory_allocated() if cell.device.startswith("cuda") else 0
    harness.free_device()

    def gaps(k: int) -> Dict[str, float]:
        want = reference(k)
        kept = harness.kept_leaves(want["first_grad"])
        return {
            "loss_gap": harness.loss_gap(prog[k]["losses"], want["losses"]),
            "grad_gap": harness.leaf_gap(prog[k]["grad"], want["first_grad"], kept),
            "change_gap": harness.leaf_gap(prog[k]["change"], want["change"], kept),
            "prob_gap": float((prog[k]["probs"].to(want["probs0"].device)
                               - want["probs0"]).abs().max()),
        }

    per_k = [gaps(k) for k in followed]
    values = {name: max(g[name] for g in per_k) for name in per_k[0]}
    values["answer_errors"] = float(sum(answer_errors(a, n, k) for k, a in answers))
    epochs = jobs * tr["epochs_per_job"]
    return harness.Outcome(
        setup_s=window[0] - t0 if window[0] else 0.0,
        metrics={"epoch_ms": (window[1] - window[0]) * 1e3 / epochs} if epochs else {},
        units={"epochs": epochs, "jobs": jobs}, info=info, values=values,
        attempted=jobs, failed=0, memory_peak_bytes=peak, trace=trace)
