"""The default decode of the ``test`` command, one graph a call, on weights
the plain reference trained: set-up trains the recipe model with the
reference (``train_epochs`` epochs, the ``pipeline`` default; its seconds
are left out of ``setup_s``), makes the held-out set (``graphs_per_size``
graphs at each of ``sizes``, each size processed on its own as the
quality suite does) and decodes each graph once.  The window calls
``test_single_graph`` (``rollouts`` samples, then the ``refine_starts``
climb) on the set as ``test`` sends it, each size's graphs together
(in an order drawn from the seed) and the sizes in turn, pass after
pass, each call with its own seeded generator, until ``--seconds``.  A
graph's latency runs from the call to its return, which ends in host
copies.  Whatever a pass of ``test`` pays at each change of size (the
climb of a padded shape the program no longer keeps is captured again)
is in the window as it is in ``test``."""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark import generator, harness
from benchmark.entries import recipe_common as rc


def heldout(cell: harness.Cell) -> List[generator.GraphData]:
    tr = cell.traffic
    return [g for i, size in enumerate(tr["sizes"])
            for g in generator.regular_graphs(cell.seed, generator.HELDOUT + 10 * i,
                                              [size] * tr["graphs_per_size"],
                                              cell.config["degree"])]


def program_heldout(graphs: List[generator.GraphData], config: Dict[str, Any]) -> list:
    """Each size's graphs processed together, on their own."""
    out = []
    for size in dict.fromkeys(g.n for g in graphs):
        out += rc.program_graphs([g for g in graphs if g.n == size], config)
    return out


def pass_order(cell: harness.Cell, graphs: List[generator.GraphData]) -> List[int]:
    """One pass over the set: the sizes in turn, each size's graphs
    together in an order drawn from the seed."""
    gen = generator.rng(cell.seed, generator.ORDER)
    order: List[int] = []
    for size in dict.fromkeys(g.n for g in graphs):
        ids = [i for i, g in enumerate(graphs) if g.n == size]
        order += [ids[j] for j in gen.permutation(len(ids))]
    return order


def reference_weights(cell: harness.Cell, ref) -> Dict[str, Dict[str, torch.Tensor]]:
    """The decode's weights: the plain reference's training of the seeded
    initial weights on the seeded training set, in the program's layout."""
    c, dev = cell.config, cell.device
    graphs = rc.reference_graphs(ref, rc.training_graphs(cell), c, dev)
    trained = ref.train(rc.init_weights(cell.seed, c, dev), graphs, c,
                        epochs=cell.traffic["train_epochs"])["params"]
    return {a: {b: trained[f"{a}.{b}"].contiguous() for b in "wb"} for a in ("conv1", "conv2")}


def run(cell: harness.Cell, ref, t0: float) -> harness.Outcome:
    from gcn_maxcut_tpu_torch.baselines import local_search
    from gcn_maxcut_tpu_torch.eval import harness as program

    c, tr = cell.config, cell.traffic
    dev = cell.device
    t_ref = time.perf_counter()
    weights = reference_weights(cell, ref)
    harness.synchronize(dev)
    ref_s = time.perf_counter() - t_ref            # the reference's, not the program's set-up
    harness.free_device()
    if dev.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    sets = heldout(cell)
    draws = generator.rng(cell.seed, generator.DRAWS)
    terminals = c["terminals"]

    def decode(g, seed: int) -> Dict[str, Any]:
        gen = torch.Generator(device=dev).manual_seed(seed)
        return program.test_single_graph(
            weights, g, gen, tr["rollouts"], terminals=list(range(terminals)), refine=True,
            measure_times=False, refine_starts=tr["refine_starts"])

    answers: List[tuple] = []           # (graph index, generator seed, result, latency)
    trace, window = None, (0.0, 0.0)
    n_pad = {}
    if not cell.control:
        items = program_heldout(sets, c)
        n_pad = {i: int(g.n_pad) for i, g in enumerate(items)}
        order = pass_order(cell, sets)
        for i in order:                           # one pass: every padded shape warmed
            decode(items[i], generator.torch_seed(draws))
        tracer = harness.TracedWindow(dev) if cell.trace else None
        if tracer is not None:
            tracer.start()
        start = harness.now()
        while True:
            i = order[len(answers) % len(order)]
            seed = generator.torch_seed(draws)
            t = harness.now()
            res = decode(items[i], seed)
            answers.append((i, seed, res, harness.now() - t))
            if tracer is not None:
                if len(answers) >= tr["trace_graphs"]:
                    trace = tracer.stop()
                    break
            elif harness.now() - start >= cell.seconds:
                break
        window = (start, harness.now())
        del items
        local_search.clear_climbs()
    peak = torch.cuda.max_memory_allocated() if dev.startswith("cuda") else 0
    harness.free_device()

    values = judge(cell, ref, sets, answers, weights, n_pad)
    done = [a for a in answers if a[2].get("success")]
    firsts = {}
    for i, _, res, _ in done:
        firsts.setdefault(i, res)
    cut_per_edge = float(np.mean([
        ref.assignment_cut(sets[i].edges, res["refined_assignment"]) / sets[i].n_edges
        for i, res in firsts.items()])) if firsts else float("nan")
    latencies = [a[3] for a in answers]
    metrics = {}
    if answers:
        metrics = {"decode_graphs_per_s": len(answers) / (window[1] - window[0]),
                   "decode_p95_ms": harness.percentile(latencies, 95) * 1e3,
                   "cut_per_edge": cut_per_edge}
    return harness.Outcome(
        setup_s=window[0] - t0 - ref_s if window[0] else 0.0, metrics=metrics,
        units={"graphs": len(answers)}, info={}, values=values, attempted=len(answers),
        failed=len(answers) - len(done), memory_peak_bytes=peak, trace=trace)


def judge(cell: harness.Cell, ref, sets, answers, weights, n_pad) -> Dict[str, float]:
    """The decode's numbers.  ``answer_errors``: every answer whose own
    statements fail (``answer_faults``).  On a seeded sample of the answers
    (with the first of the largest graph): ``prob_gap``, the largest gap of
    a returned probability from the reference's forward of the weights;
    ``cut_gap``, the largest gap, in edges, of the best rollout's cut or
    the refined cut from the reference's decode of the returned
    probabilities with the same uniforms.  In the control the reference in
    TF32 answers a sample of graphs drawn alike, in the program's place."""
    c, tr = cell.config, cell.traffic
    t, k = c["terminals"], c["classes"]
    errors = sum(1 for i, _, res, _ in answers
                 if not res.get("success") or ref.answer_faults(sets[i].edges, sets[i].n, k, t, res))
    gen = generator.rng(cell.seed, generator.SAMPLE)
    if cell.control:
        picked = [(int(i), generator.torch_seed(gen), None)
                  for i in gen.choice(len(sets), tr["checked_answers"])]
        n_pad = {i: sets[i].n for i, _, _ in picked}
    else:
        ok = [a for a in answers if a[2].get("success")]
        largest = next((a for a in ok if sets[a[0]].n == max(g.n for g in sets)), None)
        chosen = [ok[j] for j in gen.choice(len(ok), min(tr["checked_answers"], len(ok)),
                                            replace=False)]
        picked = [(a[0], a[1], a[2]) for a in chosen + [largest] if a]
    params = {f"{a}.{b}": weights[a][b] for a in ("conv1", "conv2") for b in "wb"}
    prob_gap = cut_gap = 0.0
    for i, seed, res in picked:
        g = ref.DenseGraph(sets[i].n, sets[i].edges, c["in_features"], cell.device)
        want = ref.probabilities(params, g)
        u = ref.uniforms(seed, tr["rollouts"], n_pad[i], cell.device)[:, : sets[i].n]
        probs = (ref.probabilities(params, g, tf32=True) if res is None
                 else torch.as_tensor(res["node_probabilities"], device=cell.device))
        prob_gap = max(prob_gap, float((probs - want).abs().max()))
        dec = ref.decode(probs.cpu().numpy(), u.cpu().numpy(), sets[i].edges, t,
                         tr["refine_starts"])
        res = dec if res is None else res         # the control answers in the program's place
        cut_gap = max(cut_gap, abs(res["post_cut"] - dec["post_cut"]),
                      abs(res["refined_cut"] - dec["refined_cut"]))
    return {"answer_errors": float(errors), "prob_gap": prob_gap, "cut_gap": float(cut_gap)}
