#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gcn_maxcut_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit code:

  1. build      compile every ``gcn_maxcut_tpu_torch/csrc/*.cu``
                (``banded_stream.cu``: K4; ``block_ell_gather.cu``: K1;
                ``halo_stream.cu``: K5, K6, and K2, K3 as a one-shard ring,
                where rows take 16-byte copies; ``banded_window.cu``: K2,
                K3 and K4 at other widths and their earlier body and, in its
                halo mode, K5's and K6's;
                ``subblock_stream.cu``: P3's ring; ``probe_kernels.cu``: the
                probes' warp gathers (P1/P2's window_warp_gather, P4's
                panel_ell_gather) and P5a's earlier body, which takes its
                rows that are not 16-byte pieces; P5a runs on
                ``banded_stream.cu`` in its column-weight
                mode; ``climb.cu``: the decode's climb; ``adam.cu``: Adam's
                step; ``sddmm.cu``: the cut loss's SDDMM) with nvcc for sm_90a, one nvcc
                per source, started together, and print the card's name and
                power limit;
  2. kernels    hold K1 (``block_ell_spmm``: the microbenchmark's plan at
                F = 128, the locality trainer's at F = 64 and 3, and small
                odd plans), K2 (``banded_spmm_unit``, r = 1, F = 16 and 3;
                F = 128 at ``bench --what banded``'s two sizes),
                K3 (``banded_spmm_unit_packed``, r = 8, F = 16) and K4
                (``banded_spmm``, n = 131,072 and 1,250,304 at F = 128, and
                F = 3) against their plain PyTorch versions on the card,
                forward and gradient (K2 and K3 bit for bit, and against
                their earlier body); time each beside its bound, its plain
                version and one PyTorch library call (K2: cuDNN's circular
                depthwise convolution; K3: ``torch.sparse.mm`` on the values
                widened to float32), and beside its earlier body, timed in
                turns (K2, K3: the op and the kernel alone);
     halo       hold K5 (``halo_banded_spmm``: n = 131,072 at F = 128,
                weighted, and the plain halo trainer's 262,144-row shards at
                F = 128 and 3, unit weights) and K6
                (``halo_banded_spmm_unit_packed``: the packed halo trainer's
                10,002,432 × 16 at r = 8) against their plain versions and
                their earlier body (the halo mode of ``banded_window.cu``)
                bit for bit on rings of 1, 2 and 4 shards on the card,
                forward and gradient, float32 and bf16, and in float32 bit
                for bit against K4/K2 and K3 on the gathered array; time one
                shard's launch in turns with the earlier body, the ring op
                (less the shard launches: the exchange) and
                ``torch.sparse.mm`` of the shard's row operator (bf16 on the
                values widened to float32);
     probes     hold the design probes' kernels against their plain versions
                at the probes' sizes, bit for bit (``window_gather`` on the
                warp gather at every P1 (W, B), float32 and bf16 x, and
                P2's d = 16; ``subblock_spmm`` on P3's ring at both P3
                configurations; ``panel_ell_spmm`` on the gather at every
                P4 (W, W_P) the 5% rule keeps; ``banded_spmm_cols`` on K4's
                ring with column weights, also against its earlier body,
                and K4 on every P5 variant's weights), time each beside its
                bound, its plain version, ``torch.sparse.mm`` and, for
                P5a, in turns, its earlier body; time P1's function at
                (255, 512) in float32 on the gather and P3's ring in turns;
                time P3's ring in turns with K1's gather past the L2
                (n = 1,048,576, F = 128, x 512 MB); then run the five
                probe entry points (``gcn_maxcut_tpu_torch.experiments``)
                and check their launch counts (none on an earlier body) and
                errors;
     adam       Adam's step (``ops/adam.py``): ``csrc/adam.cu`` against the
                plain step on the card, bit for bit, at the giant's leaves
                (the 10,002,432 x 32 embedding with a bf16 first moment and
                the head's four) and at the recipe's four (1000 x 500,
                500, 500 x 3, 3; float32 first moment), three steps each,
                one update and one count launch a step; each step timed (the
                kernel's two launches, and the plain step's passes) beside
                the bytes bound of one pass and the library's fused step
                (``torch._fused_adam_``, float32 first moment);
     sddmm      the cut loss's SDDMM (``ops/segment.sddmm``): ``csrc/sddmm.cu``
                against the plain op on the card at the recipe's graphs (n =
                500, d = 6 and 8, one shared padding: n_pad 504, e_pad
                4,096), scores and gradient bit for bit, one forward and one
                backward launch; forward plus backward timed beside the
                plain op, and the plain op on the d = 6 graph stored with
                no padded slot (what the run of padded slots costs it);
  3. giant      the packed giant trainer at its defaults (n = 10,002,432,
                d = 8, bandwidth 63, bf16 aggregation and first moment, 40
                epochs) through K3 on ``halo_stream.cu``, after a small run
                held against the CPU, writing a checkpoint after epoch 20
                and at the end (in a temporary directory, deleted); a
                20-epoch run's checkpoint resumed to 40, its last 20 losses
                equal to the uninterrupted run's (bit for bit) and K3's
                launches on it counted exactly, and C2's (``adam.cu``) on
                the full run, one update and one count an epoch; each
                write's seconds and
                bytes; then the plain-layout trainer at
                n = 1,048,576 through K2 (F = 16 on ``halo_stream.cu``,
                F = 3 on the earlier body), each launch counted by the kernel
                that ran;
     halo       the node-sharded trainers on a ring of 4 shards on the card:
                a small packed run held against a CPU ring, a 1-shard ring
                against the single-chip packed trainer, then the packed halo
                trainer at its defaults (n = 10,002,432, 40 epochs) through
                K6, held to the giant phase's cut, and the plain halo trainer
                (emb 128, hidden 128, n = 1,048,576, 10 epochs) through K5:
                ``halo_stream.cu`` at F = 128 and the earlier body at F = 3,
                each launch counted by the kernel that ran;
  4. recipe     the ``pipeline`` flow: 20 graphs of n = 500, d in [6, 8],
                padded to 1000, GCNSoftmax 1000-500-3, 300 epochs, the
                dataset npz and checkpoints written; the held-out graphs
                decoded by the harness with 200 rollouts (held against the
                JAX pipeline's cut) and the default decode, the 4-start
                greedy-flip refine (held against the randomized baseline);
                then the ``test`` command on the pipeline's dataset and
                final checkpoint, the refined cut at least the
                post-processed one on every graph; C2 (``adam.cu``)
                launched once for the update and once for the count at
                every Adam step of the training (a step a graph an epoch),
                and C3 (``sddmm.cu``) once forward and once backward;
     variants   each training variant (batched steps, the cosine rate, the
                quantile loss, entropy 0.5) and the QUBO loop on the card
                against the CPU from one start, 10 epochs at n_pad 64
                (rtol 1e-4); batched steps with the cosine rate on the
                recipe's data at full width (300 epochs), its epoch ms
                beside per_graph's, the default decode on 5 held-out graphs
                against a 10k randomized baseline; the QUBO loop at the
                legacy widths (emb 80, hidden 40) on one recipe graph,
                3,000 epochs;
     quality    the quality suite (``bench --what quality``, recipe
                ``mixed``, the JAX defaults: sizes 50-500, 6 graphs a size,
                padded to 1000, 200 rollouts, 10k randomized iterations,
                refine on), gated as PARITY.md section 1 gates the JAX
                package: simple-decode mean at least the reference's 547.1,
                the default decode at least the randomized baseline at
                every size; each size printed beside the JAX package's;
                then the arms ``ent05`` (entropy 0.5, gated the same) and
                ``quant`` (the quantile loss; its simple mean logged, not
                gated, as the JAX arm's own is below 547.1) of
                ``experiments/quality_sweep.py``;
  5. locality   the locality trainer (``bench --what locality``): a small
                run held against the CPU, then n = 100,000 through K1 (RCM,
                plan, 200 epochs, decode), held against the JAX package's
                cut on the same graph (checked by its digest; the RCM
                relabeling is saved for the reference) and initial
                parameters;
     kway       BASELINE config 4 on the node-sharded trainer
                (``parallel/giant.py``): n = 4096, k = 3, 20 epochs on a
                4-shard ring on the card against a CPU ring (histories
                rtol 1e-3, assignments agree on 99.9%); ``kway_sweep`` at
                n = 100,000, d = 8, k = 3..8, 100 epochs on one shard, each
                k's margin over its (k - 1)/k floor at least half of
                PARITY.md section 5's JAX margin, and k = 3 on a 4-shard
                virtual ring above its floor (the expander's shards do not
                band: no kernel launches); the banded-random graph in 4
                contiguous shards with hop 0 on K1 (per-shard RCM): K1's
                launches counted exactly, no other kernel, the cut above
                2/3, and K1 on one shard's plan held against its plain
                version and timed; ``bench --what scaling`` at its
                defaults (D = 1) and the sharded conv on the 4-shard ring;
     hybrid     the hybrid data x graph trainer (``parallel/hybrid.py``) on
                a 2 x 4 mesh of the card: n = 4096, 2 graphs, 20 epochs
                against a 2 x 4 CPU mesh (histories and per-graph cuts rtol
                1e-3); one graph twice with equal embeddings against the
                giant trainer on a 4-shard ring (rtol 1e-5, both copies
                equal); two of the kway phase's banded-random graphs at
                full width (emb 128, hidden 64, 100 epochs, per-shard RCM,
                hop 0 on K1): a plan on every shard, K1's launches counted
                exactly, no other kernel, both cuts above 2/3, the epoch
                ms from CUDA events; K1 on a hybrid shard's plan held
                against its plain version and timed; ``bench --what
                hybrid`` on the card;
     dp         data-parallel recipe training (``parallel/data_parallel.py``)
                on 4 data entries of the card: n_pad 64 against the CPU
                (rtol 1e-4), the recipe's data (20 graphs, 1000-wide, 300
                epochs; the loss improves, the default decode on 5
                held-out graphs beats a 10k randomized baseline, the epoch
                ms beside the variants phase's), and one DP and one hybrid
                epoch through NCCL's all_reduce on a process group of one
                (``multi_host_init`` on 127.0.0.1), bit for bit against
                the same epochs without a group (the hybrid's a chunk of 3,
                its all_reduce inside the captured graph);
     chunks     ``epochs_per_call``: every chunked path at K = 1 and at the
                JAX default K = 10 from one start, and at K = 10 without
                capture (the eager epochs): the recipe (20 graphs, n = 500
                padded to 1000, per_graph; and a run that stops at epoch 5,
                inside a chunk), the packed (K3) and plain (K2) giant
                trainers, the packed (K6) and plain (K5) halo trainers on 4
                shards, the k-way trainer on config 4's banded-random graph
                on 4 shards with hop 0 on K1 and on the sweep's expander on
                one shard, the hybrid on 2 x 4 with hop 0 on K1; histories
                equal to K = 1's bit for bit (within rtol 1e-3 where K1's
                outliers sum with index_add_'s atomics), launches exactly
                so many an epoch (captured launches times replays plus the
                eager epoch's), each path's epoch ms over 10 more epochs
                (CUDA events) and the busy share of the recipe and the
                k-way ring at K = 10 and eager (``torch.profiler``); in
                those traced chunks and in a traced packed giant run at
                K = 10, each kernel's launches counted on the device equal
                to the launch counters' (captured launches times replays);
  6. solvers    the classical solvers on the card: brute force at n = 16
                (d = 3) equal on the card, the CPU and the native toolkit
                (optimum and, card against CPU, assignment), then at n = 19
                (3^16 codes, the most the exact branch takes), codes/s; the
                batched SA chains and their climb (n = 100, 8 chains, 2,000
                steps) from one set of draws, card against CPU (best cut
                within one edge); ``solve --n 500 --d 8 --time-limit 20``
                (the SA branch, at least one batch of 64 chains, above its
                randomized cut; chains/s and steps/s) and ``solve --n 15``
                (the exact branch); ``solve --method sweep --n 100000``
                (cut fraction above 2/3); ``compute_baseline_stats`` on 4
                graphs of n = 500 padded to 1000 (solver 5 s; every solver
                cut at least the randomized one); ``convert`` of the
                recipe's final checkpoint .npz -> .pth -> .npz, every array
                bit-equal (in a temporary directory); and the examples
                ``torch_migration`` (5 epochs on that .pth, its
                ``_continued.pth`` read back), ``giant_scale_pipeline`` at
                N = 20,000 on a 4-shard ring and
                ``complete_training_pipeline --quick``;
     microbench ``bench --what all`` through the CLI: spmm (K1), banded (K2,
                K4), train and post, in that order; K1, K2 and K4 launched
                exactly 36, 108 and 44 times in the whole command and no
                other kernel;
     timings    the recipe timings ``bench --what all`` printed (train,
                post) and the refined decode's time a graph at n = 500,
                each beside the card's name and power limit.

Every trainer runs its epochs in chunks (``train/chunks.py``): on the card
one captured CUDA graph replayed an epoch at a time, with the JAX defaults
of ``epochs_per_call`` (10 for the giant, halo and k-way sweep trainers,
1 elsewhere) and the JAX epoch counts (whole chunks).  Each path runs with
the launch counters set to 0 just before it and read just after.  The end
of the output is the card's name and power limit, one JSON line of kernel
numbers, and ``{"ok": true, "device": {...}}``.  Detail
goes to ``chiprun_out/chip_smoke.json``.  TF32 is off for matmuls and cuDNN:
the JAX reference computes in full float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from gcn_maxcut_tpu_torch.ops import launches as registry

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
KERNEL_SOURCE = "gcn_maxcut_tpu_torch/csrc/banded_window.cu"
HALO_SOURCE = "gcn_maxcut_tpu_torch/csrc/halo_stream.cu"
K4_SOURCE = "gcn_maxcut_tpu_torch/csrc/banded_stream.cu"
K1_SOURCE = "gcn_maxcut_tpu_torch/csrc/block_ell_gather.cu"
PROBE_SOURCE = "gcn_maxcut_tpu_torch/csrc/probe_kernels.cu"
SUBBLOCK_SOURCE = "gcn_maxcut_tpu_torch/csrc/subblock_stream.cu"
ADAM_SOURCE = "gcn_maxcut_tpu_torch/csrc/adam.cu"
SDDMM_SOURCE = "gcn_maxcut_tpu_torch/csrc/sddmm.cu"
PAST_L2_N = 1_048_576           # P3's ring against K1's gather: x is 512 MB at F = 128
PROBE_ITERS = 10                # timed calls of each probe case (plus 2 warm-up)

GIANT_N = 10_002_432
GIANT_EPOCHS = 40
# Adam's leaves: the packed giant's (conv1 w, b; conv2 w, b; the embedding,
# 1,250,304 x 256 packed = 10,002,432 x 32) and the recipe's GCNSoftmax
ADAM_CASES = {
    "giant": ([(32, 16), (16,), (16, 16), (16,), (GIANT_N // 8, 256)], "bfloat16"),
    "recipe": ([(1000, 500), (500,), (500, 3), (3,)], "float32"),
}
# the cut loss's SDDMM at the recipe's graphs (n = 500, one shared padding)
SDDMM_DEGREES = (6, 8)
GIANT_CHECKPOINT_EVERY = 20
PLAIN_N = 1_048_576
PLAIN_EPOCHS = 10
HALO_SHARDS = 4                 # the virtual ring of the halo trainers
HALO_K5_N = 131_072             # K5 at the banded microbenchmark's n
HALO_PLAIN_SHARD = 262_144      # plain halo trainer: n = 1,048,576 on 4 shards
HALO_PLAIN_EPOCHS = 10
HALO_PACKED_SHARD = GIANT_N // HALO_SHARDS
SMALL_CASES = [                 # (n, F, r, offsets): odd shapes and wrap edges
    (296, 3, 8, (1, -1, 7, -7)),
    (400, 20, 8, (2, -5, 6)),
    (1024, 16, 8, (63, -63, 1, -1)),
]
# The JAX package's pipeline at the recipe's defaults (seed 1000), decoded
# on the same held-out graphs: argmax 1205.0, post-processed 1238.6,
# randomized baseline 1253.8 (average cuts).
REFERENCE_POST_CUT = 1238.6
# PARITY.md section 1, the JAX package's default arm (mixed recipe, 4-start
# refine): per size, simple, post, refined, randomized 10k, refined-random.
REFERENCE_QUALITY = {
    50: (107.3, 116.3, 143.2, 124.5, 142.8),
    100: (241.3, 257.0, 310.8, 254.8, 307.0),
    200: (497.5, 516.0, 673.3, 536.2, 664.0),
    300: (708.7, 738.5, 990.2, 774.2, 976.0),
    500: (1229.7, 1257.0, 1687.2, 1295.3, 1657.2),
}
REFERENCE_SIMPLE_MEAN = 547.1   # the reference's own simple-decode mean
# The JAX package's arms of experiments/quality_sweep.py, per size as above:
# ent05 from docs/quality_r4_ent05_ms4.json (simple mean 561.2, refined mean
# 759.1), quant from docs/quality_r4_quant.json (simple mean 545.7).
REFERENCE_QUALITY_ENT05 = {
    50: (111.7, 122.5, 142.8, 124.5, 142.8),
    100: (229.2, 250.0, 308.3, 254.8, 307.0),
    200: (497.8, 532.2, 673.8, 536.2, 664.0),
    300: (736.0, 775.2, 990.3, 774.2, 976.0),
    500: (1231.2, 1297.8, 1680.3, 1295.3, 1657.2),
}
REFERENCE_QUALITY_QUANT = {
    50: (103.8, 118.3, 142.0, 124.5, 140.2),
    100: (240.3, 257.2, 305.8, 254.8, 305.5),
    200: (479.3, 517.2, 669.3, 536.2, 661.3),
    300: (700.7, 738.8, 981.5, 774.2, 970.3),
    500: (1204.3, 1248.2, 1678.8, 1295.3, 1652.0),
}
# arm: (train_kwargs, the JAX per-size numbers, the JAX simple mean, whether
# the simple mean is gated); the quantile arm's own JAX mean is below 547.1
# (PARITY.md section 1), so its simple mean is logged, not gated
QUALITY_ARMS = {
    "default": ({}, REFERENCE_QUALITY, 556.9, True),
    "ent05": ({"entropy_weight": 0.5}, REFERENCE_QUALITY_ENT05, 561.2, True),
    "quant": ({"loss_mode": "quantile"}, REFERENCE_QUALITY_QUANT, 545.7, False),
}
# the variants phase: each variant card against CPU at n_pad 64; the recipe's
# epochs; the per_graph epochs timed beside the batched run; the QUBO loop's
# epochs (its default is 100,000 with patience 100)
VARIANT_CHECKS = {
    "batched": dict(step_mode="batched"),
    "cosine": dict(lr_schedule="cosine", learning_rate=2e-2),
    "quantile": dict(loss_mode="quantile"),
    "entropy 0.5": dict(entropy_weight=0.5),
}
RECIPE_EPOCHS = 300
VARIANT_PER_GRAPH_EPOCHS = 30
QUBO_EPOCHS = 3000
# The JAX package's train_model on the locality trainer's graph from the same
# initial parameters (tools/locality_reference.py at its defaults on the CPU,
# with --perm the RCM relabeling this script saves on the card's machine,
# SciPy 1.18.1: bandwidth 331, 119 outliers): 200 epochs, decoded argmax cut
# 390,629 of 400,000 edges, on the graph of this digest.
REFERENCE_LOCALITY_CUT = 390_629.0
REFERENCE_LOCALITY_GRAPH = "cf6f0c38cf606dbc"
LOCALITY_N = 100_000
# BASELINE config 4: the k-way sweep on one 100,000-node 8-regular graph, 100
# epochs a k, as PARITY.md section 5 ran it.  Its JAX cut fractions and
# margins over the (k - 1)/k floor, in points; the gate is half of each
# margin, rounded down to 0.1.
KWAY_N, KWAY_D, KWAY_EPOCHS, KWAY_SHARDS = 100_000, 8, 100, 4
REFERENCE_KWAY = {3: (82.8, 16.1), 4: (85.7, 10.7), 5: (91.1, 11.1), 6: (92.1, 8.8),
                  7: (94.4, 8.7), 8: (95.8, 8.3)}
KWAY_GATE = {3: 8.0, 4: 5.3, 5: 5.5, 6: 4.4, 7: 4.3, 8: 4.1}
# the hybrid phase: a 2 x 4 mesh of one card; the small runs' graphs; the
# duplicated graph's epochs; the full-width run on two of the kway phase's
# banded-random graphs (emb 128, hidden 64).  The dp phase: a data mesh of 4
# entries of one card on the recipe's data.
HYBRID_SHAPE = (2, 4)
HYBRID_SMALL_N = 4096
HYBRID_DUP_EPOCHS = 10
HYBRID_EPOCHS = 100
DP_ENTRIES = 4
MICRO_N = 100_000
SOLVER_BRUTE = (16, 3)          # n, d: 3^13 codes, card against CPU and native
SOLVER_BRUTE_MAX = (19, 4)      # 3^16 codes, the most the exact branch takes
SOLVER_SA = (100, 6, 8, 2000)   # n, d, chains, steps: the SA chains, card against CPU
SOLVE_ANYTIME = ["solve", "--method", "anytime", "--n", "500", "--d", "8", "--time-limit", "20",
                 "--device", "cuda"]
SOLVE_SWEEP = ["solve", "--method", "sweep", "--n", "100000", "--d", "8", "--device", "cuda"]
SA_STEPS = 20_000               # anytime_solver's sa_steps
EXAMPLE_GIANT_N = 20_000        # giant_scale_pipeline's own N
# the chunks phase: every chunked path at K = 1 and at the JAX default
# K = 10 from one start (and at K = 10 without capture, the eager epochs of
# the trainers before chunks), CHUNK_EPOCHS compared, CHUNK_TIMED more timed
CHUNK_K = 10
CHUNK_EPOCHS = 20
CHUNK_TIMED = 10
CHUNK_STOP_PATIENCE = 5         # the recipe's stopping run stops at epoch 5, inside a chunk
SOLVER_SA_LOCKSTEP = (500, 8, 64, 2000)  # n, d, chains, steps: solve --n 500's chains alone
BANDED_N, BANDED_BIG_N = 131_072, 1_250_304


def log(*args) -> None:
    print(*args, flush=True)


def launches_but_adam() -> dict:
    """The launch registry's counts less Adam's kernel, which every
    trainer's step launches (the adam, giant and recipe phases count it)."""
    return {k: v for k, v in registry.LAUNCHES.items() if not k.startswith("adam_")}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def launches_but_sddmm(launches: dict, what: str) -> dict:
    """``launches`` less the cut loss's SDDMM (``csrc/sddmm.cu``), after
    checking that ``what`` launched it, one backward for each forward:
    every training step of the recipe's loss does."""
    check(launches["sddmm"] == launches["sddmm_backward"] > 0,
          f"{what}: the cut loss launched sddmm.cu, one backward for each forward")
    return {k: v for k, v in launches.items() if k not in ("sddmm", "sddmm_backward")}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


SLEEP_CYCLES = 10_000_000      # ~5 ms of device clock queued ahead of the timed calls


def best_ms(torch, fn, reps: int = 15, warmup: int = 3) -> float:
    """Best of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls:
    device time.  The timed calls are queued behind a device-side sleep, so
    the device never waits on the host's launch overhead between them."""
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return min(s.elapsed_time(e) for s, e in pairs)


def ms_in_turns(torch, fns: dict, rounds: int = 2) -> dict:
    """Best-of-15 times of several functions of one input, taken in turns
    (each once a round, in order), the best round kept for each."""
    best = {name: math.inf for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            best[name] = min(best[name], best_ms(torch, fn))
    return best


def bound(n: int, F: int, d: int, elsize: int) -> tuple[float, str]:
    """Least time (ms) for one call: read x once and write y once, against
    n·F·d float32 adds."""
    bytes_ms = 2 * n * F * elsize / HBM_BYTES_PER_S * 1e3
    ops_ms = n * F * d / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def max_err_within_tolerance(torch, got, ref) -> float:
    """float32: rtol = atol = 1e-5.  bfloat16: within one bf16 ulp of the
    plain version, which sums in float32 and rounds once."""
    diff = (got.float() - ref.float()).abs()
    if ref.dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    else:
        ref32 = ref.float()
        _, exp = torch.frexp(ref32)
        ulp = torch.where(ref32 == 0, torch.full_like(ref32, 2.0**-133),
                          torch.ldexp(torch.ones_like(ref32), exp - 8))
        check(bool((diff <= ulp).all()), "bf16 kernel within one ulp of its plain version")
    return float(diff.max())


def phase_build(build) -> dict:
    log("== build")
    t0 = time.perf_counter()
    logs = build.build_all()
    seconds = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")
            check(" 0 bytes spill stores" in line or "spill stores" not in line,
                  f"{name}.cu builds without register spills: {line.strip()}")
    log(f"  built {sorted(logs)} in {seconds:.2f} s")
    card = card_line()
    log(f"  card: {card}")
    return {"seconds": seconds, "card": card}


def circulant_op(name: str) -> str:
    """The launch registry's key of K2 or K3."""
    return "banded_spmm_unit" if name == "K2" else "banded_spmm_unit_packed"


def phase_kernels(torch, tb, hs, offsets: tuple[int, ...], bench_offsets: tuple[int, ...]) -> dict:
    """K2 and K3 against their plain versions and their earlier body
    (``banded_window.cu``, called directly), forward and gradient, bit for
    bit; then timings, the op (wrap tiles + kernel) and the kernel alone in
    turns with the earlier body.  ``offsets`` are the giant trainers',
    ``bench_offsets`` those of ``bench --what banded``, which runs K2 at
    F = 128.  Rows whose arrays are not whole 16-byte pieces run the
    earlier body itself ("K2 window")."""
    log("== kernels")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ops = {
        "K2": (lambda x, o, r: tb.banded_spmm_unit(x, o),
               lambda x, o, r: tb.banded_spmm_unit_plain(x, o)),
        "K3": (lambda x, o, r: tb.banded_spmm_unit_packed(x, o, r),
               lambda x, o, r: tb.banded_spmm_unit_packed_plain(x, o, r)),
    }
    cases = [("K2", GIANT_N, 16, 1, offsets), ("K2", GIANT_N, 3, 1, offsets),
             ("K2", PLAIN_N, 16, 1, offsets), ("K2", PLAIN_N, 3, 1, offsets),
             ("K3", GIANT_N, 16, 8, offsets),
             ("K2", BANDED_N, 128, 1, bench_offsets), ("K2", BANDED_BIG_N, 128, 1, bench_offsets)]
    cases += [(k, n, F, 1 if k == "K2" else r, o) for (n, F, r, o) in SMALL_CASES
              for k in ("K2", "K3")]
    errors = {"K2": 0.0, "K2 window": 0.0, "K3": 0.0}
    for name, n, F, r, offs in cases:
        kernel, plain = ops[name]
        op = circulant_op(name)
        neg = tuple(-o for o in offs)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(n, F, generator=gen, device=dev).to(dtype)
            dy = torch.randn(n, F, generator=gen, device=dev).to(dtype)
            xk = x.clone().requires_grad_(True)
            yk = kernel(xk, offs, r)
            yk.backward(dy)
            xp = x.clone().requires_grad_(True)
            yp = plain(xp, offs, r)
            yp.backward(dy)
            torch.cuda.synchronize()
            y, g = yk.detach(), xk.grad
            err = max(max_err_within_tolerance(torch, y, yp.detach()),
                      max_err_within_tolerance(torch, g, xp.grad))
            # the plain version, the earlier body and the new kernel all sum in
            # float32 in offset order from zero and round once: equal bit
            # for bit; the gradient is the same op with negated offsets
            m, L = n // r, r * F
            check(torch.equal(y, plain(x, offs, r)), f"{name} equals its plain version")
            check(torch.equal(g, plain(dy, neg, r)), f"{name}'s gradient equals the plain adjoint")
            check(torch.equal(y, tb._launch(x.view(m, L), offs, F, op=op).view(n, F)),
                  f"{name} equals its earlier body")
            check(torch.equal(g, tb._launch(dy.view(m, L), neg, F, op=op).view(n, F)),
                  f"{name}'s gradient equals its earlier body")
            key = name if hs._vec16(L, x.element_size(), x) else f"{name} window"
            errors[key] = max(errors[key], err)
            log(f"  {key} n={n} F={F} r={r} {str(dtype)[6:]}: fwd+grad max |err| {err:.3g}, "
                "equal to the plain version and the earlier body")
            del x, dy, xk, yk, xp, yp, y, g

    def circular_conv(F: int, dtype, offs):
        # one cuDNN call for K2's function: a depthwise circular convolution
        # whose taps are the offsets (cross-correlation: tap o + W reads x[i + o])
        wp = tb.padded_bandwidth(offs)
        conv = torch.nn.Conv1d(F, F, 2 * wp + 1, padding=wp, padding_mode="circular",
                               groups=F, bias=False).to(dev, dtype)
        with torch.no_grad():
            conv.weight.zero_()
            for o in offs:
                conv.weight[:, 0, o + wp] += 1
        return conv

    packed = None                 # K3's operator in packed order, built once
    timings = []
    with torch.no_grad():
        for name, n, F, r, dtype, offs in [
            ("K2", GIANT_N, 16, 1, torch.float32, offsets),
            ("K2", GIANT_N, 3, 1, torch.float32, offsets),
            ("K2", GIANT_N, 16, 1, torch.bfloat16, offsets),
            ("K2", PLAIN_N, 16, 1, torch.float32, offsets),
            ("K2", PLAIN_N, 3, 1, torch.float32, offsets),
            ("K2", BANDED_N, 128, 1, torch.float32, bench_offsets),
            ("K2", BANDED_BIG_N, 128, 1, torch.float32, bench_offsets),
            ("K3", GIANT_N, 16, 8, torch.bfloat16, offsets),
            ("K3", GIANT_N, 16, 8, torch.float32, offsets),
        ]:
            kernel, plain = ops[name]
            op = circulant_op(name)
            x = torch.randn(n, F, generator=gen, device=dev).to(dtype)
            m, L, el = n // r, r * F, x.element_size()
            v, wp = x.view(m, L), tb.padded_bandwidth(offs)
            stream = hs._vec16(L, el, v)
            row = {"name": name if stream else f"{name} window", "n": n, "F": F, "r": r,
                   "dtype": str(dtype)[6:],
                   "source": HALO_SOURCE if stream else KERNEL_SOURCE}
            # the op (wrap tiles + kernel), the earlier body and the kernel alone
            # on tiles staged once, in turns; a window row's op is the earlier
            # body itself, so it has no second time
            fns = {"ms": lambda: kernel(x, offs, r)}
            row["earlier_ms"] = None
            if stream:
                fns["earlier_ms"] = lambda: tb._launch(v, offs, F, op=op)
                pre, post = tb.wrap_tiles(v, wp, F)
                fns["kernel_only_ms"] = lambda: hs.launch(v, pre, post, offs)
                row["geometry"] = dataclasses.asdict(hs.halo_stream_shape(m, L, wp, 0, el))
            row.update(ms_in_turns(torch, fns))
            row["plain_ms"] = best_ms(torch, lambda: plain(x, offs, r))
            row["library_ms"] = row["library_max_abs_err"] = None
            if name == "K2":
                conv = circular_conv(F, dtype, offs)
                xt = x.t().unsqueeze(0)
                lib = conv(xt)[0].t()
                row["library_max_abs_err"] = float(
                    (lib.float() - plain(x, offs, r).float()).abs().max())
                row["library_ms"] = best_ms(torch, lambda: conv(xt))
                del conv, xt, lib
            else:
                packed = packed if packed is not None else packed_csr(torch, n, r, offs)
                xf = x.float()
                row["library_max_abs_err"] = float(
                    (torch.sparse.mm(packed, xf) - plain(x, offs, r).float()).abs().max())
                row["library_ms"] = best_ms(torch, lambda: torch.sparse.mm(packed, xf))
                del xf
            row["bound_ms"], row["bound_by"] = bound(n, F, len(offs), el)
            timings.append(row)
            log(f"  {row['name']} n={n} F={F} r={r} {row['dtype']} ({Path(row['source']).name}): op "
                f"{row['ms']:.4f} ms, kernel alone {row.get('kernel_only_ms', row['ms']):.4f}, "
                f"earlier body {row['earlier_ms']}, plain {row['plain_ms']:.4f} ms, library "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']})")
            del x, v
            if stream:
                del pre, post
    del packed
    torch.cuda.empty_cache()
    return {"max_abs_err": errors, "timings": timings}


def packed_csr(torch, n: int, r: int, offsets):
    """K3's function as one float32 CSR matrix [n, n]: the circulant
    operator in node order, permuted into the packed order (node i at
    position (i mod m)·r + i // m, m = n / r)."""
    dev = torch.device("cuda")
    m = n // r
    node = torch.arange(n, device=dev)

    def pos(v):
        return (v % m) * r + v // m

    rows = pos(node).repeat_interleave(len(offsets))
    cols = pos((node[:, None] + torch.tensor(offsets, device=dev)) % n).reshape(-1)
    return csr_of(torch, rows, cols, torch.ones(rows.numel(), device=dev), n)


def bell_operands(g, mode: str = "mask") -> tuple:
    """(sidx, w, out_s, out_r, out_w) of a graph's block-ELL plan."""
    w = g.bell_mask if mode == "mask" else g.bell_weights
    ow = g.bell_out_mask if mode == "mask" else g.bell_out_weights
    return g.bell_senders, w, g.bell_out_senders, g.bell_out_receivers, ow


def small_block_ell_graphs(np, tgraph) -> dict:
    """Odd plans, each with edges across the wrap at both ends."""
    rng = np.random.default_rng(7)

    def banded(n, per_node, w, long_edges=()):
        i = np.repeat(np.arange(n), per_node)
        j = (i + rng.integers(-w, w + 1, size=i.size)) % n
        keep = i != j
        extra = np.asarray(long_edges, dtype=np.int64).reshape(-1, 2)
        return np.concatenate([np.stack([i[keep], j[keep]], axis=1), extra])

    ring = np.stack([np.arange(2048), (np.arange(2048) + 1) % 2048], axis=1)
    adj = np.zeros((2048, 2048), np.float32)
    e = banded(2048, 3, 40, [(3, 1500), (700, 10)])
    adj[e[:, 0], e[:, 1]] = rng.random(e.shape[0]) + 0.5
    graphs = {
        "B=240, R0=B": tgraph.graph_from_edges(banded(1200, 2, 20, [(1, 600)]), 1200,
                                               block_ell=True),
        "width 1, directed ring (transpose plan)": tgraph.graph_from_edges(
            ring, 2048, symmetrize=False, block_ell=True),
        "width 1 forced, outliers + padding": tgraph.attach_block_ell(
            tgraph.graph_from_edges(banded(4096, 3, 60, [(0, 2000)]), 4096, block_ell=False),
            force_wp=64, force_width=1),
        "asymmetric weighted (transpose plan)": tgraph.graph_from_dense(adj, block_ell=True),
    }
    for name, g in graphs.items():
        check(g.bell_block is not None, f"small plan {name!r} exists")
    return graphs


def check_block_ell(torch, tbell, seg, g, F: int, gen, mode: str = "mask") -> float:
    """K1 through ``spmm`` (kernel forward and backward) against autograd
    through the plain version on the card; returns the max |error|."""
    dev = torch.device("cuda")
    gc = g.to(dev)
    n = g.n_pad
    x = torch.randn(n, F, generator=gen, device=dev)
    dy = torch.randn(n, F, generator=gen, device=dev)
    xk = x.clone().requires_grad_(True)
    yk = seg.spmm(gc, xk, None if mode == "mask" else gc.weights)
    yk.backward(dy)
    xp = x.clone().requires_grad_(True)
    yp = tbell.block_ell_spmm_plain(xp, *bell_operands(gc, mode), n, gc.bell_block, gc.bell_wp)
    yp.backward(dy)
    torch.cuda.synchronize()
    return max(max_err_within_tolerance(torch, yk.detach(), yp.detach()),
               max_err_within_tolerance(torch, xk.grad, xp.grad))


def csr_rect(torch, rows, cols, vals, shape):
    """float32 CSR matrix of ``shape`` with entries (rows, cols) = vals."""
    coo = torch.sparse_coo_tensor(torch.stack([rows.long(), cols.long()]), vals, shape)
    return coo.coalesce().to_sparse_csr()


def csr_of(torch, rows, cols, vals, n: int):
    """float32 CSR matrix [n, n] with entries (rows, cols) = vals."""
    return csr_rect(torch, rows, cols, vals, (n, n))


def time_block_ell(torch, tbell, g, F: int, gen, label: str) -> dict:
    dev = torch.device("cuda")
    gc = g.to(dev)
    n, B, wp = gc.n_pad, gc.bell_block, gc.bell_wp
    ops = bell_operands(gc)
    width, o_pad = ops[0].shape[1], ops[2].shape[0]
    x = torch.randn(n, F, generator=gen, device=dev)
    row = {"name": "K1", "case": label, "n": n, "F": F, "block": B, "wp": wp,
           "width": width, "o_pad": o_pad, "n_outliers": int(ops[4].sum()), "dtype": "float32"}
    row["vec"], row["blocks"] = tbell.gather_shape(n, F)
    with torch.no_grad():
        real = gc.edge_mask > 0
        csr = csr_of(torch, gc.receivers[real], gc.senders[real], gc.edge_mask[real], n)
        lib = torch.sparse.mm(csr, x)
        row["library_max_abs_err"] = float(
            (lib - tbell.block_ell_spmm_plain(x, *ops, n, B, wp)).abs().max())
        # the op (kernel + outlier index_add_), its plain version and
        # sparse.mm in turns, then the kernel alone
        row.update(ms_in_turns(torch, {
            "ms": lambda: tbell.block_ell_spmm(x, *ops, n, B, wp),
            "plain_ms": lambda: tbell.block_ell_spmm_plain(x, *ops, n, B, wp),
            "library_ms": lambda: torch.sparse.mm(csr, x),
        }))
        row["kernel_only_ms"] = best_ms(torch, lambda: tbell._launch(x, ops[0], ops[1], n, B, wp))
    bytes_ms = (2 * n * F * 4 + n * width * 8 + o_pad * (2 * F * 4 + 12)) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n * width * F / F32_OPS_PER_S * 1e3
    row["bound_ms"] = max(bytes_ms, ops_ms)
    row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    row["kernel_bound_ms"] = (2 * n * F * 4 + n * width * 8) / HBM_BYTES_PER_S * 1e3
    log(f"  K1 {label} n={n} F={F} B={B} Wp={wp} width={width} o_pad={o_pad} (vec "
        f"{row['vec']}): op {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, sparse.mm "
        f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} ({row['bound_by']}); kernel alone "
        f"{row['kernel_only_ms']:.4f}, kernel bound {row['kernel_bound_ms']:.4f}")
    return row


def phase_kernels_block_ell(torch, np, tbell, seg, tgraph, micro, loc) -> dict:
    log("== kernels: K1 block_ell_spmm")
    gen = torch.Generator(device="cuda").manual_seed(1)
    t0 = time.perf_counter()
    g_micro = micro._banded_regular_graph(MICRO_N, 8, 255, n_pad=tgraph.round_up(MICRO_N, 2048))
    g_loc, bandwidth = loc.locality_graph(loc.locality_spec(LOCALITY_N))
    log(f"  plans built in {time.perf_counter() - t0:.2f} s: microbench B={g_micro.bell_block} "
        f"Wp={g_micro.bell_wp}; locality (RCM bandwidth {bandwidth}) B={g_loc.bell_block} "
        f"Wp={g_loc.bell_wp} outliers {int(g_loc.bell_out_mask.sum())}")
    cases = [("microbench", g_micro, 128, "mask"), ("locality", g_loc, 64, "mask"),
             ("locality", g_loc, 3, "mask"), ("microbench", g_micro, 3, "weights")]
    cases += [(name, g, F, mode) for name, g in small_block_ell_graphs(np, tgraph).items()
              for F, mode in ((16, "mask"), (3, "weights"))]
    err = 0.0
    for name, g, F, mode in cases:
        e = check_block_ell(torch, tbell, seg, g, F, gen, mode)
        err = max(err, e)
        log(f"  K1 {name} n={g.n_pad} F={F} {mode} B={g.bell_block} Wp={g.bell_wp} "
            f"width={g.bell_senders.shape[1]} symmetric={g.symmetric}: fwd+grad max |err| {e:.3g}")
    timings = [time_block_ell(torch, tbell, g_loc, 64, gen, "locality"),
               time_block_ell(torch, tbell, g_loc, 3, gen, "locality"),
               time_block_ell(torch, tbell, g_micro, 128, gen, "microbench")]
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "timings": timings}


def phase_kernels_weighted(torch, tb, offsets) -> dict:
    log("== kernels: K4 banded_spmm")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    d = len(offsets)
    err = 0.0
    timings = []
    for n, F in ((BANDED_N, 128), (BANDED_BIG_N, 128), (BANDED_N, 3), (296, 20)):
        x = torch.randn(n, F, generator=gen, device=dev)
        w = torch.rand(n, d, generator=gen, device=dev) + 0.5
        dy = torch.randn(n, F, generator=gen, device=dev)
        xk, wk = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        yk = tb.banded_spmm(xk, wk, offsets)
        yk.backward(dy)
        yk = yk.detach()
        xp, wq = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        yp = tb.banded_spmm_plain(xp, wq, offsets)
        yp.backward(dy)
        torch.cuda.synchronize()
        e = max(max_err_within_tolerance(torch, yk, yp.detach()),
                max_err_within_tolerance(torch, xk.grad, xp.grad),
                max_err_within_tolerance(torch, wk.grad, wq.grad))
        err = max(err, e)
        log(f"  K4 n={n} F={F} D={d}: fwd+grad (dx, dw) max |err| {e:.3g}")
        del xk, wk, xp, wq, yp, dy
        if n < BANDED_N:
            continue
        # rows of whole 16-byte pieces on the ring, else (F = 3) the earlier body
        geom = tb.stream_shape(n, F, tb.padded_bandwidth(offsets), d) if F % 4 == 0 else None
        row = {"name": "K4", "n": n, "F": F, "D": d, "dtype": "float32",
               "geometry": None if geom is None else dataclasses.asdict(geom),
               "source": K4_SOURCE if geom else KERNEL_SOURCE}
        with torch.no_grad():
            rows = torch.arange(n, device=dev).repeat_interleave(d)
            cols = (rows.view(n, d) + torch.tensor(offsets, device=dev)) % n
            csr = csr_of(torch, rows, cols.reshape(-1), w.reshape(-1), n)
            row["library_max_abs_err"] = float((torch.sparse.mm(csr, x) - yk).abs().max())
            # the kernel, its earlier body (banded_window.cu), the plain
            # version and sparse.mm in turns; at F = 3 the kernel is the
            # earlier body itself, so it has no second time
            fns = {"ms": lambda: tb.banded_spmm(x, w, offsets),
                   "plain_ms": lambda: tb.banded_spmm_plain(x, w, offsets),
                   "library_ms": lambda: torch.sparse.mm(csr, x)}
            row["earlier_ms"] = None
            if geom is not None:
                fns["earlier_ms"] = lambda: tb._launch(x, offsets, F, w, op="banded_spmm")
            row.update(ms_in_turns(torch, fns))
            check(torch.equal(tb._launch(x, offsets, F, w, op="banded_spmm"), yk),
                  "K4's earlier body equals the kernel bit for bit")
            del csr, rows, cols
        bytes_ms = (2 * n * F * 4 + n * d * 4) / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * n * d * F / F32_OPS_PER_S * 1e3
        row["bound_ms"] = max(bytes_ms, ops_ms)
        row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        timings.append(row)
        shape = ("the earlier body: no 16-byte rows" if geom is None else
                 f"strip {geom.strip}, {geom.cols} columns, chunk {geom.chunk}, "
                 f"{geom.smem_bytes} B shared")
        log(f"  K4 n={n} F={F} ({shape}): kernel {row['ms']:.4f} ms, earlier body "
            f"{row['earlier_ms']}, plain {row['plain_ms']:.4f}, sparse.mm {row['library_ms']:.4f}, "
            f"bound {row['bound_ms']:.4f} ({row['bound_by']})")
        del x, w, yk
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "timings": timings}


def halo_bound(n_shard: int, L: int, d: int, wp: int, elsize: int,
               weighted: bool) -> tuple[float, str]:
    """Least time (ms) for one shard's launch: read the shard and its two
    Wp-row tiles once (and the [n_shard, d] float32 weights), write the
    shard once, against n_shard·L·d adds (2·n_shard·L·d operations
    weighted)."""
    nbytes = 2 * n_shard * L * elsize + 2 * wp * L * elsize + (n_shard * d * 4 if weighted else 0)
    ops = n_shard * L * d * (2 if weighted else 1)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def halo_op(r) -> str:
    """The launch registry's key of K5 (``r`` None) or K6."""
    return "halo_banded_spmm" if r is None else "halo_banded_spmm_unit_packed"


def window_ring(torch, th, xs, offsets, mesh, r=None, ws=None):
    """A ring op on the earlier body (``th._window_launch``, the halo mode
    of ``banded_window.cu``): the exchange, then one launch per shard."""
    n_loc, F = xs[0].shape
    views = [x if r is None else x.view(n_loc // r, r * F) for x in xs]
    tiles = th.halo_exchange(views, th.padded_bandwidth(offsets), mesh, None if r is None else F)
    return torch.cat([
        th._window_launch(v, pre, post, offsets, None if ws is None else ws[c],
                          op=halo_op(r)).view(n_loc, F)
        for c, ((pre, post), v) in enumerate(zip(tiles, views))])


def check_ring(torch, th, tb, mesh, name, x, offsets, gen, w=None, r=None) -> float:
    """A ring op against its plain version (forward, and the gradient of the
    unit op) and its earlier body, bit for bit, and, for the same rows,
    against the circulant kernel on the gathered array: bit for bit in
    float32, within one ulp in bfloat16."""
    D = mesh.size
    shard = x.shape[0] // D
    xs = list(x.split(shard))
    dys = list(torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype).split(shard))
    if r is None:
        op = lambda t: th.halo_banded_spmm_unit(t, offsets, mesh)  # noqa: E731
        circulant = tb.banded_spmm_unit(x, offsets)
    else:
        op = lambda t: th.halo_banded_spmm_unit_packed(t, offsets, r, mesh)  # noqa: E731
        circulant = tb.banded_spmm_unit_packed(x, offsets, r)
    xk = [t.clone().requires_grad_(True) for t in xs]
    yk = op(xk)
    torch.autograd.backward(yk, dys)
    # The plain version and its gradient in float32, rounded once.  In
    # bfloat16 the gradient is the plain version of the adjoint (negated
    # offsets), which sums in the kernel's order: autograd sums the shifted
    # cotangents in another order, and after cancellation the float32
    # results round to bfloat16 values more than one ulp apart.
    xp = [t.detach().float().requires_grad_(True) for t in xs]
    yp = th.halo_ring_plain(xp, offsets, mesh, r=r)
    torch.autograd.backward(yp, [d.float() for d in dys])
    gp = torch.cat([t.grad for t in xp])
    if x.dtype != torch.float32:
        gp = torch.cat(th.halo_ring_plain([d.float() for d in dys], [-o for o in offsets],
                                          mesh, r=r)).to(x.dtype)
    torch.cuda.synchronize()
    y, g = torch.cat(yk).detach(), torch.cat([t.grad for t in xk])
    err = max(max_err_within_tolerance(torch, y, torch.cat(yp).detach().to(x.dtype)),
              max_err_within_tolerance(torch, g, gp))
    # the plain version and the earlier body sum in float32 in offset order
    # and round once, as the kernel does: equal bit for bit in both dtypes;
    # the gradient is the plain version of the adjoint (negated offsets)
    neg = [-o for o in offsets]
    check(torch.equal(y, torch.cat(th.halo_ring_plain(xs, offsets, mesh, r=r))),
          f"{name} on {D} shards equals its plain version bit for bit")
    check(torch.equal(g, torch.cat(th.halo_ring_plain(dys, neg, mesh, r=r))),
          f"{name}'s gradient on {D} shards equals the plain adjoint bit for bit")
    check(torch.equal(y, window_ring(torch, th, xs, offsets, mesh, r)),
          f"{name} on {D} shards equals its earlier body bit for bit")
    check(torch.equal(g, window_ring(torch, th, dys, neg, mesh, r)),
          f"{name}'s gradient on {D} shards equals its earlier body bit for bit")
    exact = {"y": bool(torch.equal(y, circulant))}
    if x.dtype == torch.float32:
        check(exact["y"], f"{name} on {D} shards equals the circulant kernel bit for bit")
    else:
        max_err_within_tolerance(torch, y, circulant)
    if w is not None:
        ws = list(w.split(shard))
        yw = torch.cat(th.halo_banded_spmm(xs, ws, offsets, mesh))
        err = max(err, max_err_within_tolerance(
            torch, yw, torch.cat(th.halo_ring_plain(xs, offsets, mesh, ws=ws))))
        check(torch.equal(yw, torch.cat(th.halo_ring_plain(xs, offsets, mesh, ws=ws))),
              f"weighted {name} on {D} shards equals its plain version bit for bit")
        check(torch.equal(yw, window_ring(torch, th, xs, offsets, mesh, ws=ws)),
              f"weighted {name} on {D} shards equals its earlier body bit for bit")
        if x.dtype == torch.float32:
            exact["weighted"] = bool(torch.equal(yw, tb.banded_spmm(x, w, offsets)))
            check(exact["weighted"], f"weighted {name} on {D} shards equals K4 bit for bit")
    return err


def time_ring(torch, th, mesh, name, x, offsets, w=None, r=None) -> dict:
    """One shard's launch (shard 0, its tiles staged) in turns with the
    earlier body's, the whole ring op (less the D shard launches: the
    exchange), one shard's plain version, and ``torch.sparse.mm`` of the
    shard's CSR operator [n_shard, n_shard + 2·Wp] on cat([pre, x, post])
    (float32: the concat counted)."""
    D, d = mesh.size, len(offsets)
    wp = th.padded_bandwidth(offsets)
    shard = x.shape[0] // D
    xs = list(x.split(shard))
    ws = None if w is None else list(w.split(shard))
    F = x.shape[1]
    views = xs if r is None else [t.view(shard // r, r * F) for t in xs]
    pre, post = th.halo_exchange(views, wp, mesh, None if r is None else F)[0]
    v0, w0 = views[0], None if ws is None else ws[0]
    m, L = v0.shape
    row = {"name": name, "shards": D, "n_shard": shard, "F": F, "r": r or 1, "L": L,
           "wp": wp, "weighted": w is not None, "dtype": str(x.dtype)[6:]}
    op = halo_op(r)
    with torch.no_grad():
        check(torch.equal(th._launch(v0, pre, post, offsets, w0, op=op),
                          th._window_launch(v0, pre, post, offsets, w0, op=op)),
              f"{name} shard launch equals its earlier body bit for bit")
        # a shard without 16-byte rows runs the earlier body itself: one time
        row["vec16"] = th._vec16(L, x.element_size(), v0, pre, post)
        fns = {"ms": lambda: th._launch(v0, pre, post, offsets, w0, op=op)}
        row["earlier_ms"] = None
        if row["vec16"]:
            fns["earlier_ms"] = lambda: th._window_launch(v0, pre, post, offsets, w0, op=op)
        row.update(ms_in_turns(torch, fns))
        if w is not None:
            ring_op = lambda: th.halo_banded_spmm(xs, ws, offsets, mesh)  # noqa: E731
        elif r is None:
            ring_op = lambda: th.halo_banded_spmm_unit(xs, offsets, mesh)  # noqa: E731
        else:
            ring_op = lambda: th.halo_banded_spmm_unit_packed(xs, offsets, r, mesh)  # noqa: E731
        row["op_ms"] = best_ms(torch, ring_op)
        row["exchange_ms"] = row["op_ms"] - D * row["ms"]
        row["plain_ms"] = best_ms(
            torch, lambda: th.halo_banded_spmm_plain(v0, w0, pre, post, offsets))
        # the shard's row operator [m, m + 2·Wp] (in the [·, L] view for
        # K6, whose sender has already rotated the wrap tile); float32 x
        # with the concat counted, bf16 x on the values widened to float32
        rows = torch.arange(m, device=x.device).repeat_interleave(d)
        cols = rows.view(m, d) + wp + torch.tensor(offsets, device=x.device)
        vals = torch.ones(m * d, device=x.device) if w0 is None else w0.reshape(-1)
        csr = csr_rect(torch, rows, cols.reshape(-1), vals, (m, m + 2 * wp))
        if x.dtype == torch.float32:
            lib = lambda: torch.sparse.mm(csr, torch.cat([pre, v0, post]))  # noqa: E731
        else:
            win = torch.cat([pre, v0, post]).float()
            lib = lambda: torch.sparse.mm(csr, win)  # noqa: E731
        row["library_max_abs_err"] = float(
            (lib() - th._launch(v0, pre, post, offsets, w0, op=op).float()).abs().max())
        row["library_ms"] = best_ms(torch, lib)
        del csr, rows, cols, vals, lib
    row["bound_ms"], row["bound_by"] = halo_bound(m, L, d, wp, x.element_size(), w is not None)
    log(f"  {name} {D} shards of [{m}, {L}] {row['dtype']}{' weighted' if w is not None else ''}"
        f" ({'halo_stream.cu' if row['vec16'] else 'earlier body: no 16-byte path'}):"
        f" shard launch {row['ms']:.4f} ms, earlier body {row['earlier_ms']}, ring op "
        f"{row['op_ms']:.4f} ms (exchange {row['exchange_ms']:.4f}), plain "
        f"{row['plain_ms']:.4f} ms, library {row['library_ms']} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def phase_kernels_halo(torch, th, tb, make_mesh, offsets, bench_offsets) -> dict:
    """K5 and K6 on rings of 1, 2 and 4 shards on the card; errors under
    the kernel that ran ("K5 window": shards without 16-byte rows, on the
    earlier body)."""
    log("== kernels: K5 halo_banded_spmm, K6 halo_banded_spmm_unit_packed")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    errors = {"K5": 0.0, "K5 window": 0.0, "K6": 0.0}
    for D in (1, 2, 4):
        mesh = make_mesh(devices=["cuda:0"] * D)
        cases = [("K5", HALO_K5_N, 128, bench_offsets, True, None),
                 ("K5", HALO_PLAIN_SHARD * D, 128, offsets, False, None),
                 ("K5", HALO_PLAIN_SHARD * D, 3, offsets, False, None),
                 ("K6", GIANT_N, 16, offsets, False, 8)]
        for name, n, F, offs, weighted, r in cases:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(n, F, generator=gen, device=dev).to(dtype)
                w = (torch.rand(n, len(offs), generator=gen, device=dev) + 0.5
                     if weighted else None)
                err = check_ring(torch, th, tb, mesh, name, x, offs, gen, w=w, r=r)
                vec16 = th._vec16(F * (r or 1), x.element_size(), *x.split(n // D))
                key = name if vec16 else f"{name} window"
                errors[key] = max(errors[key], err)
                log(f"  {name} {D} shards n={n} F={F} r={r or 1} {str(dtype)[6:]}"
                    f"{' weighted' if weighted else ''}: fwd+grad max |err| {err:.3g}, "
                    f"{'equals' if dtype == torch.float32 else 'within one ulp of'} "
                    f"{'K3' if r else 'K2'}{' and K4' if weighted else ''} on the gathered array")
                del x, w
        torch.cuda.empty_cache()
    mesh = make_mesh(devices=["cuda:0"] * HALO_SHARDS)
    timings = []
    for name, n, F, offs, weighted, r, dtype in [
        ("K5", HALO_K5_N, 128, bench_offsets, True, None, torch.float32),
        ("K5", HALO_K5_N, 128, bench_offsets, True, None, torch.bfloat16),
        ("K5", HALO_PLAIN_SHARD * HALO_SHARDS, 128, offsets, False, None, torch.float32),
        ("K5", HALO_PLAIN_SHARD * HALO_SHARDS, 3, offsets, False, None, torch.float32),
        ("K6", GIANT_N, 16, offsets, False, 8, torch.bfloat16),
        ("K6", GIANT_N, 16, offsets, False, 8, torch.float32),
    ]:
        x = torch.randn(n, F, generator=gen, device=dev).to(dtype)
        w = torch.rand(n, len(offs), generator=gen, device=dev) + 0.5 if weighted else None
        timings.append(time_ring(torch, th, mesh, name, x, offs, w=w, r=r))
        del x, w
    torch.cuda.empty_cache()
    return {"max_abs_err": errors, "timings": timings}


def probe_timing(torch, name: str, case: str, kernel, plain, csr, rhs,
                 nbytes: float, ops: float, earlier=None) -> dict:
    """One probe kernel's row: the kernel, its plain version and
    ``torch.sparse.mm`` of the same operator (``csr`` on the float32
    ``rhs``) in ms, and the bound: the larger of bytes / 3.35 TB/s and
    operations / 67 TFLOP/s.  With ``earlier`` (the kernel's earlier body)
    the four are timed in turns."""
    with torch.no_grad():
        row = {"name": name, "case": case}
        row["library_max_abs_err"] = float((torch.sparse.mm(csr, rhs) - plain()).abs().max())
        fns = {"ms": kernel, "plain_ms": plain, "library_ms": lambda: torch.sparse.mm(csr, rhs)}
        if earlier is None:
            row.update({key: best_ms(torch, fn) for key, fn in fns.items()})
        else:
            row.update(ms_in_turns(torch, {**fns, "earlier_ms": earlier}))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    row["bound_ms"] = max(bytes_ms, ops_ms)
    row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    earlier_note = f", earlier body {row['earlier_ms']:.4f} ms" if earlier else ""
    log(f"  {name} {case}: kernel {row['ms']:.4f} ms{earlier_note}, plain "
        f"{row['plain_ms']:.4f} ms, sparse.mm {row['library_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def check_probe(torch, got, ref, errors: dict, name: str) -> float:
    """A probe kernel against its plain version (float32, rtol = atol =
    1e-5); keeps the largest error under ``name``."""
    torch.cuda.synchronize()
    err = max_err_within_tolerance(torch, got, ref)
    errors[name] = max(errors.get(name, 0.0), err)
    return err


def time_past_l2(torch, np, tpk, tbell, gen) -> dict:
    """P3's ring (``subblock_spmm``) against K1's gather (``block_ell._launch``)
    on one table past the 50 MB L2: n = 1,048,576, F = 128 (x 512 MB), 8
    senders a row within ±255 made with numpy from a seed, so at B = 256,
    Wp = 256 every slot lies in its 128-row sub-block's slice.  Both are
    held bit for bit to the plain version, then timed in turns with
    ``torch.sparse.mm``; one bound for both (the same bytes: x and y once,
    the table once)."""
    n, F, d, B, wp = PAST_L2_N, 128, 8, 256, 256
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    i = np.arange(n)[:, None]
    sidx = torch.from_numpy(((i + rng.integers(-255, 256, size=(n, d))) % n)
                            .astype(np.int32)).to(dev)
    w = torch.from_numpy((rng.random((n, d)) + 0.5).astype(np.float32)).to(dev)
    x = torch.randn(n, F, generator=gen, device=dev)
    with torch.no_grad():
        ref = tpk.subblock_spmm_plain(x, sidx, w, n, B, wp)
        check(torch.equal(tpk.subblock_spmm(x, sidx, w, n, B, wp), ref)
              and torch.equal(tbell._launch(x, sidx, w, n, B, wp), ref),
              "past L2: P3's ring and K1's gather equal the plain version")
        del ref
        csr = csr_of(torch, torch.arange(n, device=dev).repeat_interleave(d), sidx.reshape(-1),
                     w.reshape(-1), n)
        row = ms_in_turns(torch, {
            "ring_ms": lambda: tpk.subblock_spmm(x, sidx, w, n, B, wp),
            "gather_ms": lambda: tbell._launch(x, sidx, w, n, B, wp),
            "library_ms": lambda: torch.sparse.mm(csr, x),
        })
    row.update(n=n, F=F, d=d, B=B, wp=wp, x_mb=n * F * 4 / 1e6)
    bytes_ms = (2 * n * F * 4 + n * d * 8) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n * d * F / F32_OPS_PER_S * 1e3
    row["bound_ms"] = max(bytes_ms, ops_ms)
    row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"  past L2 n={n} F={F} d={d} B={B} Wp={wp} (x {row['x_mb']:.0f} MB): P3 ring "
        f"{row['ring_ms']:.4f} ms, K1 gather {row['gather_ms']:.4f} ms, sparse.mm "
        f"{row['library_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    del x, sidx, w, csr
    torch.cuda.empty_cache()
    return row


def time_window_ring(torch, np, tpk, gp, gen) -> dict:
    """P1's function at (W, B) = (255, 512) in float32 on two kernels: the
    warp gather (``window_gather``) and P3's ring (``subblock_spmm`` at
    B = Wp = 256 on the table's global sender ids, x unpadded: every sender
    lies within ±255 of its receiver, so in its 128-row sub-block's
    slice).  Both are held bit for bit to the plain version, then timed in
    turns with ``torch.sparse.mm``; one bound (x padded read once, y
    written once, the table once)."""
    W, B, ring_b, ring_wp = 255, 512, 256, 256
    nbr, lidx, n, wp = gp.block_table(W, B)
    d, F = lidx.shape[1], gp.F
    dev = torch.device("cuda")
    x = torch.randn(n, F, generator=gen, device=dev)
    xpad = gp.pad_rows(x, wp)
    li = torch.from_numpy(lidx).to(dev)
    sidx = torch.from_numpy(nbr.astype(np.int32)).to(dev)
    w = torch.rand(n, d, generator=gen, device=dev) + 0.5
    with torch.no_grad():
        ref = tpk.window_gather_plain(xpad, li, w, B, wp)
        check(torch.equal(tpk.window_gather(xpad, li, w, B, wp), ref)
              and torch.equal(tpk.subblock_spmm(x, sidx, w, n, ring_b, ring_wp), ref),
              "P1's function: the gather and P3's ring equal the plain version")
        del ref
        csr = csr_of(torch, torch.arange(n, device=dev).repeat_interleave(d), sidx.reshape(-1),
                     w.reshape(-1), n)
        row = ms_in_turns(torch, {
            "gather_ms": lambda: tpk.window_gather(xpad, li, w, B, wp),
            "ring_ms": lambda: tpk.subblock_spmm(x, sidx, w, n, ring_b, ring_wp),
            "library_ms": lambda: torch.sparse.mm(csr, x),
        })
    row.update(n=n, F=F, d=d, W=W, B=B, wp=wp, ring_block=ring_b, ring_wp=ring_wp)
    bytes_ms = ((n + 2 * wp) * F * 4 + n * F * 4 + n * d * 8) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n * d * F / F32_OPS_PER_S * 1e3
    row["bound_ms"] = max(bytes_ms, ops_ms)
    row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"  P1's function n={n} F={F} d={d} (W, B) = ({W}, {B}) float32: warp gather "
        f"{row['gather_ms']:.4f} ms, P3 ring (B = Wp = {ring_wp}) {row['ring_ms']:.4f} ms, "
        f"sparse.mm {row['library_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    del x, xpad, li, sidx, w, csr
    torch.cuda.empty_cache()
    return row


def phase_kernels_probes(torch, np, tpk, tb, tbell, micro, tgraph, probes) -> dict:
    """The probes' kernels against their plain versions at the probes'
    sizes, forward only, each timed at every shape.  bf16 x is held against
    the plain version on the same values widened to float32."""
    log("== kernels: probes P1-P5")
    gp, gp2, sp, pp, wpr = (probes[k] for k in ("gather_probe", "gather_probe2",
                                                "subblock_probe", "panel_ell_probe",
                                                "weighted_probe"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    F = gp.F
    errors, timings = {}, []

    # P1 at every (W, B), float32 and bf16 x; P2's d = 16 case: the warp
    # gather bit for bit against its plain version
    tables = [(W, B, gp.block_table(W, B)) for W, B in gp.CONFIGS]
    tables.append((255, 256, gp2.block_table(255, 256, d=16)))
    for W, B, (_, lidx, n_use, Wp) in tables:
        d = lidx.shape[1]
        x = torch.randn(n_use, F, generator=gen, device=dev)
        li = torch.from_numpy(lidx).to(dev)
        w = torch.rand(n_use, d, generator=gen, device=dev) + 0.5
        rows = torch.arange(n_use, device=dev).repeat_interleave(d)
        cols = (torch.arange(n_use, device=dev) // B * B)[:, None] + li.long()
        csr = csr_rect(torch, rows, cols.reshape(-1), w.reshape(-1), (n_use, n_use + 2 * Wp))
        for dtype in (torch.float32, torch.bfloat16):
            xpad = gp.pad_rows(x, Wp).to(dtype)
            xf = xpad.float()
            y = tpk.window_gather(xpad, li, w, B, Wp)
            ref = tpk.window_gather_plain(xf, li, w, B, Wp)
            err = check_probe(torch, y, ref, errors, "window_gather")
            case = f"W={W} B={B} d={d} {str(dtype)[6:]} x"
            check(torch.equal(y, ref), f"window_gather equals its plain version at {case}")
            log(f"  window_gather n={n_use} F={F} {case}: max |err| {err:.3g}")
            nbytes = (n_use + 2 * Wp) * F * xpad.element_size() + n_use * F * 4 + n_use * d * 8
            row = probe_timing(torch, "window_gather", case,
                               lambda: tpk.window_gather(xpad, li, w, B, Wp),
                               lambda: tpk.window_gather_plain(xpad, li, w, B, Wp),
                               csr, xf, nbytes, 2 * n_use * d * F)
            timings.append({**row, "W": W, "B": B, "d": d, "n": n_use, "F": F,
                            "dtype": str(dtype)[6:]})
        del x, li, w, csr, rows, cols, xpad, xf, y, ref
    window_ring = time_window_ring(torch, np, tpk, gp, gen)

    # P3 on its ring and P4 on its gather, on the probes' two graphs, each
    # bit for bit against its plain version
    n, d = MICRO_N, 8
    n_pad = tgraph.round_up(n, 2048)
    graphs = {W: micro._banded_regular_graph(n, d, W, n_pad=n_pad) for W, _ in pp.CONFIGS}
    for W, B, wp in sp.CONFIGS:
        sidx, w0, _, _ = sp.subblock_table(graphs[W], n, d)
        x = torch.randn(n_pad, F, generator=gen, device=dev)
        si = torch.from_numpy(sidx).to(dev)
        w = torch.from_numpy(w0).to(dev) * (torch.rand(n_pad, d, generator=gen, device=dev) + 0.5)
        y = tpk.subblock_spmm(x, si, w, n_pad, B, wp)
        ref = tpk.subblock_spmm_plain(x, si, w, n_pad, B, wp)
        err = check_probe(torch, y, ref, errors, "subblock_spmm")
        check(torch.equal(y, ref), f"P3's ring equals its plain version at W={W}")
        log(f"  subblock_spmm n={n_pad} F={F} W={W} B={B} Wp={wp}: max |err| {err:.3g}")
        r0 = tbell.sub_block_rows(B)
        start = (torch.arange(n_pad, device=dev) // r0 * r0)[:, None]
        valid = (si.long() - start + wp) % n_pad < r0 + 2 * wp
        rows = torch.arange(n_pad, device=dev).repeat_interleave(d)
        csr = csr_rect(torch, rows, si.reshape(-1), (w * valid).reshape(-1), (n_pad, n_pad))
        row = probe_timing(torch, "subblock_spmm", f"W={W} B={B} Wp={wp}",
                           lambda: tpk.subblock_spmm(x, si, w, n_pad, B, wp),
                           lambda: tpk.subblock_spmm_plain(x, si, w, n_pad, B, wp),
                           csr, x, 2 * n_pad * F * 4 + n_pad * d * 8,
                           2 * int(valid.sum()) * F)
        timings.append({**row, "W": W, "B": B, "wp": wp, "n": n_pad, "F": F, "dtype": "float32"})
        del x, si, w, y, ref, csr, rows, valid, start
    past_l2 = time_past_l2(torch, np, tpk, tbell, gen)

    panel_ran = {W: 0 for W, _ in pp.CONFIGS}
    for W, wp in pp.CONFIGS:
        g = graphs[W]
        s = g.senders.numpy()[: int(g.n_edges)].astype(np.int64)
        r = g.receivers.numpy()[: int(g.n_edges)].astype(np.int64)
        B = pp.panel_block(g.bell_block)
        for W_P in pp.PANEL_SLOTS:
            idx, wgt, n_drop, _ = pp.build_panel_tables(
                s, r, np.ones_like(s, np.float32), n_pad, B, wp, W_P)
            if n_drop > pp.MAX_DROP * n * d:
                log(f"  panel_ell_spmm W={W} W_P={W_P}: skipped, drops {n_drop} edges")
                continue
            panel_ran[W] += 1
            x = torch.randn(n_pad, F, generator=gen, device=dev)
            ii = torch.from_numpy(idx).to(dev)
            wg = torch.from_numpy(wgt).to(dev) * (
                torch.rand(idx.shape, generator=gen, device=dev) + 0.5)
            y = tpk.panel_ell_spmm(x, ii, wg, n_pad, B, wp, W_P)
            ref = tpk.panel_ell_spmm_plain(x, ii, wg, n_pad, B, wp, W_P)
            err = check_probe(torch, y, ref, errors, "panel_ell_spmm")
            check(torch.equal(y, ref),
                  f"P4's gather equals its plain version at W={W} W_P={W_P}")
            log(f"  panel_ell_spmm n={n_pad} F={F} W={W} B={B} Wp={wp} W_P={W_P} "
                f"({idx.shape[1]} slots, {n_drop} edges dropped): max |err| {err:.3g}")
            valid = ii >= 0
            first = (torch.arange(n_pad, device=dev) // B * B - wp)[:, None]
            base = (torch.arange(idx.shape[1], device=dev) // W_P * tpk.PANEL)[None, :]
            cols = (first + base + ii) % n_pad
            rows = torch.arange(n_pad, device=dev)[:, None].expand_as(ii)
            csr = csr_rect(torch, rows[valid], cols[valid], wg[valid], (n_pad, n_pad))
            row = probe_timing(torch, "panel_ell_spmm", f"W={W} B={B} Wp={wp} W_P={W_P}",
                               lambda: tpk.panel_ell_spmm(x, ii, wg, n_pad, B, wp, W_P),
                               lambda: tpk.panel_ell_spmm_plain(x, ii, wg, n_pad, B, wp, W_P),
                               csr, x, 2 * n_pad * F * 4 + n_pad * idx.shape[1] * 8,
                               2 * int(valid.sum()) * F)
            timings.append({**row, "W": W, "B": B, "wp": wp, "W_P": W_P, "slots": idx.shape[1],
                            "n": n_pad, "F": F, "dtype": "float32"})
            del x, ii, wg, y, ref, csr, rows, cols, valid
    check(all(panel_ran.values()), f"panel_ell_spmm ran at least one W_P for each W: {panel_ran}")

    # P5: banded_spmm_cols, and K4 on every row-major variant's weights
    offsets = wpr.probe_offsets()
    n5, D = wpr.N, len(offsets)
    x = torch.randn(n5, F, generator=gen, device=dev)
    w = torch.rand(n5, D, generator=gen, device=dev) + 0.5
    rows = torch.arange(n5, device=dev).repeat_interleave(D)
    cols = (rows.view(n5, D) + torch.tensor(offsets, device=dev)) % n5
    csr = csr_rect(torch, rows, cols.reshape(-1), w.reshape(-1), (n5, n5))
    nbytes, ops = 2 * n5 * F * 4 + n5 * D * 4, 2 * n5 * D * F
    for variant in wpr.VARIANTS:
        wv = wpr.variant_weights(w, variant)
        earlier = None
        if variant == "cols":
            name = "banded_spmm_cols"
            fns = (lambda: tpk.banded_spmm_cols(x, wv, offsets),
                   lambda: tpk.banded_spmm_cols_plain(x, wv, offsets))
            earlier = lambda: tpk._banded_cols_window_launch(x, wv, offsets)  # noqa: E731
        else:
            name = "banded_spmm (P5b)"
            fns = (lambda: tb.banded_spmm(x, wv, offsets),
                   lambda: tb.banded_spmm_plain(x, wv, offsets))
        with torch.no_grad():
            y, ref = fns[0](), fns[1]()
            err = check_probe(torch, y, ref, errors, name)
            if earlier is not None:
                check(torch.equal(y, ref) and torch.equal(y, earlier()),
                      "P5a on K4's ring equals its plain version and its earlier body")
        log(f"  P5 {variant} n={n5} F={F} D={D}: max |err| {err:.3g}")
        if variant in ("cols", "blockw"):
            row = probe_timing(torch, name, f"n={n5} F={F} D={D} {variant}", *fns, csr, x,
                               nbytes, ops, earlier=earlier)
            timings.append({**row, "n": n5, "F": F, "D": D, "dtype": "float32"})
    del x, w, rows, cols, csr
    torch.cuda.empty_cache()
    return {"max_abs_err": errors, "timings": timings, "panel_configs": panel_ran,
            "past_l2": past_l2, "window_ring": window_ring}


def phase_probes(torch, probes) -> dict:
    """The five probe entry points at the JAX probes' sizes, each with the
    launch counters set to 0 just before it and read just after; checks
    the exact launch counts and each case's error."""
    log("== probes")
    calls = PROBE_ITERS + 3        # a correctness call, 2 warm-up calls, the timed calls
    out = {}
    for name, mod in probes.items():
        registry.reset()
        t0 = time.perf_counter()
        res = mod.main(n=mod.N, iters=PROBE_ITERS, device="cuda")
        torch.cuda.synchronize()
        launches = dict(registry.LAUNCHES)
        res["launches"] = launches
        res["seconds"] = time.perf_counter() - t0
        log(f"  {name}: {res['seconds']:.2f} s, launches {launches}")
        expect = {}
        if name in ("gather_probe", "gather_probe2"):
            expect["window_gather"] = len(res["block_ell"]) * calls
            per_config = len(mod.PRECISIONS) if name == "gather_probe" else 1
            check(len(res["block_ell"]) == len(mod.CONFIGS) * per_config,
                  f"{name} ran every configuration")
            for row in res["block_ell"]:
                limit = 1e-2 if row["x_dtype"] == "bfloat16" else 1e-6
                check(row["relerr"] <= limit, f"{name} W={row['W']} B={row['B']} d={row['d']} "
                      f"{row['x_dtype']} x: relerr {row['relerr']:.3g} <= {limit}")
        elif name == "subblock_probe":
            planned = sum(row["shipped_block"] is not None for row in res["configs"])
            expect.update(subblock_spmm=len(mod.CONFIGS) * calls,
                          window_gather=len(mod.CONFIGS) * calls,
                          block_ell_spmm=planned * calls)
            for row in res["configs"]:
                for design in ("sub-blocked", "whole window"):
                    check(row[design]["relerr"] <= 1e-5,
                          f"P3 W={row['W']} {design}: relerr {row[design]['relerr']:.3g}")
        elif name == "panel_ell_probe":
            panel = [row for row in res["rows"] if row["design"] == "panel-ELL"]
            shipped = [row for row in res["rows"] if row["design"] == "shipped"]
            check({row["W"] for row in panel} == {W for W, _ in mod.CONFIGS},
                  "P4 ran at least one W_P for each W")
            expect.update(panel_ell_spmm=len(panel) * calls, block_ell_spmm=len(shipped) * calls)
            for row in panel:
                check(row["relerr"] <= 1e-5, f"P4 W={row['W']} W_P={row['W_P']}: relerr "
                      f"{row['relerr']:.3g}")
        else:
            expect.update(banded_spmm_cols=calls, banded_spmm=(len(mod.VARIANTS) - 1) * calls,
                          banded_spmm_unit=PROBE_ITERS + 2)
            limits = {"mxu1": 1e-2, "mxuallbf16": 1e-2, "mxu2": 1e-4, "mxuall": 1e-4}
            for variant, row in res["variants"].items():
                limit = limits.get(variant, 1e-4 if variant.startswith("hybrid") else 1e-6)
                check(row["rel_err"] <= limit,
                      f"P5 {variant}: rel_err {row['rel_err']:.3g} <= {limit}")
        check(launches == {k: expect.get(k, 0) for k in launches},
              f"{name} launched {launches}, expected {expect} and nothing else")
        out[name] = res
    return out


def phase_adam(torch) -> dict:
    """Adam's step: ``csrc/adam.cu`` against the plain step on the card, bit
    for bit over three steps, then each step timed at ``ADAM_CASES`` beside
    the library's fused step (``torch._fused_adam_``, as
    ``torch.optim.Adam(fused=True)`` calls it after adding one to its step
    counts), which takes a float32 first moment only; where the case's
    moment is float32, whether its three steps equal the plain step's."""
    from gcn_maxcut_tpu_torch.ops import adam as tadam
    from gcn_maxcut_tpu_torch.train.optim import Adam

    log("== adam")
    out = {}
    for case, (shapes, mu_name) in ADAM_CASES.items():
        mu_dtype = getattr(torch, mu_name)
        gen = torch.Generator(device="cuda").manual_seed(3)
        start = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
        grads = [torch.randn(s, generator=gen, device="cuda") * 1e-2 for s in shapes]
        lib = [t.clone() for t in start]
        lib_mu, lib_nu = [torch.zeros_like(t) for t in lib], [torch.zeros_like(t) for t in lib]
        lib_steps = [torch.zeros((), device="cuda") for _ in lib]
        opt = Adam([t.clone() for t in start], 1e-3, mu_dtype=mu_dtype)
        plain = Adam(start, 1e-3, mu_dtype=mu_dtype)

        def library():
            torch._foreach_add_(lib_steps, 1)
            torch._fused_adam_(lib, grads, lib_mu, lib_nu, [], lib_steps, lr=1e-3,
                               beta1=opt.b1, beta2=opt.b2, weight_decay=0.0, eps=opt.eps,
                               amsgrad=False, maximize=False)

        registry.reset()
        for _ in range(3):
            opt.step(grads)
            tadam.step_plain(plain, grads)
            library()
        check({k: v for k, v in registry.LAUNCHES.items() if v}
              == {"adam_update": 3, "adam_count": 3},
              f"adam {case}: one update and one count launch a step, and no other kernel")
        for a, b in zip([*opt.params, *opt.mu, *opt.nu], [*plain.params, *plain.mu, *plain.nu]):
            check(torch.equal(a, b), f"adam {case}: the kernel's step is the plain step's")
        library_equal = None if mu_dtype != torch.float32 else all(
            torch.equal(a, b) for a, b in zip([*lib, *lib_mu, *lib_nu],
                                              [*plain.params, *plain.mu, *plain.nu]))
        del plain
        numel = sum(math.prod(s) for s in shapes)
        # one pass: read g, p, nu and mu, write p, nu and mu
        mu_bytes = torch.finfo(mu_dtype).bits // 8
        bytes_ = numel * (4 * 5 + 2 * mu_bytes)
        ms = ms_in_turns(torch, {"kernel": lambda: tadam.step_kernel(opt, grads),
                                 "plain": lambda: tadam.step_plain(opt, grads),
                                 "library": library})
        row = {"leaves": [list(s) for s in shapes], "numel": numel, "mu_dtype": mu_name,
               "ms": ms["kernel"], "plain_ms": ms["plain"], "library_ms": ms["library"],
               "library_equal": library_equal, "bytes": bytes_,
               "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3,
               "library_bound_ms": numel * 28 / HBM_BYTES_PER_S * 1e3}
        log(f"  {case}: {numel:,} elements, mu {mu_name}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({bytes_:,} bytes); "
            f"library (float32 mu) {row['library_ms']:.4f} ms, bound "
            f"{row['library_bound_ms']:.4f} ms, equal to the plain step: {library_equal}")
        out[case] = row
        del opt, start, grads, lib, lib_mu, lib_nu
        torch.cuda.empty_cache()
    return out


def phase_sddmm(torch, seg) -> dict:
    """The cut loss's SDDMM (C3): ``csrc/sddmm.cu`` against the plain op on
    the card at the recipe's graphs, scores and gradient (one tensor as x
    and y, as the loss calls it) bit for bit, one launch each way; forward
    plus backward timed in turns with the plain op, and with the plain op on
    the same graph stored with no padded slot."""
    from gcn_maxcut_tpu_torch.core.graph import graph_from_edges
    from gcn_maxcut_tpu_torch.data.generate import generate_graph
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs

    log("== sddmm")
    ds = process_graphs([generate_graph(500, d, "reg", seed=40 + d) for d in SDDMM_DEGREES],
                        DataConfig(max_nodes=1000))
    out = {}
    for d, key in zip(SDDMM_DEGREES, sorted(ds.graphs)):
        g = ds.graphs[key].to("cuda")
        spec, m = ds.specs[key], int(g.n_edges)
        bare = graph_from_edges(spec.edges, spec.n_nodes, weights=spec.weights, n_pad=g.n_pad,
                                e_pad=m).to("cuda")
        gen = torch.Generator(device="cuda").manual_seed(d)
        s = torch.softmax(torch.randn(g.n_pad, 3, generator=gen, device="cuda"), dim=-1)
        s.requires_grad_(True)
        de = torch.randn(g.e_pad, generator=gen, device="cuda")

        def fwd_bwd(op, graph=g, cot=de):
            e = op(graph, s, s)
            return (e.detach(), *torch.autograd.grad(e, [s], cot))

        registry.reset()
        got = fwd_bwd(seg.sddmm)
        check({k: v for k, v in registry.LAUNCHES.items() if v}
              == {"sddmm": 1, "sddmm_backward": 1},
              f"sddmm d={d}: one forward and one backward launch, and no other kernel")
        want = fwd_bwd(seg.sddmm_plain)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"sddmm d={d}: the kernel's scores and gradient are the plain op's bit for bit")
        ms = ms_in_turns(torch, {
            "kernel": lambda: fwd_bwd(seg.sddmm),
            "plain": lambda: fwd_bwd(seg.sddmm_plain),
            "plain_unpadded": lambda: fwd_bwd(seg.sddmm_plain, bare, de[:m])})
        k = s.shape[1]
        # forward: senders, receivers, mask, x and y once, the scores; backward:
        # the cotangent, mask, senders, receivers, sender order, both pointer
        # tables, x, the gradient
        bytes_ = 16 * g.e_pad + 8 * g.n_pad * k + 20 * g.e_pad + 8 * (g.n_pad + 1) \
            + 8 * g.n_pad * k
        out[d] = {"shape": [g.n_pad, k, g.e_pad], "n_edges": m, "padded_slots": g.e_pad - m,
                  "ms": ms["kernel"], "plain_ms": ms["plain"],
                  "plain_unpadded_ms": ms["plain_unpadded"], "bytes": bytes_,
                  "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3}
        log(f"  d={d}: n_pad {g.n_pad}, e_pad {g.e_pad} ({g.e_pad - m} padded slots), k = {k}: "
            f"kernel {ms['kernel']:.4f} ms forward + backward, plain {ms['plain']:.4f} ms, "
            f"plain with no padded slot {ms['plain_unpadded']:.4f} ms; bytes bound "
            f"{out[d]['bound_ms']:.6f} ms ({bytes_:,} bytes)")
    return out


def circulant_cut(torch, assignment, offsets) -> int:
    """Cut of a node-order assignment on the circulant graph: each positive
    offset s contributes the edges (i, i + s mod n)."""
    a = torch.from_numpy(assignment).cuda()
    return int(sum(int((a != torch.roll(a, -s)).sum()) for s in offsets if s > 0))


def phase_giant(torch, giant) -> dict:
    log("== giant")
    small = dict(n=4096, bandwidth=31, epochs=4, agg_dtype=None, mu_dtype=None,
                 return_assignment=True)
    p0 = giant.packed_params(4096, seed=0, device="cpu")
    on_card = giant.train_banded_giant_packed(params=p0, device="cuda", **small)
    on_cpu = giant.train_banded_giant_packed(params=p0, device="cpu", **small)
    agree = float((on_card["assignment"] == on_cpu["assignment"]).mean())
    log(f"  small packed run, card vs CPU: history {on_card['history']} vs "
        f"{on_cpu['history']}, assignments agree on {agree:.6f}")
    torch.testing.assert_close(torch.tensor(on_card["history"]),
                               torch.tensor(on_cpu["history"]), rtol=1e-3, atol=0)
    check(agree >= 0.999, "small packed run: card and CPU assignments agree")

    with tempfile.TemporaryDirectory() as tmp:
        free_gb = shutil.disk_usage(tmp).free / 1e9
        log(f"  checkpoints in a temporary directory, {free_gb:.1f} GB free")
        torch.cuda.reset_peak_memory_stats()
        registry.reset()
        res = giant.train_banded_giant_packed(
            epochs=GIANT_EPOCHS, return_assignment=True, checkpoint_path=f"{tmp}/full",
            checkpoint_every=GIANT_CHECKPOINT_EVERY, device="cuda")
        launches = launches_but_adam()
        adam_launches = {k: registry.LAUNCHES[k] for k in ("adam_update", "adam_count")}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        Path(f"{tmp}/full.npz").unlink()
        resume = phase_giant_resume(torch, giant, tmp, res)
    cut = circulant_cut(torch, res["assignment"], res["offsets"])
    m = res["n"] // 8
    log(f"  packed n={res['n']} d={res['d']} offsets {res['offsets']}: epoch "
        f"{res['epoch_time_s'] * 1e3:.3f} ms (first chunk {res['first_chunk_s']:.3f} s), "
        f"{res['edges_per_s_per_epoch']:.4g} edges/s, cut fraction {res['cut_fraction']:.5f} "
        f"(decoded {cut / res['edges']:.5f}), peak {peak_gb:.2f} GB, launches {launches}, "
        f"Adam {adam_launches}")
    check(launches["banded_spmm_unit_packed"] == 6 * GIANT_EPOCHS + 2,
          "K3 launched halo_stream.cu 6 times an epoch plus 2 for the decode")
    # one Adam step an epoch: the first chunk's warm-up epoch, then replays
    check(adam_launches == {"adam_update": res["epochs"], "adam_count": res["epochs"]},
          "C2 launched adam.cu's update and count once each an epoch")
    check(all(v == 0 for k, v in launches.items() if k != "banded_spmm_unit_packed"),
          "the packed trainer runs no earlier body, no K2 and no K4")
    check(all(map(math.isfinite, res["history"])), "finite loss history")
    check(res["cut_fraction"] >= 0.90, "packed cut fraction >= 0.90")
    check(cut / res["edges"] >= 0.90, "decoded assignment cuts >= 0.90 of the edges")
    check(res["assignment"].shape == (res["n"],)
          and list(res["assignment"][[0, m, 2 * m]]) == [0, 1, 2],
          "terminals keep their classes")

    registry.reset()
    plain = giant.train_banded_giant(n=PLAIN_N, epochs=PLAIN_EPOCHS, device="cuda")
    plain_launches = launches_but_adam()
    # two whole chunks of 10, as the JAX trainer runs 10 epochs
    check(plain["epochs"] == len(plain["history"]) == 2 * PLAIN_EPOCHS,
          "the plain trainer runs two chunks")
    log(f"  plain n={plain['n']}: epoch {plain['epoch_time_s'] * 1e3:.3f} ms, cut "
        f"{plain['initial_cut']:.0f} -> {plain['final_cut']:.0f} "
        f"(fraction {plain['cut_fraction']:.5f}), launches {plain_launches}")
    # an epoch: conv1's F = 16 sum forward and backward on halo_stream.cu;
    # conv2's and the loss's F = 3 sums forward and backward on the earlier body
    check(plain_launches["banded_spmm_unit"] == 2 * plain["epochs"],
          "K2 launched halo_stream.cu 2 times an epoch (F = 16)")
    check(plain_launches["banded_spmm_unit_window"] == 4 * plain["epochs"],
          "K2 launched the earlier body 4 times an epoch (F = 3)")
    check(all(v == 0 for k, v in plain_launches.items()
              if k not in ("banded_spmm_unit", "banded_spmm_unit_window")),
          "the plain trainer runs no K3 and no K4")
    check(plain["final_cut"] > plain["initial_cut"], "plain trainer improves the cut")
    for r in (res, plain):
        r.pop("history")
        r.pop("assignment", None)
    torch.cuda.empty_cache()
    return {"packed": {**res, "decoded_cut_fraction": cut / res["edges"],
                       "peak_memory_gb": peak_gb, "launches": launches,
                       "adam_launches": adam_launches},
            "resume": resume,
            "plain": {**plain, "launches": plain_launches},
            "small_agreement": agree}


def phase_giant_resume(torch, giant, tmp: str, full: dict) -> dict:
    """Checkpoints of the packed giant trainer at full size: the
    uninterrupted run ``full`` wrote after epoch 20 and at the end; a run
    of 20 epochs writes its checkpoint, and a resumed run trains from it to
    40.  The resumed run's last 20 losses must equal the uninterrupted
    run's, and K3's launches on it are counted exactly."""
    half = giant.train_banded_giant_packed(epochs=GIANT_CHECKPOINT_EVERY,
                                           checkpoint_path=f"{tmp}/half", device="cuda")
    registry.reset()
    resumed = giant.train_banded_giant_packed(epochs=GIANT_EPOCHS, resume_from=f"{tmp}/half",
                                              return_assignment=True, device="cuda")
    launches = launches_but_adam()
    Path(f"{tmp}/half.npz").unlink()
    ran = GIANT_EPOCHS - GIANT_CHECKPOINT_EVERY
    tail, ref = resumed["history"][-ran:], full["history"][-ran:]
    exact = tail == ref and half["history"] == full["history"][:GIANT_CHECKPOINT_EVERY]
    rel = max(abs(a - b) / abs(b) for a, b in zip(tail, ref))
    writes = full["checkpoint_writes"] + half["checkpoint_writes"]
    write_s = sum(w["seconds"] for w in full["checkpoint_writes"])
    share = write_s / (write_s + GIANT_EPOCHS * full["epoch_time_s"])
    log(f"  resumed at epoch {resumed['resumed_from_epoch']} (load "
        f"{resumed['resume_s']:.2f} s), {ran} epochs at {resumed['epoch_time_s'] * 1e3:.3f} ms: "
        f"last {ran} losses equal to the uninterrupted run's: {exact} (largest relative "
        f"difference {rel:.3g}); launches {launches}")
    log("  checkpoint writes (epoch, s, GB): " + ", ".join(
        f"({w['epoch']}, {w['seconds']:.2f}, {w['bytes'] / 1e9:.3f})" for w in writes)
        + f"; the uninterrupted run's 2 writes are {share:.4f} of its 40 epochs + writes; "
        f"card: {card_line()}")
    check(resumed["epochs"] == GIANT_EPOCHS and len(resumed["history"]) == GIANT_EPOCHS,
          "the resumed run trains exactly to 40 epochs")
    # K3 sums each row in one order and the loss and Adam run at fixed
    # shapes, so the card repeats a run bit for bit: equality, not a tolerance
    check(exact, "the resumed run's last 20 losses (and the 20-epoch run's) equal the "
                 "uninterrupted run's")
    check(launches["banded_spmm_unit_packed"] == 6 * ran + 2,
          "K3 launched 6 times an epoch the resumed run ran, plus 2 for the decode")
    check(all(v == 0 for k, v in launches.items() if k != "banded_spmm_unit_packed"),
          "the resumed run runs no other kernel")
    check(all(w["bytes"] > 0 and w["seconds"] > 0 for w in writes), "every checkpoint written")
    return {"exact": exact, "max_rel_diff": rel, "launches": launches,
            "resume_s": resumed["resume_s"], "epoch_time_s": resumed["epoch_time_s"],
            "final_cut": resumed["final_cut"], "writes": writes,
            "write_share_of_40_epochs": share}


def phase_halo(torch, tgb, giant, make_mesh, single_fraction: float) -> dict:
    """The node-sharded trainers on a ring of 4 shards on the card."""
    log("== halo")
    ring = make_mesh(devices=["cuda:0"] * HALO_SHARDS)
    small = tgb.PackedHaloGiantConfig(bandwidth=31, epochs=4, epochs_per_call=2, agg_dtype=None,
                                      mu_dtype=None)
    p0 = giant.packed_params(4096, seed=0, device="cpu")
    on_card = tgb.train_halo_giant_packed(1024, small, ring, params=p0, return_assignment=True)
    on_cpu = tgb.train_halo_giant_packed(1024, small, make_mesh(devices=["cpu"] * HALO_SHARDS),
                                         params=p0, return_assignment=True)
    agree = float((on_card["assignment"] == on_cpu["assignment"]).mean())
    log(f"  small packed run on 4 shards, card vs CPU ring: history {on_card['history']} vs "
        f"{on_cpu['history']}, assignments agree on {agree:.6f}")
    torch.testing.assert_close(torch.tensor(on_card["history"]),
                               torch.tensor(on_cpu["history"]), rtol=1e-3, atol=0)
    check(agree >= 0.999, "small packed halo run: card and CPU assignments agree")
    one = tgb.train_halo_giant_packed(4096, small, make_mesh(devices=["cuda:0"]), params=p0)
    single = giant.train_banded_giant_packed(n=4096, bandwidth=31, epochs=4, epochs_per_call=2,
                                             agg_dtype=None, mu_dtype=None, params=p0,
                                             device="cuda")
    one_rel = max(abs(a - b) / abs(b) for a, b in zip(one["history"], single["history"]))
    log(f"  1-shard ring vs the single-chip packed trainer: history {one['history']} vs "
        f"{single['history']}, largest relative difference {one_rel:.3g}")
    torch.testing.assert_close(torch.tensor(one["history"]), torch.tensor(single["history"]),
                               rtol=1e-3, atol=0)

    torch.cuda.reset_peak_memory_stats()
    registry.reset()
    res = tgb.train_halo_giant_packed(HALO_PACKED_SHARD, tgb.PackedHaloGiantConfig(epochs=GIANT_EPOCHS),
                                      ring, return_assignment=True)
    launches = launches_but_adam()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cut = circulant_cut(torch, res["assignment"], res["offsets"])
    m = res["n"] // 8
    log(f"  packed halo n={res['n']} on {res['num_devices']} shards: epoch "
        f"{res['epoch_time_s'] * 1e3:.3f} ms (first chunk {res['first_chunk_s']:.3f} s), "
        f"{res['edges_per_s_per_epoch']:.4g} edges/s, cut fraction {res['cut_fraction']:.5f} "
        f"(decoded {cut / res['edges']:.5f}; single-chip {single_fraction:.5f}), peak "
        f"{peak_gb:.2f} GB, launches {launches}")
    check(launches["halo_banded_spmm_unit_packed"] == 6 * HALO_SHARDS * GIANT_EPOCHS + 2 * HALO_SHARDS,
          "K6 launched 6 times an epoch on each shard, plus 2 each for the decode")
    check(all(v == 0 for k, v in launches.items() if k != "halo_banded_spmm_unit_packed"),
          "the packed halo trainer runs no K2, K3, K4 or K5")
    check(all(map(math.isfinite, res["history"])), "finite loss history")
    check(res["cut_fraction"] >= 0.90, "packed halo cut fraction >= 0.90")
    check(cut / res["edges"] >= 0.90, "decoded assignment cuts >= 0.90 of the edges")
    check(list(res["assignment"][[0, m, 2 * m]]) == [0, 1, 2], "terminals keep their classes")
    check(abs(res["cut_fraction"] - single_fraction) <= 0.005,
          "packed halo cut within 0.005 of the single-chip packed trainer's")

    registry.reset()
    plain = tgb.train_halo_giant(HALO_PLAIN_SHARD, tgb.HaloGiantConfig(epochs=HALO_PLAIN_EPOCHS),
                                 ring)
    plain_launches = launches_but_adam()
    log(f"  plain halo n={plain['n']} on {plain['num_devices']} shards: epoch "
        f"{plain['epoch_time_s'] * 1e3:.3f} ms, cut {plain['initial_cut']:.0f} -> "
        f"{plain['final_cut']:.0f} (fraction {plain['cut_fraction']:.5f}), launches {plain_launches}")
    # an epoch on each shard: conv1 and conv2 at F = 128 forward and
    # backward on halo_stream.cu, the loss's F = 3 sum forward and backward
    # on the earlier body
    check(plain_launches["halo_banded_spmm"] == 4 * HALO_SHARDS * HALO_PLAIN_EPOCHS,
          "K5 launched halo_stream.cu 4 times an epoch on each shard (F = 128)")
    check(plain_launches["halo_banded_spmm_window"] == 2 * HALO_SHARDS * HALO_PLAIN_EPOCHS,
          "K5 launched the earlier body 2 times an epoch on each shard (F = 3)")
    check(all(v == 0 for k, v in plain_launches.items()
              if k not in ("halo_banded_spmm", "halo_banded_spmm_window")),
          "the plain halo trainer runs no other kernel")
    check(all(map(math.isfinite, plain["history"])), "finite loss history")
    check(plain["final_cut"] > plain["initial_cut"], "plain halo trainer improves the cut")
    for r in (res, plain):
        r.pop("history")
        r.pop("assignment", None)
    torch.cuda.empty_cache()
    return {"packed": {**res, "decoded_cut_fraction": cut / res["edges"], "peak_memory_gb": peak_gb,
                       "launches": launches, "single_chip_cut_fraction": single_fraction},
            "plain": {**plain, "launches": plain_launches},
            "small_agreement": agree, "one_shard_max_rel_diff": one_rel}


def phase_recipe(run_pipeline, cli_main) -> dict:
    from gcn_maxcut_tpu_torch.train.config import TrainingConfig

    log("== recipe")
    registry.reset()
    res = run_pipeline(OUT_DIR / "chip_smoke_pipeline", device="cuda")
    adam_launches = {k: registry.LAUNCHES[k] for k in ("adam_update", "adam_count")}
    sddmm_launches = {k: registry.LAUNCHES[k] for k in ("sddmm", "sddmm_backward")}
    tested_path = OUT_DIR / "chip_smoke_pipeline" / "test_results.json"
    check(cli_main(["test", "--dataset", res["dataset"], "--checkpoint",
                    res["final_checkpoint"], "--output", str(tested_path),
                    "--device", "cuda"]) == 0, "the test command ran")
    launches = dict(registry.LAUNCHES)
    tested = json.loads(tested_path.read_text())["individual_results"]
    log(f"  {res['epochs_run']} epochs, {res['epoch_ms']:.3f} ms an epoch (training "
        f"{res['training_s']:.2f} s); held-out avg cut simple {res['avg_simple_cut']:.2f}, "
        f"post-processed {res['avg_post_cut']:.2f}, refined {res['avg_refined_cut']:.2f} "
        f"({res['avg_refine_s']:.5f} s a graph), randomized {res['avg_randomized_cut']:.2f}; "
        f"test command on the {len(tested)} training graphs: post "
        f"{sum(r['post_cut'] for r in tested) / len(tested):.2f}, refined "
        f"{sum(r['refined_cut'] for r in tested) / len(tested):.2f}; launches {launches}, "
        f"Adam {adam_launches}, SDDMM {sddmm_launches}")
    # an Adam step a graph an epoch; a stop inside a chunk runs its frozen
    # epochs to the chunk's end
    steps = adam_launches["adam_count"]
    chunk = TrainingConfig.epochs_per_call
    check(adam_launches["adam_update"] == steps and steps % len(tested) == 0
          and res["epochs_run"] <= steps // len(tested) < res["epochs_run"] + chunk,
          "C2 launched adam.cu's update and count once each an Adam step of the training")
    check(sddmm_launches == {"sddmm": steps, "sddmm_backward": steps},
          "C3 launched sddmm.cu once forward and once backward a graph step of the training")
    # The JAX package's own pipeline on this configuration (python -m
    # gcn_maxcut_tpu pipeline, run on the CPU) decodes a post-processed
    # average cut of REFERENCE_POST_CUT and does not beat its randomized
    # baseline with post-processing alone; the default decode, the refine,
    # is what is held against the baseline.
    check(res["avg_post_cut"] > res["avg_simple_cut"],
          "post-processing improves on the argmax decode")
    check(res["avg_post_cut"] >= 0.98 * REFERENCE_POST_CUT,
          f"post-processed cut at least 98% of the JAX pipeline's {REFERENCE_POST_CUT}")
    check(res["avg_refined_cut"] >= res["avg_randomized_cut"],
          "the refined average cut on the held-out graphs at least the randomized one")
    check(len(tested) == 20 and all(r["refined_cut"] >= r["post_cut"] for r in tested),
          "the test command's refined cut at least its post-processed cut on every graph")
    res.pop("summary")
    res.pop("history")
    return {**res, "launches": launches, "adam_launches": adam_launches,
            "sddmm_launches": sddmm_launches,
            "test_command": {"graphs": len(tested),
                             "post": [r["post_cut"] for r in tested],
                             "refined": [r["refined_cut"] for r in tested]}}


def phase_quality(quality, arm: str = "default") -> dict:
    """The quality suite at the JAX defaults, with one arm of
    ``experiments/quality_sweep.py`` (``QUALITY_ARMS``); each size printed
    beside the JAX package's numbers for that arm (cuts, not times)."""
    train_kwargs, reference, jax_simple_mean, gate_simple = QUALITY_ARMS[arm]
    log(f"== quality ({arm}: train_kwargs {train_kwargs})")
    registry.reset()
    t0 = time.perf_counter()
    res = quality.run_quality_suite(recipe="mixed", train_kwargs=train_kwargs, device="cuda")
    seconds = time.perf_counter() - t0
    launches = dict(registry.LAUNCHES)
    log(f"  {seconds:.1f} s; per size: port [JAX package] "
        "simple, post, refined, randomized, refined-random")
    for s, v in res["per_size"].items():
        ours = (v["simple"], v["post"], v["refined"], v["randomized"], v["refined_random"])
        log(f"  n={s} ({v['graphs']} graphs): "
            + ", ".join(f"{o:.1f} [{r}]" for o, r in zip(ours, reference[s]))
            + f"; post {v['post_time_s']:.5f} s, refine {v['refine_time_s']:.5f} s a graph")
    refined_mean = sum(v["refined"] for v in res["per_size"].values()) / len(res["per_size"])
    log(f"  simple mean {res['simple_mean']:.2f} (JAX {jax_simple_mean}, reference "
        f"{REFERENCE_SIMPLE_MEAN}{'' if gate_simple else ': logged, not gated'}); refined mean "
        f"{refined_mean:.2f} (JAX {sum(r[2] for r in reference.values()) / len(reference):.1f}); "
        f"default decode >= randomized at every size: "
        f"{res['default_decode_beats_randomized_all_sizes']}; post >= randomized at "
        f"{res['gcn_post_beats_randomized_sizes']} sizes; "
        f"refined_gcn_beats_refined_random_all_sizes: "
        f"{res['refined_gcn_beats_refined_random_all_sizes']}; launches {launches}")
    check(all(v["graphs"] == 6 for v in res["per_size"].values()),
          "every suite graph decoded")
    if gate_simple:
        check(res["simple_mean"] >= REFERENCE_SIMPLE_MEAN,
              f"simple-decode mean at least the reference's {REFERENCE_SIMPLE_MEAN}")
    check(res["default_decode_beats_randomized_all_sizes"],
          "the default decode at least the randomized baseline at every size")
    return {**res, "arm": arm, "train_kwargs": train_kwargs, "refined_mean": refined_mean,
            "seconds": seconds, "launches": launches}


def _epoch_ms(times: list) -> float:
    """Mean host-clock ms of the epochs after the first; the loop reads
    every epoch's loss on the host, so each epoch ends synchronised."""
    return (times[-1] - times[0]) / (len(times) - 1) * 1e3


def phase_variants(torch) -> dict:
    """The training variants at the recipe's full width, the card against
    the CPU on each variant at n_pad 64, and the QUBO loop."""
    from gcn_maxcut_tpu_torch.baselines.randomized import randomized_k_way_maxcut
    from gcn_maxcut_tpu_torch.core.graph import pad_graph_batch
    from gcn_maxcut_tpu_torch.data.generate import generate_graph_dataset
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
    from gcn_maxcut_tpu_torch.eval import harness
    from gcn_maxcut_tpu_torch.models.gcn import embedding_init, gcn_dev_init
    from gcn_maxcut_tpu_torch.objectives.cut_loss import hard_cut_value
    from gcn_maxcut_tpu_torch.train import loop as tloop
    from gcn_maxcut_tpu_torch.train import qubo_loop as tqubo
    from gcn_maxcut_tpu_torch.train.config import TrainingConfig

    log("== variants")
    # 1. card against CPU, each variant from one copied start, 10 epochs at n_pad 64
    specs, _ = generate_graph_dataset(3, 40, 56, 3, 6, base_seed=21)
    ds = process_graphs(specs, DataConfig(max_nodes=64))
    batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])
    small = {}
    for name, kw in VARIANT_CHECKS.items():
        cfg = TrainingConfig(**{**dict(n_nodes=64, number_epochs=10, learning_rate=5e-3,
                                       patience=100), **kw})
        steps = len(specs) if cfg.step_mode == "per_graph" else 1
        start = tloop.setup_train_state(cfg, steps, device="cpu").params()   # one draw for both
        hist = [tloop.train_model(batch, cfg, state=tloop.setup_train_state(
            cfg, steps, params=start, device=dev))[4] for dev in ("cuda", "cpu")]
        rel = max(abs(a - b) / abs(b) for a, b in zip(*hist))
        log(f"  {name}, card vs CPU: history {hist[0]} vs {hist[1]} (largest relative "
            f"difference {rel:.3g})")
        torch.testing.assert_close(torch.tensor(hist[0]), torch.tensor(hist[1]),
                                   rtol=1e-4, atol=0)
        small[name] = rel
    g_small = ds.graphs[0]
    qcfg = tqubo.QuboConfig(dim_embedding=16, hidden_dim=8, learning_rate=1e-2,
                            number_epochs=10, seed=1)
    gen = torch.Generator().manual_seed(1)
    qstart = gcn_dev_init(16, 8, 1, generator=gen)
    qstart["embed"] = embedding_init(g_small.n_pad, 16, gen)
    qruns = [tqubo.run_gnn_training(g_small, qcfg, device=dev, params=qstart)[1]
             for dev in ("cuda", "cpu")]
    rel = max(abs(a - b) / abs(b) for a, b in zip(qruns[0]["loss_history"],
                                                   qruns[1]["loss_history"]))
    log(f"  qubo, card vs CPU: history {qruns[0]['loss_history']} vs "
        f"{qruns[1]['loss_history']} (largest relative difference {rel:.3g})")
    torch.testing.assert_close(torch.tensor(qruns[0]["loss_history"]),
                               torch.tensor(qruns[1]["loss_history"]), rtol=1e-4, atol=0)
    small["qubo"] = rel

    # 2. the recipe's data at full width: batched steps, cosine rate, 300 epochs
    specs, _ = generate_graph_dataset(20, 500, 500, 6, 8, base_seed=1000)
    ds = process_graphs(specs, DataConfig(max_nodes=1000))
    batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])
    runs = {}
    for name, kw in (("batched", dict(step_mode="batched", lr_schedule="cosine",
                                      number_epochs=RECIPE_EPOCHS)),
                     ("per_graph", dict(number_epochs=VARIANT_PER_GRAPH_EPOCHS))):
        cfg = TrainingConfig(n_nodes=1000, learning_rate=1e-3, seed=1000, **kw)
        times = []
        registry.reset()
        params, best, final_epoch, _, hist = tloop.train_model(
            batch, cfg, callback=lambda e, loss: times.append(time.perf_counter()),
            device="cuda")
        runs[name] = {"params": params, "best_loss": best, "epochs_run": final_epoch + 1,
                      "history": hist, "epoch_ms": _epoch_ms(times),
                      "launches": launches_but_adam()}
    b, pg = runs["batched"], runs["per_graph"]
    log(f"  recipe data (20 graphs n=500, 1000-wide): batched + cosine {b['epochs_run']} epochs, "
        f"{b['epoch_ms']:.3f} ms an epoch; per_graph {pg['epoch_ms']:.3f} ms an epoch "
        f"({pg['epochs_run']} epochs); loss {b['history'][0]:.1f} -> {b['history'][-1]:.1f} "
        f"(best {b['best_loss']:.1f}); card: {card_line()}")
    check(all(map(math.isfinite, b["history"])), "finite batched loss history")
    check(b["best_loss"] < b["history"][0] and b["history"][-1] < b["history"][0],
          "batched + cosine training improves the loss")
    check(all(v == 0 for name, r in runs.items()
              for v in launches_but_sddmm(r["launches"], name).values()),
          "the recipe's variants run no hand-written kernel but Adam's and the loss's SDDMM "
          "(dense aggregation)")

    test_specs, _ = generate_graph_dataset(5, 500, 500, 6, 8, base_seed=1000 + 5000)
    tds = process_graphs(test_specs, DataConfig(max_nodes=1000))
    results, _ = harness.test_multiple_graphs(b["params"], tds, [500],
                                              post_processing_iterations=200,
                                              verbose=False, refine=True)
    rand = [randomized_k_way_maxcut(tds.graphs[k].to("cuda"), 3, 10_000, seed=k)[1]
            for k in sorted(tds.graphs)]
    refined = sum(r["refined_cut"] for r in results) / len(results)
    randomized = sum(rand) / len(rand)
    log(f"  held-out (5 graphs): simple {sum(r['simple_cut'] for r in results) / 5:.2f}, "
        f"post {sum(r['post_cut'] for r in results) / 5:.2f}, refined {refined:.2f}, "
        f"randomized 10k {randomized:.2f}")
    check(len(results) == 5 and refined > randomized,
          "the default decode beats the 10k randomized baseline on the held-out graphs")

    # 3. the QUBO loop at the legacy widths (emb 80, hidden 40, lr 1e-4) on the
    #    first recipe graph, its depth cut to QUBO_EPOCHS epochs
    g = ds.graphs[0]
    registry.reset()
    qparams, q = tqubo.run_gnn_training(g, tqubo.QuboConfig(number_epochs=QUBO_EPOCHS),
                                        device="cuda")
    qlaunches = launches_but_adam()
    edges = int(g.n_edges) // 2
    bit_cut = float(hard_cut_value(g.to("cuda"), q["best_bitstring"].long()))
    log(f"  qubo (emb 80, hidden 40): {q['epochs']} epochs in {q['runtime_s']:.2f} s "
        f"({q['runtime_s'] / q['epochs'] * 1e3:.3f} ms an epoch), loss "
        f"{q['loss_history'][0]:.1f} -> {q['final_loss']:.1f}, best cut {q['best_cut']:.0f} of "
        f"{edges} edges")
    check(all(map(math.isfinite, q["loss_history"])), "finite QUBO loss history")
    check(q["final_loss"] < q["loss_history"][0], "the QUBO loss improves")
    check(bit_cut == q["best_cut"], "the best bitstring cuts best_cut edges")
    check(q["best_cut"] > edges / 2, "the QUBO cut beats a uniform 2-way split's E/2")
    check(all(v == 0 for v in qlaunches.values()),
          "the QUBO loop runs no hand-written kernel but Adam's")
    for r in runs.values():
        r.pop("params")
        r.pop("history")
    return {"card_vs_cpu_max_rel_diff": small, **runs,
            "held_out": {"refined": refined, "randomized_10k": randomized},
            "qubo": {"epochs": q["epochs"], "runtime_s": q["runtime_s"], "best_cut": q["best_cut"],
                     "edges": edges, "first_loss": q["loss_history"][0],
                     "final_loss": q["final_loss"]}}


def decode_ms(torch, dataset: str, checkpoint: str) -> dict:
    """The default decode (``refine_multi_start``: 200 rollouts, the climb
    from the best 3 and the argmax decode) of the recipe's graphs (the
    ``test`` command's 20, n = 500, d in [6, 8]) with its final parameters:
    ms a graph on a synchronised host clock, the climb as ``csrc/climb.cu``
    (the main path), captured and eager (the lockstep routes, forced by a
    zero shared-memory limit; the climbs kept for reuse dropped first, so
    the one capture of the shape is inside the time), in turns (kernel,
    captured, eager, eager, captured, kernel); the assignments equal bit
    for bit and the kernel launched once a graph on its route alone; then
    each mode's busy share over one more pass (``busy_share``)."""
    from gcn_maxcut_tpu_torch.baselines import local_search as tls
    from gcn_maxcut_tpu_torch.data.io import load_dataset
    from gcn_maxcut_tpu_torch.eval.decode import refine_multi_start
    from gcn_maxcut_tpu_torch.eval.harness import _forward
    from gcn_maxcut_tpu_torch.ops import climb as tclimb
    from gcn_maxcut_tpu_torch.train.checkpoint import load_checkpoint
    from gcn_maxcut_tpu_torch.train.config import TrainingConfig
    from gcn_maxcut_tpu_torch.train.loop import setup_train_state

    ds = load_dataset(dataset)
    state = setup_train_state(TrainingConfig(n_nodes=ds.config.max_nodes), device="cuda")
    params = load_checkpoint(checkpoint, state.params())[0]
    graphs = [ds.graphs[k].to("cuda") for k in sorted(ds.graphs)]
    probs = [_forward(params, g) for g in graphs]

    def decode_all(_k=None):
        out = []
        for i, (g, p) in enumerate(zip(graphs, probs)):
            gen = torch.Generator(device="cuda").manual_seed(i)
            out.append(refine_multi_start(g, p, gen, 200, 4))
        return out

    @contextlib.contextmanager
    def route(mode: str):
        limit = tclimb._SMEM_LIMIT
        tls.clear_climbs()
        if mode != "kernel":
            tclimb._SMEM_LIMIT = 0
        try:
            with eager_chunks(tls, mode == "eager"):
                yield
        finally:
            tclimb._SMEM_LIMIT = limit
            tls.clear_climbs()

    def timed_pass(mode: str):
        with route(mode):
            launched = registry.LAUNCHES["climb"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = decode_all()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / len(graphs)
        return res, ms, registry.LAUNCHES["climb"] - launched

    modes = ("kernel", "captured", "eager")
    ms = {mode: [] for mode in modes}
    results, launches = {}, {}
    for mode in ("kernel", "captured", "eager", "eager", "captured", "kernel"):
        res, t, n = timed_pass(mode)
        ms[mode].append(t)
        results.setdefault(mode, res)
        launches.setdefault(mode, n)
    same = all(torch.equal(a, b) and float(c) == float(d)
               for mode in modes[1:]
               for (a, c), (b, d) in zip(results["kernel"], results[mode]))
    check(same, "the kernel's refined assignments equal the captured and eager climbs' bit "
          "for bit")
    check(launches == {"kernel": len(graphs), "captured": 0, "eager": 0},
          f"the climb kernel launched once a graph on its route alone: {launches}")
    busy = {}
    for mode in modes:
        with route(mode):
            decode_all()                                 # the capture, outside the window
            b = busy_share(torch, f"default decode, {mode}", decode_all, 1, 1)
        busy[mode] = {**b, "wall_ms_per_graph": b["wall_ms_per_epoch"] / len(graphs)}
    cuts = [float(c) for _, c in results["kernel"]]
    log(f"  default decode of the recipe's {len(graphs)} graphs (n=500): "
        + ", ".join(f"{mode} {min(ms[mode]):.3f} ms a graph (passes {ms[mode]}, busy share "
                    f"{busy[mode]['busy_share']})" for mode in modes)
        + f"; assignments equal: {same}; refined cuts {cuts}")
    return {"graphs": len(graphs), "ms_per_graph": ms, "busy": busy, "equal": same,
            "launches": launches, "refined_cuts": cuts}


def phase_timings(torch, micro: dict, refine_s_at_500: float, recipe: dict) -> dict:
    """The recipe timings, ``bench --what train`` and ``--what post``, as
    ``bench --what all`` printed them in the microbench phase, and the
    default decode captured against eager (``decode_ms``)."""
    log("== timings")
    card = card_line()
    decode = decode_ms(torch, recipe["dataset"], recipe["final_checkpoint"])
    train, post = micro["train"], micro["post"]
    log(f"  recipe epoch {train['epoch_time_s'] * 1e3:.3f} ms (the least of 3 differenced "
        f"estimates, mean {train['epoch_time_stats']['mean_s'] * 1e3:.3f} ms; first chunk "
        f"{train['compile_time_s']:.2f} s; {train['speedup_vs_reference']:.1f}x the "
        f"reference's CPU epoch); post-processing n={post['n']}, {post['iterations']} "
        f"rollouts: {post['time_s'] * 1e3:.4f} ms; refined decode at n=500: "
        f"{refine_s_at_500 * 1e3:.3f} ms a graph; card: {card}")
    check(train["epoch_time_s"] > 0 and post["time_s"] > 0, "positive times")
    return {"train": train, "post": post, "refine_s_at_500": refine_s_at_500,
            "decode": decode, "card": card}


def phase_locality(torch, np, loc) -> dict:
    log("== locality")
    small = dict(n=4096, epochs=10)
    p0 = loc.locality_params(4096)
    on_card = loc.train_locality(params=p0, device="cuda", **small)
    on_cpu = loc.train_locality(params=p0, device="cpu", **small)
    agree = float((on_card["assignment"] == on_cpu["assignment"]).mean())
    log(f"  n=4096, card vs CPU: history {on_card['history']} vs {on_cpu['history']}, "
        f"assignments agree on {agree:.6f}")
    torch.testing.assert_close(torch.tensor(on_card["history"]),
                               torch.tensor(on_cpu["history"]), rtol=1e-3, atol=0)
    check(agree >= 0.999, "small locality run: card and CPU assignments agree")

    import scipy

    from gcn_maxcut_tpu_torch.data.reorder import rcm_permutation

    # this machine's relabeling, for tools/locality_reference.py --perm
    perm = rcm_permutation(loc.locality_spec(LOCALITY_N).edges, LOCALITY_N)
    np.save(OUT_DIR / "locality_rcm_perm.npy", perm)
    log(f"  SciPy {scipy.__version__} (its RCM relabels the graph; saved to "
        f"{OUT_DIR.name}/locality_rcm_perm.npy)")
    registry.reset()
    res = loc.train_locality(n=LOCALITY_N, device="cuda")
    launches = launches_but_adam()
    ratio = res["final_cut"] / REFERENCE_LOCALITY_CUT
    log(f"  n={res['n']} (n_pad {res['n_pad']}, RCM bandwidth {res['rcm_bandwidth']}, B="
        f"{res['bell_block']}, Wp={res['bell_wp']}, width {res['bell_width']}, "
        f"{res['n_outliers']} outliers): {res['epochs_run']} epochs, {res['epoch_ms']:.3f} ms an "
        f"epoch (graph built in {res['build_s']:.2f} s on the host); cut {res['initial_cut']:.0f} -> "
        f"{res['final_cut']:.0f} (fraction {res['cut_fraction']:.5f}, {ratio:.5f} of the JAX "
        f"package's {REFERENCE_LOCALITY_CUT:.0f}); launches {launches}")
    # 4 a training epoch (conv1 and conv2, forward and backward), 2 for each
    # of the two decode forwards (initial and best parameters)
    check(launches["block_ell_spmm"] == 4 * res["epochs_run"] + 2 * 2,
          "K1 launched 4 times an epoch plus 2 for each decode")
    check(all(v == 0 for k, v in launches_but_sddmm(launches, "the locality trainer").items()
              if k != "block_ell_spmm"),
          "the locality trainer runs no banded kernel")
    check(all(map(math.isfinite, res["history"])), "finite loss history")
    check(res["final_cut"] > res["initial_cut"], "training improves the cut")
    check(res["cut_fraction"] > 2 / 3, "cut beats the (k-1)/k = 2/3 floor")
    check(res["graph_digest"] == REFERENCE_LOCALITY_GRAPH,
          f"the graph is the one the JAX reference trained on (digest {res['graph_digest']}, "
          f"reference {REFERENCE_LOCALITY_GRAPH}): rerun tools/locality_reference.py --perm "
          f"{OUT_DIR.name}/locality_rcm_perm.npy")
    check(abs(ratio - 1) <= 0.02, "cut within 2% of the JAX package's")
    res.pop("assignment")
    res.pop("history")
    torch.cuda.empty_cache()
    return {**res, "launches": launches, "reference_cut": REFERENCE_LOCALITY_CUT,
            "reference_graph": REFERENCE_LOCALITY_GRAPH, "small_agreement": agree}


def check_shard_k1(torch, tbell, sg, d: int, gen) -> float:
    """K1 on shard d's hop-0 plan at F = 64 and 3 against its plain
    version, forward and gradient; the largest error."""
    args = (sg.n_shard, sg.bell_block, sg.bell_wp)
    ops = (sg.bell_senders[d], sg.bell_weights[d], sg.bell_out_senders[d],
           sg.bell_out_receivers[d], sg.bell_out_weights[d])
    err = 0.0
    for F in (64, 3):
        x = torch.randn(sg.n_shard, F, generator=gen, device="cuda", requires_grad=True)
        dy = torch.randn(sg.n_shard, F, generator=gen, device="cuda")
        y = tbell.block_ell_spmm(x, *ops, *args)
        (dx,) = torch.autograd.grad(y, x, dy)
        with torch.no_grad():
            err = max(err, max_err_within_tolerance(
                torch, y.detach(), tbell.block_ell_spmm_plain(x, *ops, *args)))
            # hop 0 of a symmetric graph is symmetric: dx = A·dy
            err = max(err, max_err_within_tolerance(
                torch, dx, tbell.block_ell_spmm_plain(dy, *ops, *args)))
    return err


def time_shard_k1(torch, tbell, sg, d: int, F: int, gen, case: str = "kway") -> dict:
    """K1 on shard d's hop-0 plan: the op, the kernel alone, the plain
    version and ``torch.sparse.mm`` of the shard's hop-0 rows, in turns,
    beside K1's bound."""
    n, B, wp = sg.n_shard, sg.bell_block, sg.bell_wp
    ops = (sg.bell_senders[d], sg.bell_weights[d], sg.bell_out_senders[d],
           sg.bell_out_receivers[d], sg.bell_out_weights[d])
    width, o_pad = ops[0].shape[1], ops[2].shape[0]
    x = torch.randn(n, F, generator=gen, device="cuda")
    real = sg.edge_mask[d][0] > 0
    csr = csr_of(torch, sg.receivers[d][0][real], sg.senders[d][0][real],
                 sg.weights[d][0][real], n)
    with torch.no_grad():
        row = {"name": "K1", "case": f"{case} shard {d}", "n": n, "F": F, "block": B, "wp": wp,
               "width": width, "o_pad": o_pad, "n_outliers": int((ops[4] != 0).sum()),
               "dtype": "float32"}
        row.update(ms_in_turns(torch, {
            "ms": lambda: tbell.block_ell_spmm(x, *ops, n, B, wp),
            "kernel_only_ms": lambda: tbell._launch(x, ops[0], ops[1], n, B, wp),
            "plain_ms": lambda: tbell.block_ell_spmm_plain(x, *ops, n, B, wp),
            "library_ms": lambda: torch.sparse.mm(csr, x),
        }))
    bytes_ms = (2 * n * F * 4 + n * width * 8 + o_pad * (2 * F * 4 + 12)) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n * width * F / F32_OPS_PER_S * 1e3
    row["bound_ms"] = max(bytes_ms, ops_ms)
    row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"  K1 on shard {d}'s hop-0 plan n={n} F={F} B={B} Wp={wp} width={width} "
        f"o_pad={o_pad}: op {row['ms']:.4f} ms, kernel alone {row['kernel_only_ms']:.4f}, plain "
        f"{row['plain_ms']:.4f}, sparse.mm {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
        f"({row['bound_by']})")
    return row


def phase_kway(torch, np, tbell, make_mesh, micro, tpart, tgiant, kway_sweep, scaling,
               random_regular_edges) -> dict:
    """BASELINE config 4 on the node-sharded trainer: card against CPU, the
    sweep at full size, the 4-shard ring, K1 on the sharded path, scaling."""
    log("== kway")
    card = card_line()
    ring = make_mesh(devices=["cuda:0"] * KWAY_SHARDS)
    cpu_ring = make_mesh(devices=["cpu"] * KWAY_SHARDS)

    # 1. card against CPU on a 4-shard ring, the same numpy initial draw
    edges = random_regular_edges(4096, KWAY_D, seed=0)
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    small = tgiant.GiantConfig(number_epochs=20, log_every=1)
    runs = {}
    for name, mesh in (("card", ring), ("cpu", cpu_ring)):
        registry.reset()
        runs[name] = tgiant.train_giant_graph(src, dst, 4096, small, mesh=mesh,
                                              return_assignment=True)
        runs[name]["launches"] = launches_but_adam()
    agree = float((runs["card"]["assignment"] == runs["cpu"]["assignment"]).mean())
    log(f"  n=4096 k=3 on {KWAY_SHARDS} shards, card vs CPU ring: history "
        f"{runs['card']['loss_history']} vs {runs['cpu']['loss_history']}, assignments agree "
        f"on {agree:.6f}")
    torch.testing.assert_close(torch.tensor(runs["card"]["loss_history"]),
                               torch.tensor(runs["cpu"]["loss_history"]), rtol=1e-3, atol=0)
    check(agree >= 0.999, "small k-way run: card and CPU assignments agree")
    check(not any(runs["card"]["launches"].values()),
          "the expander's shards do not band: no hand-written kernel but Adam's runs")

    # 2. the sweep at full size on one card (one shard), then k = 3 on the ring
    registry.reset()
    one = make_mesh(devices=["cuda:0"])
    sweep = kway_sweep(n=KWAY_N, d=KWAY_D, ks=tuple(REFERENCE_KWAY), epochs=KWAY_EPOCHS,
                            mesh=one)
    sweep_launches = launches_but_adam()
    log(f"  n={KWAY_N} d={KWAY_D}, {KWAY_EPOCHS} epochs a k, 1 shard; card: {card}")
    log("  k | cut fraction | floor | margin (gate; JAX) | epoch ms | edges/s (amortized) | "
        "partition s | assembly s")
    for r in sweep:
        k = r["k"]
        r["margin_points"] = 100 * (r["cut_fraction"] - r["random_fraction"])
        r["gate_points"] = KWAY_GATE[k]
        r["reference_cut_percent"], r["reference_margin_points"] = REFERENCE_KWAY[k]
        log(f"  {k} | {r['cut_fraction']:.5f} | {r['random_fraction']:.5f} | "
            f"{r['margin_points']:+.2f} ({KWAY_GATE[k]:+.1f}; JAX {REFERENCE_KWAY[k][1]:+.1f}) | "
            f"{r['epoch_time_s_amortized'] * 1e3:.4f} | {r['edges_per_s']:.4g} "
            f"({r['edges_per_s_amortized']:.4g}) | {r['partition_s']:.4f} | {r['assembly_s']:.4f}")
        check(r["timing_reliable"], f"k={k}: the amortized epoch time is reliable")
        check(r["margin_points"] >= KWAY_GATE[k],
              f"k={k}: margin {r['margin_points']:.2f} points >= half of PARITY.md's")
    check(not any(sweep_launches.values()), "the sweep's expander runs the gather tables only")
    registry.reset()
    (ring3,) = kway_sweep(n=KWAY_N, d=KWAY_D, ks=(3,), epochs=KWAY_EPOCHS, mesh=ring)
    ring3["margin_points"] = 100 * (ring3["cut_fraction"] - ring3["random_fraction"])
    log(f"  k=3 on a {KWAY_SHARDS}-shard virtual ring (one card): cut fraction "
        f"{ring3['cut_fraction']:.5f}, margin {ring3['margin_points']:+.2f}, epoch "
        f"{ring3['epoch_time_s_amortized'] * 1e3:.4f} ms, {ring3['edges_per_s_amortized']:.4g} "
        f"edges/s amortized, assembly {ring3['assembly_s']:.4f} s; card: {card}")
    check(ring3["cut_fraction"] > ring3["random_fraction"], "4-shard ring k=3 above its floor")
    check(not any(launches_but_adam().values()), "the ring's expander runs no kernel but Adam's")

    # 3. K1 on the sharded path: the banded-random graph in 4 contiguous
    # shards, each banded after its RCM, hop 0 on K1
    e = micro.banded_random_edges(KWAY_N, KWAY_D, 255, 0)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    cfg = tgiant.GiantConfig(number_epochs=KWAY_EPOCHS, block_ell=True, local_reorder="rcm")
    registry.reset()
    banded = tgiant.train_giant_graph(src, dst, KWAY_N, cfg, mesh=ring, return_assignment=True)
    k1_launches = launches_but_adam()
    asn = banded["assignment"]
    decoded = float(np.sum(asn[e[:, 0]] != asn[e[:, 1]])) / e.shape[0]
    log(f"  banded-random n={KWAY_N} on {KWAY_SHARDS} shards (n_shard {banded['n_shard']}), "
        f"hop 0 on K1: {banded['epochs']} epochs, {banded['edges_per_s']:.4g} edges/s, cut "
        f"fraction {banded['final_cut'] / banded['total_edges']:.5f} (decoded {decoded:.5f}), "
        f"assembly {banded['assembly_s']:.3f} s; card: {card}; launches {k1_launches}")
    check(banded["block_ell"], "every shard got a hop-0 plan")
    # each shard: hop 0 of conv1, conv2 and the loss's A·S, forward and
    # backward, every epoch; conv1 and conv2 forward in the decode
    check(k1_launches["block_ell_spmm"] == KWAY_SHARDS * (6 * KWAY_EPOCHS + 2),
          "K1 launched 6 times an epoch on each shard, plus 2 each for the decode")
    check(all(v == 0 for k, v in k1_launches.items() if k != "block_ell_spmm"),
          "no banded, halo or probe kernel runs on the sharded path")
    check(banded["final_cut"] / banded["total_edges"] > 2 / 3 and decoded > 2 / 3,
          "the banded sharded run beats the 2/3 floor")
    sg, _ = tpart.shard_graph(src, dst, KWAY_N, KWAY_SHARDS, local_reorder="rcm",
                              block_ell=True)
    sg = sg.to(ring)
    check(sg.bell_senders is not None and len(sg.bell_senders) == KWAY_SHARDS,
          "a plan on each of the 4 shards")
    gen = torch.Generator(device="cuda").manual_seed(3)
    err = check_shard_k1(torch, tbell, sg, 0, gen)
    log(f"  K1 on shard 0's plan (F = 64 and 3), forward and gradient against the plain "
        f"version: max |err| {err:.3g}")
    timings = [time_shard_k1(torch, tbell, sg, 0, F, gen) for F in (64, 3)]
    log(f"  (K1 times on {card})")

    # 4. bench --what scaling at its defaults (D = 1 on one card), then the
    # sharded conv on the virtual ring
    registry.reset()
    scale = scaling.scaling_sweep(n=KWAY_N, d=KWAY_D, feature_dim=128)
    scale.append(scaling.bench_sharded_conv(KWAY_N, KWAY_D, 128, 128,
                                            devices=["cuda:0"] * KWAY_SHARDS))
    for r in scale:
        label = "virtual ring, one card" if r["virtual_ring"] else "scaling point"
        log(f"  sharded conv n={r['n']} F=128 D={r['num_devices']} ({label}): fwd "
            f"{r['fwd_edges_per_s']:.4g} edges/s ({r['fwd_time_s'] * 1e3:.4f} ms), fwd+bwd "
            f"{r['fwdbwd_edges_per_s']:.4g} ({r['fwdbwd_time_s'] * 1e3:.4f} ms); card: {card}")
    check([r["num_devices"] for r in scale[:-1]] == [1] and scale[-1]["virtual_ring"],
          "one scaling point on one card, and the virtual ring")
    torch.cuda.empty_cache()
    for r in runs.values():
        r.pop("assignment")
    banded.pop("assignment")
    return {"card_vs_cpu": {**runs, "agreement": agree}, "sweep": sweep, "ring_k3": ring3,
            "banded": {**banded, "decoded_cut_fraction": decoded, "launches": k1_launches},
            "k1_max_abs_err": err, "k1_timings": timings, "scaling": scale, "card": card}


def hybrid_state(np, tgiant, thybrid, locality_params, sgb, mesh, cfg, embed=None):
    """The hybrid trainer's state for ``sgb`` on ``mesh``: conv parameters
    and embedding drawn as ``train_hybrid`` draws them, or ``embed``."""
    rows = thybrid._rows_of(sgb, mesh, "data", "graph")
    n_shard, blocks = sgb[0].n_shard, len(sgb) * rows[0].size
    params = locality_params(blocks * n_shard, cfg.dim_embedding, cfg.hidden_dim,
                             cfg.num_classes, cfg.seed)
    params["embed"] = (params["embed"] if embed is None else embed).reshape(
        blocks, n_shard, cfg.dim_embedding)
    return tgiant.GiantState.from_blocks(params, [d for r in rows for d in r.devices],
                                         cfg.learning_rate)


def step_ms(torch, step, epochs: int = 20) -> float:
    """ms an epoch of ``step`` on the card: CUDA events around ``epochs``
    calls after one warm-up call."""
    step()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(epochs):
        step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / epochs


def cli_json(cli_main, argv: list) -> dict:
    """Run a ``bench`` command and parse the JSON of its last output line."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        check(cli_main(argv) == 0, f"{' '.join(argv)} ran")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def phase_hybrid(torch, np, tbell, make_mesh, micro, tpart, tgiant, thybrid,
                 locality_params, random_regular_edges, cli_main) -> dict:
    """The hybrid data × graph trainer on 2 × 4 meshes of one card: against
    a CPU mesh, a duplicated graph against the giant trainer, two
    banded-random graphs at full width with hop 0 on K1, K1 against its
    plain version on a hybrid shard's plan, ``bench --what hybrid``."""
    log("== hybrid")
    card = card_line()
    R, D = HYBRID_SHAPE
    mesh = make_mesh(("data", "graph"), shape=(R, D), devices=["cuda:0"] * (R * D))
    cpu_mesh = make_mesh(("data", "graph"), shape=(R, D), devices=["cpu"] * (R * D))

    # 1. card against CPU: two regular graphs, one numpy draw (config.seed)
    lists = []
    for seed in (1, 2):
        e = random_regular_edges(HYBRID_SMALL_N, 8, seed=seed)
        lists.append((np.concatenate([e[:, 0], e[:, 1]]), np.concatenate([e[:, 1], e[:, 0]])))
    small = tgiant.GiantConfig(number_epochs=20, log_every=1)
    runs = {}
    for name, m in (("card", mesh), ("cpu", cpu_mesh)):
        registry.reset()
        runs[name] = thybrid.train_hybrid(lists, HYBRID_SMALL_N, small, mesh=m)
        runs[name]["launches"] = launches_but_adam()
    log(f"  n={HYBRID_SMALL_N} d=8, 2 graphs on {R} x {D}, card vs CPU: history "
        f"{runs['card']['loss_history']} vs {runs['cpu']['loss_history']}; cuts "
        f"{runs['card']['per_graph_cuts']} vs {runs['cpu']['per_graph_cuts']}")
    # float sums in another order on the card can flip a node's class in
    # a late epoch (one edge of 10,435 in a run): the cuts are held to the
    # history's tolerance
    for key in ("loss_history", "per_graph_cuts"):
        torch.testing.assert_close(torch.tensor(runs["card"][key]),
                                   torch.tensor(runs["cpu"][key]), rtol=1e-3, atol=0)
    check(not any(runs["card"]["launches"].values()),
          "the expanders run no hand-written kernel but Adam's")

    # 2. one graph twice, equal embeddings: tracks the giant trainer on a ring
    s, r = lists[0]
    sg = tpart.shard_graph(s, r, HYBRID_SMALL_N, D)[0]
    ring = make_mesh(devices=["cuda:0"] * D)
    dup_cfg = tgiant.GiantConfig(learning_rate=1e-2)
    rng = np.random.default_rng(5)
    embed = rng.standard_normal((D, sg.n_shard, dup_cfg.dim_embedding)).astype(np.float32)
    gstate = hybrid_state(np, tgiant, thybrid, locality_params, (sg,),
                          make_mesh(("data", "graph"), shape=(1, D), devices=["cuda:0"] * D),
                          dup_cfg, embed)
    sgb = thybrid.stack_sharded_graphs([sg, sg])
    hstate = hybrid_state(np, tgiant, thybrid, locality_params, sgb, mesh, dup_cfg,
                          np.stack([embed, embed]))
    step = thybrid.make_hybrid_step(sgb, mesh, dup_cfg, hstate)
    sg_ring = sg.to(ring)
    g_loss, h_loss = [], []
    for _ in range(HYBRID_DUP_EPOCHS):
        g_loss.append(float(tgiant._epoch(gstate, sg_ring, ring, dup_cfg)))
        mean, per_graph = step()
        h_loss.append(float(mean[0]))
        check(per_graph[0].item() == per_graph[1].item(), "both copies have one loss")
    copies = [torch.stack([e.detach() for e in hstate.embeds[i * D:(i + 1) * D]]) for i in (0, 1)]
    conv_err = max(float((a.detach() - b.detach()).abs().max())
                   for a, b in zip(hstate.leaves()[:4], gstate.leaves()[:4]))
    embed_err = float((copies[0] - torch.stack([e.detach() for e in gstate.embeds])).abs().max())
    log(f"  one graph twice on {R} x {D} vs the giant trainer on {D} shards, "
        f"{HYBRID_DUP_EPOCHS} epochs: losses {h_loss} vs {g_loss}; max |conv diff| "
        f"{conv_err:.3g}, max |embedding diff| {embed_err:.3g}")
    torch.testing.assert_close(torch.tensor(h_loss), torch.tensor(g_loss), rtol=1e-5, atol=0)
    for a, b in zip(hstate.leaves()[:4], gstate.leaves()[:4]):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(copies[0], torch.stack([e.detach() for e in gstate.embeds]),
                               rtol=1e-5, atol=1e-5)
    check(torch.equal(copies[0], copies[1]), "both embedding copies equal")

    # 3. full width: two banded-random graphs, hop 0 on K1 (per-shard RCM)
    full = tgiant.GiantConfig(number_epochs=HYBRID_EPOCHS, block_ell=True, local_reorder="rcm")
    edges, lists = [], []
    for seed in (0, 1):
        e = micro.banded_random_edges(KWAY_N, KWAY_D, 255, seed)
        edges.append(e)
        lists.append((np.concatenate([e[:, 0], e[:, 1]]), np.concatenate([e[:, 1], e[:, 0]])))
    registry.reset()
    res = thybrid.train_hybrid(lists, KWAY_N, full, mesh=mesh)
    launches = launches_but_adam()
    fractions = [c / e.shape[0] for c, e in zip(res["per_graph_cuts"], edges)]
    sgb = thybrid.stack_sharded_graphs([
        tpart.shard_graph(s, r, KWAY_N, D, local_reorder="rcm", block_ell=True)[0]
        for s, r in lists])
    check(all(sg.bell_senders is not None and len(sg.bell_senders) == D for sg in sgb),
          "a hop-0 plan on every shard of both graphs")
    timed = hybrid_state(np, tgiant, thybrid, locality_params, sgb, mesh, full)
    epoch_ms = step_ms(torch, thybrid.make_hybrid_step(sgb, mesh, full, timed))
    log(f"  banded-random n={KWAY_N} d={KWAY_D}, 2 graphs on {R} x {D} (n_shard "
        f"{sgb[0].n_shard}), hop 0 on K1: {res['epochs']} epochs in {res['train_time_s']:.3f} s "
        f"({res['train_time_s'] / res['epochs'] * 1e3:.3f} ms an epoch, host clock); "
        f"{epoch_ms:.3f} ms an epoch (CUDA events, 20 epochs); cut fractions "
        f"{[round(f, 5) for f in fractions]}; card: {card}; launches {launches}")
    # each graph's shards: hop 0 of conv1, conv2 and the loss's A·S,
    # forward and backward, every epoch; train_hybrid decodes nothing
    check(launches["block_ell_spmm"] == R * D * 6 * HYBRID_EPOCHS,
          "K1 launched 6 times an epoch on each shard of each graph")
    check(all(v == 0 for k, v in launches.items() if k != "block_ell_spmm"),
          "no banded, halo or probe kernel runs on the hybrid path")
    check(all(f > 2 / 3 for f in fractions), "both per-graph cuts beat the 2/3 floor")

    # 4. K1 on a hybrid shard's plan against its plain version, and timed
    sg = sgb[1].to(mesh.row(1))
    gen = torch.Generator(device="cuda").manual_seed(4)
    err = check_shard_k1(torch, tbell, sg, 0, gen)
    log(f"  K1 on graph 1's shard 0 plan (F = 64 and 3), forward and gradient against the "
        f"plain version: max |err| {err:.3g}")
    timings = [time_shard_k1(torch, tbell, sg, 0, F, gen, "hybrid graph 1") for F in (64, 3)]

    # 5. bench --what hybrid on the card's device count
    bench = cli_json(cli_main, ["bench", "--what", "hybrid", "--device", "cuda"])["hybrid"]
    log(f"  bench --what hybrid: mesh {bench['mesh_shape']}, {bench['epochs']} epochs in "
        f"{bench['train_time_s']:.3f} s, cuts {bench['per_graph_cuts']}; card: {card}")
    check(bench["num_graphs"] == bench["mesh_shape"][0] and all(
        math.isfinite(c) and c > 0 for c in bench["per_graph_cuts"]), "bench --what hybrid")
    torch.cuda.empty_cache()
    return {"card_vs_cpu": runs, "duplicated": {"hybrid": h_loss, "giant": g_loss,
                                                "conv_max_abs_diff": conv_err,
                                                "embed_max_abs_diff": embed_err},
            "banded": {**res, "launches": launches, "cut_fractions": fractions,
                       "epoch_ms_events": epoch_ms, "n_shard": sgb[0].n_shard},
            "k1_max_abs_err": err, "k1_timings": timings, "bench": bench, "card": card}


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_dp(torch, np, make_mesh, tdp, tloop, tgiant, thybrid, tpart,
             locality_params, random_regular_edges, variants: dict) -> dict:
    """Data-parallel recipe training on a data mesh of 4 entries of one
    card: against the CPU, the recipe's data at full width with the default
    decode against the randomized baseline, and NCCL's all_reduce path on a
    world of one against the runs without a process group."""
    import torch.distributed as dist

    from gcn_maxcut_tpu_torch.baselines.randomized import randomized_k_way_maxcut
    from gcn_maxcut_tpu_torch.core.graph import pad_graph_batch
    from gcn_maxcut_tpu_torch.data.generate import generate_graph_dataset
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
    from gcn_maxcut_tpu_torch.eval import harness
    from gcn_maxcut_tpu_torch.parallel.mesh import multi_host_init
    from gcn_maxcut_tpu_torch.train.config import TrainingConfig

    log("== dp")
    card = card_line()
    mesh = make_mesh(("data",), devices=["cuda:0"] * DP_ENTRIES)

    def dp_run(batch, cfg, m, epochs, start, dev, times=None):
        state = tloop.setup_train_state(cfg, params=start, device=dev)
        fn = tdp.make_dp_epoch_fn(cfg, state.optimizer, m)
        shards = tdp.shard_batch_for_dp(batch, m)
        losses = []
        for _ in range(epochs):
            losses.append(fn(state, shards))       # a host read: each epoch ends synchronised
            if times is not None:
                times.append(time.perf_counter())
        return losses, state

    # 1. card against CPU at n_pad 64, one start
    specs, _ = generate_graph_dataset(8, 40, 56, 3, 6, base_seed=21)
    ds = process_graphs(specs, DataConfig(max_nodes=64))
    small_batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])
    small = TrainingConfig(n_nodes=64, learning_rate=5e-3)
    start = tloop.setup_train_state(small, device="cpu").params()
    hist = {}
    for name, m, dev in (("card", mesh, "cuda"),
                         ("cpu", make_mesh(("data",), devices=["cpu"] * DP_ENTRIES), "cpu")):
        hist[name] = dp_run(small_batch, small, m, 10, start, dev)[0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(hist["card"], hist["cpu"]))
    log(f"  n_pad 64, {DP_ENTRIES} entries, card vs CPU: {hist['card']} vs {hist['cpu']} "
        f"(largest relative difference {rel:.3g})")
    torch.testing.assert_close(torch.tensor(hist["card"]), torch.tensor(hist["cpu"]),
                               rtol=1e-4, atol=0)

    # 2. the recipe's data at full width, 300 epochs, then the default decode
    specs, _ = generate_graph_dataset(20, 500, 500, 6, 8, base_seed=1000)
    ds = process_graphs(specs, DataConfig(max_nodes=1000))
    batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])
    cfg = TrainingConfig(n_nodes=1000, learning_rate=1e-3, seed=1000)
    times = []
    registry.reset()
    losses, state = dp_run(batch, cfg, mesh, RECIPE_EPOCHS, None, "cuda", times)
    launches = launches_but_adam()
    epoch_ms = _epoch_ms(times)
    log(f"  recipe data (20 graphs n=500, 1000-wide), {DP_ENTRIES} entries of one card: "
        f"{RECIPE_EPOCHS} epochs, {epoch_ms:.3f} ms an epoch (variants phase, same run: "
        f"batched + cosine {variants['batched']['epoch_ms']:.3f}, per_graph "
        f"{variants['per_graph']['epoch_ms']:.3f}); loss {losses[0]:.1f} -> {losses[-1]:.1f} "
        f"(best {min(losses):.1f}); card: {card}")
    check(all(map(math.isfinite, losses)), "finite DP loss history")
    check(losses[-1] < losses[0] and min(losses) < losses[0], "DP training improves the loss")
    check(not any(launches_but_sddmm(launches, "DP on the recipe").values()),
          "DP on the recipe runs no hand-written kernel but Adam's and the loss's SDDMM")
    test_specs, _ = generate_graph_dataset(5, 500, 500, 6, 8, base_seed=1000 + 5000)
    tds = process_graphs(test_specs, DataConfig(max_nodes=1000))
    results, _ = harness.test_multiple_graphs(state.params(), tds, [500],
                                              post_processing_iterations=200,
                                              verbose=False, refine=True)
    rand = [randomized_k_way_maxcut(tds.graphs[k].to("cuda"), 3, 10_000, seed=k)[1]
            for k in sorted(tds.graphs)]
    refined = sum(r["refined_cut"] for r in results) / len(results)
    randomized = sum(rand) / len(rand)
    log(f"  held-out (5 graphs): simple {sum(r['simple_cut'] for r in results) / 5:.2f}, "
        f"refined {refined:.2f}, randomized 10k {randomized:.2f}")
    check(len(results) == 5 and refined > randomized,
          "the default decode after DP training beats the 10k randomized baseline")

    # 3. NCCL on a world of one: one DP epoch and one hybrid epoch through the
    # all_reduce path, bit for bit against the same epochs without a group
    e = random_regular_edges(HYBRID_SMALL_N, 8, seed=1)
    sg = tpart.shard_graph(np.concatenate([e[:, 0], e[:, 1]]),
                           np.concatenate([e[:, 1], e[:, 0]]), HYBRID_SMALL_N, 4)[0]
    sgb = thybrid.stack_sharded_graphs([sg, sg])
    hmesh = make_mesh(("data", "graph"), shape=(2, 4), devices=["cuda:0"] * 8)
    hcfg = tgiant.GiantConfig(epochs_per_call=3)

    def one_epoch_each():
        # the hybrid chunk of 3: an eager epoch, then two replays of the
        # captured epoch, its all_reduce inside the graph
        losses, st = dp_run(small_batch, small, mesh, 1, start, "cuda")
        hstate = hybrid_state(np, tgiant, thybrid, locality_params, sgb, hmesh, hcfg)
        step = thybrid.make_hybrid_step(sgb, hmesh, hcfg, hstate)
        mean, per_graph = step()
        check(step.runner.replays == 2, "the hybrid chunk replayed its captured epoch")
        return ([torch.tensor(losses), *[p.detach().cpu() for p in st.optimizer.params],
                 torch.from_numpy(mean), per_graph.cpu(),
                 *[p.detach().cpu() for p in hstate.leaves()]])

    plain = one_epoch_each()
    port = free_port()
    multi_host_init(f"127.0.0.1:{port}", 1, 0)
    try:
        check(dist.is_initialized() and dist.get_backend() == "nccl", "an NCCL group of one")
        grouped = one_epoch_each()
    finally:
        dist.destroy_process_group()
    check(len(grouped) == len(plain) and all(torch.equal(a, b) for a, b in zip(plain, grouped)),
          "NCCL's all_reduce path on a world of one equals the run without a group, bit for bit")
    log(f"  NCCL world of one (127.0.0.1:{port}): one DP epoch and a captured hybrid chunk of "
        f"3 epochs bit-equal to the runs without a group ({len(plain)} tensors)")
    return {"card_vs_cpu_max_rel_diff": rel, "epoch_ms": epoch_ms, "epochs": RECIPE_EPOCHS,
            "first_loss": losses[0], "final_loss": losses[-1], "best_loss": min(losses),
            "launches": launches, "held_out": {"refined": refined, "randomized_10k": randomized},
            "nccl_world_of_one_bit_equal": True, "card": card}


def epochs_ms(torch, run, K: int, epochs: int) -> float:
    """ms an epoch of the chunk callable ``run`` (k epochs a call, each
    chunk ending in its host read): CUDA events around epochs // K chunks."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(epochs // K):
        run(K)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (epochs // K * K)


# launch counter -> the device function its wrapper launches, once a call
DEVICE_KERNEL = {
    "block_ell_spmm": "block_ell_gather_kernel",
    "banded_spmm_unit": "halo_stream_kernel",
    "banded_spmm_unit_packed": "halo_stream_kernel",
    "halo_banded_spmm": "halo_stream_kernel",
    "halo_banded_spmm_unit_packed": "halo_stream_kernel",
    "banded_spmm_unit_window": "banded_window_kernel",
    "halo_banded_spmm_window": "banded_window_kernel",
    "adam_update": "adam_kernel",
    "adam_count": "adam_count_kernel",
    "climb": "climb_kernel",
    "sddmm": "sddmm_forward_kernel",
    "sddmm_backward": "sddmm_backward_kernel",
}


def traced_launches(torch, what: str, fn):
    """``fn()`` under ``torch.profiler``; returns the trace and each
    hand-written kernel's launches in it, the device's own count, beside
    what the launch counters gained over the same call (a replay's as the
    launches seen in capture times the replays).  Fails unless they agree."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    registry.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counted = {}
    for name, v in registry.LAUNCHES.items():
        if v:
            check(name in DEVICE_KERNEL, f"{what}: {name}'s device function is known")
            counted[DEVICE_KERNEL[name]] = counted.get(DEVICE_KERNEL[name], 0) + v
    traced = dict.fromkeys(set(DEVICE_KERNEL.values()), 0)
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            for sym in traced:
                if sym in e.key:
                    traced[sym] += e.count
    traced = {k: v for k, v in traced.items() if v}
    log(f"  {what}: launches traced on the device {traced}, counted {counted}")
    check(traced == counted, f"{what}: the counted launches equal the traced ones")
    return prof, {"traced": traced, "counted": counted}


def busy_share(torch, what: str, run, K: int, epochs: int) -> dict:
    """The device's busy share over epochs // K chunks: the device time of
    the kernels and copies ``torch.profiler`` traces, over the host-clock
    wall time of the same chunks run without the profiler (one stream, so
    device events do not overlap).  None where the trace has no device
    time.  The traced chunks' kernel launches are held against the counters
    (``traced_launches``)."""
    def device_us(evt) -> float:
        if not str(evt.device_type).endswith("CUDA"):
            return 0.0
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, name):
                return float(getattr(evt, name))
        return 0.0

    def chunks():
        for _ in range(epochs // K):
            run(K)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunks()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof, launches = traced_launches(torch, what, chunks)
    dev = sum(device_us(e) for e in prof.key_averages())
    ms = wall * 1e3 / (epochs // K * K)
    return {"busy_share": dev / 1e6 / wall if dev > 0 else None, "wall_ms_per_epoch": ms,
            "device_ms_per_epoch": dev / 1e3 / (epochs // K * K), "launches": launches}


class eager_chunks:
    """Inside the context, ``module.ChunkRunner`` runs its chunks without
    capture: the trainers' eager epochs, for the comparison on the card."""

    def __init__(self, module, on: bool = True):
        self.module, self.on = module, on

    def __enter__(self):
        import functools

        self.orig = self.module.ChunkRunner
        if self.on:
            self.module.ChunkRunner = functools.partial(self.orig, capture=False)

    def __exit__(self, *exc):
        self.module.ChunkRunner = self.orig


RUNS = (("k1", 1, None), ("k10", CHUNK_K, None), ("eager", CHUNK_K, False))


def chunk_runs(torch, np, make_run) -> dict:
    """``make_run(K, capture)`` -> a chunk callable (k -> the k losses) on a
    fresh state from one start.  For K = 1, K = 10 and K = 10 eager: the
    first CHUNK_EPOCHS losses and the launches they made, then the ms an
    epoch of CHUNK_TIMED more (CUDA events)."""
    out = {}
    for name, K, capture in RUNS:
        run = make_run(K, capture)
        registry.reset()
        hist = np.concatenate([run(K) for _ in range(CHUNK_EPOCHS // K)])
        out[name] = {"history": [float(v) for v in hist], "launches": launches_but_adam(),
                     "epoch_ms": epochs_ms(torch, run, K, CHUNK_TIMED),
                     "replays": getattr(getattr(run, "runner", None), "replays", None)}
        del run
        torch.cuda.empty_cache()
    return out


def trainer_runs(torch, module, call) -> dict:
    """``call(K)`` -> a trainer's result (``history``, ``epoch_time_s``: its
    steady chunks on CUDA events) for K = 1, K = 10 and K = 10 with
    ``module``'s chunks run eagerly."""
    out = {}
    for name, K, capture in RUNS:
        with eager_chunks(module, capture is False):
            registry.reset()
            res = call(K)
        out[name] = {"history": [float(v) for v in res["history"]],
                     "launches": launches_but_adam(), "epochs": res["epochs"],
                     "epoch_ms": res["epoch_time_s"] * 1e3}
        torch.cuda.empty_cache()
    return out


def held_equal(name: str, runs: dict, per_epoch: dict, exact: bool, rtol: float = 1e-3) -> dict:
    """K = 10 (and the eager run) against K = 1: the histories bit for bit
    where ``exact``, else within ``rtol``; each run's launches exactly
    ``per_epoch`` (kernel -> launches an epoch) times its epochs, and no
    other kernel."""
    ref = runs["k1"]["history"]
    same = {k: r["history"] == ref for k, r in runs.items()}
    rel = {k: max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(r["history"], ref))
           for k, r in runs.items()}
    log(f"  {name}: epoch ms K=1 {runs['k1']['epoch_ms']:.3f}, K={CHUNK_K} "
        f"{runs['k10']['epoch_ms']:.3f}, eager {runs['eager']['epoch_ms']:.3f}; histories equal "
        f"to K=1 {same} (largest relative difference {rel}); launches "
        f"{ {k: {n: v for n, v in r['launches'].items() if v} for k, r in runs.items()} }")
    for k, r in runs.items():
        check(len(r["history"]) == len(ref), f"{name}: {k} ran {len(ref)} epochs")
        if exact:
            check(same[k], f"{name}: {k}'s history equals K=1's bit for bit")
        else:
            check(rel[k] <= rtol, f"{name}: {k}'s history within rtol {rtol} of K=1's")
        epochs = len(r["history"])
        check(all(r["launches"].get(n, 0) == v * epochs for n, v in per_epoch.items())
              and all(v == 0 for n, v in r["launches"].items() if n not in per_epoch),
              f"{name}: {k}'s launches exactly {per_epoch} an epoch, no other kernel")
    return {k: {kk: vv for kk, vv in r.items() if kk != "history"} | {
        "history_equal_to_k1": same[k], "max_rel_diff_to_k1": rel[k]} for k, r in runs.items()}


def phase_chunks(torch, np, giant, tgiant, tgb, thybrid, tpart, make_mesh, micro,
                 locality_params, random_regular_edges) -> dict:
    """``epochs_per_call`` on the card: each chunked path at K = 1 and at
    K = 10 (and eagerly) from one start, held equal, launches counted
    exactly (captured launches times replays plus the eager epoch's), the
    epoch ms of each, and the busy share of the recipe and the k-way ring."""
    from gcn_maxcut_tpu_torch.core.graph import pad_graph_batch
    from gcn_maxcut_tpu_torch.data.generate import generate_graph_dataset
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
    from gcn_maxcut_tpu_torch.train import chunks as tchunks
    from gcn_maxcut_tpu_torch.train import loop as tloop
    from gcn_maxcut_tpu_torch.train.chunks import ChunkRunner
    from gcn_maxcut_tpu_torch.train.config import TrainingConfig

    log("== chunks")
    card = card_line()
    out = {"card": card}
    t0 = time.perf_counter()

    # 1. the recipe: 20 graphs n = 500 padded to 1000, GCNSoftmax 1000-500-3, per_graph
    specs, _ = generate_graph_dataset(20, 500, 500, 6, 8, base_seed=1000)
    ds = process_graphs(specs, DataConfig(max_nodes=1000))
    batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])
    cfg = TrainingConfig(n_nodes=1000, learning_rate=1e-3, seed=1000,
                         number_epochs=CHUNK_EPOCHS)
    start = tloop.setup_train_state(cfg, 20, device="cpu").params()
    recipe = {}
    for name, kw in (("full", {}), ("stop", dict(patience=CHUNK_STOP_PATIENCE, tolerance=1e9))):
        res = {}
        for K in (1, CHUNK_K):
            c = TrainingConfig(**{**dataclasses.asdict(cfg), **kw, "epochs_per_call": K})
            res[K] = tloop.train_model(batch, c, state=tloop.setup_train_state(
                c, 20, params=start, device="cuda"))
        a, b = res[1], res[CHUNK_K]
        same = (a[4] == b[4] and a[1] == b[1] and a[2] == b[2]
                and all(torch.equal(a[0][k][n], b[0][k][n])
                        for k in ("conv1", "conv2") for n in ("w", "b")))
        log(f"  recipe {name}: K=1 and K={CHUNK_K} ran {len(a[4])} and {len(b[4])} epochs "
            f"(final epoch {a[2]}, {b[2]}), best loss {a[1]:.1f}, {b[1]:.1f}; history, best "
            f"loss and best parameters equal: {same}")
        check(same, f"recipe {name}: K={CHUNK_K} equals K=1 bit for bit")
        recipe[name] = {"final_epoch": a[2], "best_loss": a[1], "epochs": len(a[4])}
    check(recipe["stop"]["final_epoch"] == CHUNK_STOP_PATIENCE,
          "the stopping run stops inside the first chunk")

    def recipe_run(K, capture):
        state = tloop.setup_train_state(cfg, 20, params=start, device="cuda")
        es = tloop.init_early_stop_state(state.params())
        gen = torch.Generator(device="cuda").manual_seed(cfg.seed + 1)
        runner = ChunkRunner(tloop.make_monitored_epoch_fn(
            state, tloop.epoch_inputs(batch.to("cuda"), cfg), es, gen), ["cuda"], K, capture)

        def run(k):
            return runner.run(k)[0]

        run.runner = runner
        return run

    runs = chunk_runs(torch, np, recipe_run)
    out["recipe"] = held_equal("recipe (per_graph, 20 graphs, 1000-wide)", runs,
                               {"sddmm": 20, "sddmm_backward": 20}, True)
    busy = {}
    for name, K, capture in RUNS[1:]:
        run = recipe_run(K, capture)
        run(K)
        busy[name] = busy_share(torch, f"recipe {name}", run, K, CHUNK_K)
    log(f"  recipe busy share: {busy}")
    out["recipe"] = {**out["recipe"], "runs": recipe, "busy": busy}

    # 2. the single-chip giant trainers: packed (K3) and plain (K2)
    runs = trainer_runs(torch, tchunks, lambda K: giant.train_banded_giant_packed(
        epochs=CHUNK_EPOCHS, epochs_per_call=K, device="cuda"))
    out["giant_packed"] = held_equal(f"packed giant n={GIANT_N}", runs,
                                     {"banded_spmm_unit_packed": 6}, True)
    out["giant_packed"]["traced_launches"] = traced_launches(
        torch, f"packed giant K={CHUNK_K}", lambda: giant.train_banded_giant_packed(
            epochs=CHUNK_EPOCHS, epochs_per_call=CHUNK_K, device="cuda"))[1]
    runs = trainer_runs(torch, tchunks, lambda K: giant.train_banded_giant(
        n=PLAIN_N, epochs=CHUNK_EPOCHS, epochs_per_call=K, device="cuda"))
    out["giant_plain"] = held_equal(f"plain giant n={PLAIN_N}", runs,
                                    {"banded_spmm_unit": 2, "banded_spmm_unit_window": 4}, True)

    # 3. the halo trainers on a 4-shard ring of the card (K6; K5)
    ring = make_mesh(devices=["cuda:0"] * HALO_SHARDS)
    runs = trainer_runs(torch, tchunks, lambda K: tgb.train_halo_giant_packed(
        HALO_PACKED_SHARD, tgb.PackedHaloGiantConfig(epochs=CHUNK_EPOCHS, epochs_per_call=K),
        ring))
    out["halo_packed"] = held_equal(f"packed halo, {HALO_SHARDS} shards", runs,
                                    {"halo_banded_spmm_unit_packed": 6 * HALO_SHARDS}, True)
    runs = trainer_runs(torch, tchunks, lambda K: tgb.train_halo_giant(
        HALO_PLAIN_SHARD, tgb.HaloGiantConfig(epochs=CHUNK_EPOCHS, epochs_per_call=K), ring))
    out["halo_plain"] = held_equal(f"plain halo, {HALO_SHARDS} shards", runs,
                                   {"halo_banded_spmm": 4 * HALO_SHARDS,
                                    "halo_banded_spmm_window": 2 * HALO_SHARDS}, True)

    # 4. the k-way trainer: config 4's banded-random graph on a 4-shard ring,
    #    hop 0 on K1, and the sweep's expander on one shard
    def giant_path(sg, mesh, base):
        def make(K, capture):
            params = locality_params(mesh.size * sg.n_shard, base.dim_embedding,
                                     base.hidden_dim, base.num_classes, base.seed)
            params["embed"] = params["embed"].reshape(mesh.size, sg.n_shard, -1)
            state = tgiant.GiantState.create(params, mesh, base.learning_rate)
            with eager_chunks(tchunks, capture is False):
                return tgiant.make_giant_step(
                    sg, mesh, dataclasses.replace(base, epochs_per_call=K), state)
        return make

    e = micro.banded_random_edges(KWAY_N, KWAY_D, 255, 0)
    src, dst = np.concatenate([e[:, 0], e[:, 1]]), np.concatenate([e[:, 1], e[:, 0]])
    kring = make_mesh(devices=["cuda:0"] * KWAY_SHARDS)
    sg = tpart.shard_graph(src, dst, KWAY_N, KWAY_SHARDS, local_reorder="rcm",
                           block_ell=True)[0].to(kring)
    check(sg.bell_senders is not None, "a hop-0 plan on every shard of the k-way ring")
    base = tgiant.GiantConfig(block_ell=True, local_reorder="rcm")
    make = giant_path(sg, kring, base)
    runs = chunk_runs(torch, np, make)
    # K1 sums its outliers with index_add_ (atomic float adds): no bit equality
    out["kway_ring"] = held_equal(f"k-way ring, banded-random n={KWAY_N}, {KWAY_SHARDS} shards, "
                                  "hop 0 on K1", runs, {"block_ell_spmm": 6 * KWAY_SHARDS}, False)
    busy = {}
    for name, K, capture in RUNS[1:]:
        run = make(K, capture)
        run(K)
        busy[name] = busy_share(torch, f"k-way ring {name}", run, K, CHUNK_K)
    log(f"  k-way ring busy share: {busy}")
    out["kway_ring"]["busy"] = busy
    e = random_regular_edges(KWAY_N, KWAY_D, seed=0)
    one = make_mesh(devices=["cuda:0"])
    sg = tpart.shard_graph(np.concatenate([e[:, 0], e[:, 1]]),
                           np.concatenate([e[:, 1], e[:, 0]]), KWAY_N, 1)[0].to(one)
    runs = chunk_runs(torch, np, giant_path(sg, one, tgiant.GiantConfig()))
    out["kway_one_shard"] = held_equal(f"k-way, expander n={KWAY_N}, one shard", runs, {}, True)

    # 5. the hybrid trainer: two banded-random graphs on a 2 x 4 mesh, hop 0 on K1
    R, D = HYBRID_SHAPE
    mesh = make_mesh(("data", "graph"), shape=HYBRID_SHAPE, devices=["cuda:0"] * (R * D))
    lists = []
    for seed in (0, 1):
        e = micro.banded_random_edges(KWAY_N, KWAY_D, 255, seed)
        lists.append((np.concatenate([e[:, 0], e[:, 1]]), np.concatenate([e[:, 1], e[:, 0]])))
    sgb = thybrid.stack_sharded_graphs([
        tpart.shard_graph(s, r, KWAY_N, D, local_reorder="rcm", block_ell=True)[0]
        for s, r in lists])

    def hybrid_run(K, capture):
        cfg = tgiant.GiantConfig(block_ell=True, local_reorder="rcm", epochs_per_call=K)
        state = hybrid_state(np, tgiant, thybrid, locality_params, sgb, mesh, cfg)
        with eager_chunks(thybrid, capture is False):
            step = thybrid.make_hybrid_step(sgb, mesh, cfg, state)

        def run(k):
            return step(k)[0]

        run.runner = step.runner
        return run

    runs = chunk_runs(torch, np, hybrid_run)
    out["hybrid"] = held_equal(f"hybrid, 2 banded-random graphs on {R} x {D}", runs,
                               {"block_ell_spmm": 6 * R * D}, False)
    out["seconds"] = time.perf_counter() - t0
    log(f"  chunks phase {out['seconds']:.1f} s; card: {card}")
    torch.cuda.empty_cache()
    return out


def cli_lines(cli_main, argv: list) -> dict:
    """Run a command that prints one JSON object a line; their union."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        check(cli_main(argv) == 0, f"{' '.join(argv)} ran")
    merged = {}
    for line in out.getvalue().strip().splitlines():
        merged.update(json.loads(line))
    return merged


def phase_microbench(cli_main, chunk_recipe_ms: float) -> dict:
    """``bench --what all`` on the card: spmm (K1), banded (K2, K4), train
    and post, in that order, through the CLI, the counters read after the
    whole command.  ``train`` is the recipe's epoch in captured chunks,
    differenced as the JAX package times it; it is held within [0.75, 1.33]
    of ``chunk_recipe_ms``, the chunks phase's recipe epoch at K = 10 (CUDA
    events over chunks that end in their host reads)."""
    log("== microbench")
    registry.reset()
    res = cli_lines(cli_main, ["bench", "--what", "all", "--device", "cuda"])
    launches = launches_but_adam()
    check(list(res) == ["spmm", "banded", "train", "post"],
          "bench --what all printed spmm, banded, train and post, in that order")
    spmm, banded = res["spmm"], res["banded"]
    log(f"  spmm n={spmm['n']} d={spmm['d']} F={spmm['feature_dim']}: banded-random on K1 "
        f"(B={spmm['bell_block']}, Wp={spmm['bell_wp']}) fwd {spmm['fwd_edges_per_s']:.4g} "
        f"edges/s ({spmm['fraction_of_roofline_fwd']:.4f} of roofline), fwd+bwd "
        f"{spmm['fwdbwd_edges_per_s']:.4g} ({spmm['fraction_of_roofline_fwdbwd']:.4f}); "
        f"expander gather fwd {spmm['expander_fwd_edges_per_s']:.4g} "
        f"({spmm['expander_fraction_of_roofline_fwd']:.4f}), fwd+bwd "
        f"{spmm['expander_fwdbwd_edges_per_s']:.4g} "
        f"({spmm['expander_fraction_of_roofline_fwdbwd']:.4f}), bf16 fwd "
        f"{spmm['expander_bf16_fwd_edges_per_s']:.4g}")
    banded["hbm_regime_fraction"] = (
        banded["hbm_regime_fwd_edges_per_s"] / banded["banded_roofline_edges_per_s"])
    banded["hbm_regime_weighted_fraction"] = (
        banded["hbm_regime_weighted_fwd_edges_per_s"] / banded["weighted_roofline_edges_per_s"])
    log(f"  banded n={banded['n']} W={banded['bandwidth']}: K2 fwd "
        f"{banded['fwd_edges_per_s']:.4g} edges/s ({banded['fraction_of_banded_roofline']:.4f} "
        f"of roofline), fwd+bwd {banded['fwdbwd_edges_per_s']:.4g}, K4 fwd "
        f"{banded['weighted_fwd_edges_per_s']:.4g} "
        f"({banded['weighted_fraction_of_banded_roofline']:.4f}); n={banded['hbm_regime_n']}: "
        f"K2 {banded['hbm_regime_fwd_edges_per_s']:.4g} ({banded['hbm_regime_fraction']:.4f}, "
        f"{banded['hbm_regime_gbps']:.1f} GB/s), K4 "
        f"{banded['hbm_regime_weighted_fwd_edges_per_s']:.4g} "
        f"({banded['hbm_regime_weighted_fraction']:.4f})")
    train_ms = res["train"]["epoch_time_s"] * 1e3
    ratio = train_ms / chunk_recipe_ms
    log(f"  train: recipe epoch {train_ms:.3f} ms (captured chunks of 20 less chunks of 5, "
        f"best of 3 estimates, {res['train']['epoch_time_stats']['n_valid']} valid; first "
        f"chunk {res['train']['compile_time_s']:.3f} s), the chunks phase's recipe epoch at "
        f"K={CHUNK_K} {chunk_recipe_ms:.3f} ms, ratio {ratio:.4f}; post: "
        f"{res['post']['time_s'] * 1e3:.4f} ms at n={res['post']['n']}; launches {launches}; "
        f"card: {card_line()}")
    check(0.75 <= ratio <= 1.33, "bench --what train's captured epoch within [0.75, 1.33] of "
                                 "the chunks phase's recipe epoch")
    res["train"]["chunks_recipe_k10_ms"] = chunk_recipe_ms
    res["train"]["ratio_to_chunks_recipe"] = ratio
    check(launches["block_ell_spmm"] == 3 * (2 + 10), "K1 launched 3 times a timed call (36)")
    check(launches["banded_spmm_unit"] == 3 * (2 + 30) + (2 + 10),
          "K2 launched halo_stream.cu 108 times (F = 128)")
    check(launches["banded_spmm"] == (2 + 30) + (2 + 10), "K4 launched its ring 44 times")
    check(all(v == 0 for k, v in launches_but_sddmm(launches, "bench --what train").items()
              if k not in ("block_ell_spmm", "banded_spmm_unit", "banded_spmm")),
          "bench --what all runs no earlier body and no other kernel but the loss's SDDMM")
    fractions = [spmm[k] for k in spmm if "fraction" in k]
    fractions += [banded[k] for k in banded if "fraction" in k]
    check(all(0 < f <= 1 for f in fractions), "every roofline fraction in (0, 1]")
    return {"spmm": spmm, "banded": {**banded, "launches": launches},
            "train": res["train"], "post": res["post"], "launches": launches}


def _undirected(np, g):
    m = g.edge_mask.cpu().numpy() > 0
    s, r = g.senders.cpu().numpy()[m], g.receivers.cpu().numpy()[m]
    return np.stack([s[s < r], r[s < r]], axis=1)


def phase_solvers(torch, np, cli_main, recipe_checkpoint: str) -> dict:
    """The classical solvers, ``solve``, ``convert``, the baseline stats and
    the examples on the card."""
    from gcn_maxcut_tpu_torch.baselines import local_search as tls
    from gcn_maxcut_tpu_torch.baselines.exact import (
        _sa_restart_batch_from_draws,
        brute_force_maxcut,
    )
    from gcn_maxcut_tpu_torch.baselines.local_search import simulated_annealing_from_draws
    from gcn_maxcut_tpu_torch.data.enhanced import compute_baseline_stats
    from gcn_maxcut_tpu_torch.data.generate import generate_graph_dataset
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
    from gcn_maxcut_tpu_torch.examples import (
        complete_training_pipeline,
        giant_scale_pipeline,
        torch_migration,
    )
    from gcn_maxcut_tpu_torch.native.bindings import brute_force_maxcut_native
    from gcn_maxcut_tpu_torch.objectives.cut_loss import hard_cut_value
    from gcn_maxcut_tpu_torch.train.torch_compat import load_torch_checkpoint

    log("== solvers")
    card = card_line()
    registry.reset()
    out = {"card": card}

    def graph(n, d, seed, pad=None):
        specs, _ = generate_graph_dataset(1, n, n, d, d, base_seed=seed)
        return process_graphs(specs, DataConfig(max_nodes=pad or n)).graphs[0]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    # 1. brute force: card, CPU and native at n = 16; the card at n = 19
    n, d = SOLVER_BRUTE
    g = graph(n, d, 16)
    (asn_c, cut_c), card_s = timed(lambda: brute_force_maxcut(g.to("cuda"), batch=1 << 20))
    (asn_h, cut_h), cpu_s = timed(lambda: brute_force_maxcut(g))
    (asn_n, cut_n), native_s = timed(lambda: brute_force_maxcut_native(_undirected(np, g), n))
    check(cut_c == cut_h == cut_n, f"brute force at n = {n}: card, CPU and native optima equal")
    check(bool(np.array_equal(asn_c, asn_h)), "brute force: card and CPU assignments equal")
    n19, d19 = SOLVER_BRUTE_MAX
    g19 = graph(n19, d19, 19)
    (asn19, cut19), s19 = timed(lambda: brute_force_maxcut(g19.to("cuda"), batch=1 << 20))
    full = torch.zeros(g19.n_pad, dtype=torch.int64)
    full[:n19] = torch.as_tensor(asn19)
    check(float(hard_cut_value(g19, full)) == cut19, "brute force at n = 19 scores its optimum")
    codes19 = 3 ** (n19 - 3)
    out["brute_force"] = {
        "n16": {"cut": cut_c, "card_s": card_s, "cpu_s": cpu_s, "native_s": native_s,
                "codes": 3 ** (n - 3)},
        "n19": {"cut": cut19, "card_s": s19, "codes": codes19, "codes_per_s": codes19 / s19}}
    log(f"  brute force n={n} d={d}: optimum {cut_c} on card ({card_s:.4f} s), CPU "
        f"({cpu_s:.4f} s) and native ({native_s:.4f} s); n={n19} d={d19}: optimum {cut19}, "
        f"{codes19} codes in {s19:.4f} s on the card, {codes19 / s19:.4g} codes/s; card: {card}")

    # 2. the batched SA chains and their climb, card against CPU, one set of draws
    n, d, chains, steps = SOLVER_SA
    g = graph(n, d, 100)
    gen = torch.Generator().manual_seed(0)
    draws = (torch.randint(0, 3, (chains, g.n_pad), generator=gen),
             torch.randint(3, g.n_pad, (chains, steps), generator=gen),
             torch.randint(0, 3, (chains, steps), generator=gen),
             torch.rand((chains, steps), generator=gen))
    (a_h, c_h), sa_cpu_s = timed(lambda: _sa_restart_batch_from_draws(g, *draws, 3, 3))
    gc, dc = g.to("cuda"), [t.to("cuda") for t in draws]
    (a_c, c_c), sa_card_s = timed(lambda: _sa_restart_batch_from_draws(gc, *dc, 3, 3))
    same = float(c_c) == float(c_h) and bool(torch.equal(a_c.cpu(), a_h))
    check(abs(float(c_c) - float(c_h)) <= 1.0, "SA chains: card's best cut within one edge of "
                                               "the CPU's")
    out["sa_chains"] = {"cut_card": float(c_c), "cut_cpu": float(c_h), "equal": same,
                        "card_s": sa_card_s, "cpu_s": sa_cpu_s,
                        "card_steps_per_s": steps / sa_card_s}
    log(f"  SA chains n={n} R={chains} {steps} steps + climb: card {float(c_c)} "
        f"({sa_card_s:.3f} s, {steps / sa_card_s:.1f} lockstep steps/s), CPU {float(c_h)} "
        f"({sa_cpu_s:.3f} s); assignments {'equal' if same else 'differ'}; card: {card}")

    # 2b. the chains alone at solve --n 500's shape: captured against eager
    #     on one set of draws, in turns (captured, eager, eager, captured)
    n, d, chains, steps = SOLVER_SA_LOCKSTEP
    g5 = graph(n, d, 500).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.arange(g5.n_pad, device="cuda")
    init = torch.where(ids < 3, ids, torch.randint(0, 3, (chains, g5.n_pad), generator=gen,
                                                   device="cuda"))
    draws = (torch.randint(3, g5.n_pad, (chains, steps), generator=gen, device="cuda"),
             torch.randint(0, 3, (chains, steps), generator=gen, device="cuda"),
             torch.rand((chains, steps), generator=gen, device="cuda"))
    sa_s, sa_res = {"captured": [], "eager": []}, {}
    for mode in ("captured", "eager", "eager", "captured"):
        with eager_chunks(tls, mode == "eager"):
            r, t = timed(lambda: simulated_annealing_from_draws(g5, init, *draws))
        sa_s[mode].append(t)
        sa_res.setdefault(mode, r)
    (a_cap, c_cap), (a_eag, c_eag) = sa_res["captured"], sa_res["eager"]
    check(torch.equal(a_cap, a_eag) and torch.equal(c_cap, c_eag),
          "SA chains: captured and eager best assignments and cuts equal bit for bit")
    rates = {m: steps / min(v) for m, v in sa_s.items()}
    out["sa_lockstep"] = {"n": n, "d": d, "chains": chains, "steps": steps, "seconds": sa_s,
                          "steps_per_s": rates, "equal": True,
                          "best_cut": float(c_cap.max())}
    log(f"  SA chains alone n={n} d={d} R={chains} {steps} steps (each call captures its "
        f"step): captured {rates['captured']:.1f} lockstep steps/s (runs {sa_s['captured']} "
        f"s), eager {rates['eager']:.1f} (runs {sa_s['eager']} s), "
        f"{rates['captured'] / rates['eager']:.2f}x; results equal; card: {card}")

    # 3. solve: the anytime solver's SA branch and its exact branch
    res = cli_json(cli_main, SOLVE_ANYTIME)
    batch_restarts = 64          # max(8, min(64, 2^22 // n_pad)) at n_pad >= 500
    check(res["method"] == "sa_anytime" and res["restarts"] >= batch_restarts,
          "solve --n 500: the SA branch ran at least one batch of 64 chains")
    check(res["cut_value"] > res["randomized_cut"], "solve --n 500 beats its randomized cut")
    t = res["solve_time_s"]
    res.update({"chains_per_s": res["restarts"] / t,
                "chain_steps_per_s": res["restarts"] * SA_STEPS / t,
                "lockstep_steps_per_s": res["restarts"] / batch_restarts * SA_STEPS / t})
    exact = cli_json(cli_main, ["solve", "--n", "15", "--device", "cuda"])
    check(exact["method"] == "exact_brute_force", "solve --n 15 takes the exact branch")
    out["solve_anytime"], out["solve_exact"] = res, exact
    log(f"  solve n=500 d=8 20 s: {res['method']} cut {res['cut_value']} (randomized "
        f"{res['randomized_cut']}), {res['restarts']} chains in {t} s: "
        f"{res['chains_per_s']:.3f} chains/s, {res['chain_steps_per_s']:.4g} chain-steps/s, "
        f"{res['lockstep_steps_per_s']:.1f} lockstep steps/s; n=15: {exact['method']} cut "
        f"{exact['cut_value']} in {exact['solve_time_s']} s; card: {card}")

    # 4. solve: the native sweep at n = 100,000
    sw = cli_json(cli_main, SOLVE_SWEEP)
    check(sw["cut_fraction"] > 2 / 3, "the sweep's cut fraction above 2/3")
    out["solve_sweep"] = sw
    log(f"  solve --method sweep n=100000 d=8: cut fraction {sw['cut_fraction']:.5f} in "
        f"{sw['sweeps']} sweeps, {sw['solve_time_s']} s (host); card: {card}")

    # 5. the baseline stats on 4 recipe-sized graphs
    specs, _ = generate_graph_dataset(4, 500, 500, 6, 8, base_seed=4000)
    ds = process_graphs(specs, DataConfig(max_nodes=1000))
    (stats), stats_s = timed(lambda: compute_baseline_stats(ds, solver_time_limit=5,
                                                            device="cuda"))
    check(all(r["solver_cut"] >= r["randomized_cut"] for r in stats.values()),
          "baseline stats: every solver cut at least the randomized cut")
    out["baseline_stats"] = {"graphs": stats, "seconds": stats_s}
    log(f"  baseline stats, 4 graphs n=500 padded to 1000, solver 5 s: " + "; ".join(
        f"randomized {r['randomized_cut']}, flow {r['flow_min_cut_value']}, solver "
        f"{r['solver_cut']} ({r['solver_method']}, {r['solver_time_s']:.2f} s)"
        for r in stats.values()) + f"; {stats_s:.2f} s in all; card: {card}")

    with tempfile.TemporaryDirectory() as tmp:
        # 6. convert: the recipe's final checkpoint .npz -> .pth -> .npz
        pth, back = str(Path(tmp) / "recipe.pth"), str(Path(tmp) / "recipe_back.npz")
        _, to_pth_s = timed(lambda: cli_json(cli_main, ["convert", recipe_checkpoint, pth]))
        _, to_npz_s = timed(lambda: cli_json(cli_main, ["convert", pth, back]))
        with np.load(recipe_checkpoint) as a, np.load(back) as b:
            keys = sorted(k for k in a.files if k != "_meta")
            check(keys == sorted(k for k in b.files if k != "_meta"),
                  "convert round trip keeps every array")
            check(all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in keys),
                  "convert round trip: every array bit-equal to the recipe's checkpoint")
        sizes = {p: Path(p).stat().st_size for p in (recipe_checkpoint, pth, back)}
        out["convert"] = {"to_pth_s": to_pth_s, "to_npz_s": to_npz_s, "arrays": len(keys),
                          "npz_bytes": sizes[recipe_checkpoint], "pth_bytes": sizes[pth],
                          "back_npz_bytes": sizes[back]}
        log(f"  convert {len(keys)} arrays: npz -> pth {to_pth_s:.3f} s ({sizes[pth]} bytes), "
            f"pth -> npz {to_npz_s:.3f} s ({sizes[back]} bytes), bit-equal to the "
            f"{sizes[recipe_checkpoint]}-byte original")

        # 7. the examples on the card
        start_epoch = load_torch_checkpoint(pth)[2]["epoch"]
        mig, mig_s = timed(lambda: torch_migration.main(pth, device="cuda"))
        check(len(mig["losses"]) == 5 and all(math.isfinite(x) for x in mig["losses"]),
              "torch_migration: 5 finite losses")
        params, _, meta = load_torch_checkpoint(mig["exported"])
        check(meta["epoch"] == start_epoch + 5 and meta["loss_history"][-1] == mig["losses"][-1]
              and all(bool(torch.isfinite(t).all()) for t in (params["conv1"]["w"],
                                                               params["conv2"]["w"])),
              "torch_migration's _continued.pth reads back, 5 epochs on")
        rc, giant_s = timed(lambda: giant_scale_pipeline.main(N=EXAMPLE_GIANT_N, device="cuda"))
        check(rc == 0, "giant_scale_pipeline exited 0")
        rc, quick_s = timed(lambda: complete_training_pipeline.main(
            str(Path(tmp) / "pipeline"), quick=True, device="cuda"))
        check(rc == 0, "complete_training_pipeline --quick exited 0")
    out["examples"] = {"torch_migration": {"losses": mig["losses"], "seconds": mig_s,
                                           "continued_epoch": meta["epoch"]},
                       "giant_scale_pipeline_s": giant_s,
                       "complete_training_pipeline_quick_s": quick_s}
    log(f"  examples: torch_migration {mig_s:.2f} s (losses {mig['losses']}), "
        f"giant_scale_pipeline N={EXAMPLE_GIANT_N} {giant_s:.2f} s, "
        f"complete_training_pipeline --quick {quick_s:.2f} s; card: {card}")
    out["launches"] = dict(registry.LAUNCHES)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "gcn_maxcut_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no gcn_maxcut_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    import numpy as np

    from gcn_maxcut_tpu_torch import build
    from gcn_maxcut_tpu_torch.bench import giant_demo as giant
    from gcn_maxcut_tpu_torch.bench import scaling
    from gcn_maxcut_tpu_torch.bench.kway_sweep import kway_sweep
    from gcn_maxcut_tpu_torch.bench import locality as loc
    from gcn_maxcut_tpu_torch.bench import microbench as micro
    from gcn_maxcut_tpu_torch.bench import quality
    from gcn_maxcut_tpu_torch.cli import main as cli_main
    from gcn_maxcut_tpu_torch.cli import run_pipeline
    from gcn_maxcut_tpu_torch.core import graph as tgraph
    from gcn_maxcut_tpu_torch.data.generate import random_regular_edges
    from gcn_maxcut_tpu_torch.device import resolve_device
    from gcn_maxcut_tpu_torch.experiments import (
        gather_probe,
        gather_probe2,
        panel_ell_probe,
        subblock_probe,
        weighted_probe,
    )
    from gcn_maxcut_tpu_torch.ops import banded as tb
    from gcn_maxcut_tpu_torch.ops import block_ell as tbell
    from gcn_maxcut_tpu_torch.ops import halo as th
    from gcn_maxcut_tpu_torch.ops import halo_stream as hs
    from gcn_maxcut_tpu_torch.ops import probe_kernels as tpk
    from gcn_maxcut_tpu_torch.ops import segment as seg
    from gcn_maxcut_tpu_torch.parallel import data_parallel as tdp
    from gcn_maxcut_tpu_torch.parallel import giant as tgiant
    from gcn_maxcut_tpu_torch.parallel import giant_banded as tgb
    from gcn_maxcut_tpu_torch.parallel import hybrid as thybrid
    from gcn_maxcut_tpu_torch.parallel import partition as tpart
    from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh
    from gcn_maxcut_tpu_torch.train import loop as tloop

    resolve_device()                      # turns TF32 off
    OUT_DIR.mkdir(exist_ok=True)
    t_start = time.perf_counter()
    report = {"build": phase_build(build)}
    report["kernels"] = phase_kernels(torch, tb, hs, giant.circulant_offsets(8, 63, 0),
                                      micro.banded_offsets(8, 63))
    report["kernels_k1"] = phase_kernels_block_ell(torch, np, tbell, seg, tgraph, micro, loc)
    report["kernels_k4"] = phase_kernels_weighted(torch, tb, micro.banded_offsets(8, 63))
    report["kernels_halo"] = phase_kernels_halo(torch, th, tb, make_mesh,
                                                giant.circulant_offsets(8, 63, 0),
                                                micro.banded_offsets(8, 63))
    probes = {"gather_probe": gather_probe, "gather_probe2": gather_probe2,
              "subblock_probe": subblock_probe, "panel_ell_probe": panel_ell_probe,
              "weighted_probe": weighted_probe}
    report["kernels_probes"] = phase_kernels_probes(torch, np, tpk, tb, tbell, micro, tgraph,
                                                    probes)
    report["probes"] = phase_probes(torch, probes)
    report["adam"] = phase_adam(torch)
    report["sddmm"] = phase_sddmm(torch, seg)
    report["giant"] = phase_giant(torch, giant)
    report["halo"] = phase_halo(torch, tgb, giant, make_mesh,
                                report["giant"]["packed"]["cut_fraction"])
    report["recipe"] = phase_recipe(run_pipeline, cli_main)
    report["variants"] = phase_variants(torch)
    report["quality"] = phase_quality(quality)
    report["quality_ent05"] = phase_quality(quality, "ent05")
    report["quality_quant"] = phase_quality(quality, "quant")
    report["locality"] = phase_locality(torch, np, loc)
    report["kway"] = phase_kway(torch, np, tbell, make_mesh, micro, tpart, tgiant, kway_sweep,
                                scaling, random_regular_edges)
    report["hybrid"] = phase_hybrid(torch, np, tbell, make_mesh, micro, tpart, tgiant, thybrid,
                                    loc.locality_params, random_regular_edges, cli_main)
    report["dp"] = phase_dp(torch, np, make_mesh, tdp, tloop, tgiant, thybrid, tpart,
                            loc.locality_params, random_regular_edges, report["variants"])
    report["chunks"] = phase_chunks(torch, np, giant, tgiant, tgb, thybrid, tpart, make_mesh,
                                    micro, loc.locality_params, random_regular_edges)
    report["solvers"] = phase_solvers(torch, np, cli_main, report["recipe"]["final_checkpoint"])
    report["microbench"] = phase_microbench(cli_main,
                                            report["chunks"]["recipe"]["k10"]["epoch_ms"])
    report["timings"] = phase_timings(torch, report["microbench"],
                                      report["quality"]["per_size"][500]["refine_time_s"],
                                      report["recipe"])
    report["seconds"] = time.perf_counter() - t_start
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=float))

    rows = {t["name"]: t for t in report["kernels"]["timings"]
            if (t["name"], t["n"], t["F"], t["dtype"]) in
            {("K2", GIANT_N, 16, "float32"), ("K3", GIANT_N, 16, "bfloat16"),
             ("K2 window", PLAIN_N, 3, "float32")}}
    rows["K1"] = next(t for t in report["kernels_k1"]["timings"]
                      if (t["case"], t["F"]) == ("locality", 64))
    rows["K4"] = next(t for t in report["kernels_k4"]["timings"]
                      if (t["n"], t["F"]) == (BANDED_N, 128))
    rows["K5"] = next(t for t in report["kernels_halo"]["timings"]
                      if (t["name"], t["n_shard"] * t["shards"], t["dtype"])
                      == ("K5", HALO_K5_N, "float32"))
    rows["K6"] = next(t for t in report["kernels_halo"]["timings"]
                      if (t["name"], t["dtype"]) == ("K6", "bfloat16"))
    rows["K5 window"] = next(t for t in report["kernels_halo"]["timings"]
                             if (t["name"], t["F"]) == ("K5", 3))
    check(not rows["K5 window"]["vec16"], "K5 at F = 3 runs the earlier body")
    check((rows["K2"]["source"], rows["K3"]["source"], rows["K2 window"]["source"])
          == (HALO_SOURCE, HALO_SOURCE, KERNEL_SOURCE),
          "K2 at F = 16 and K3 run halo_stream.cu, K2 at F = 3 the earlier body")
    for name in ("K5", "K6", "K5 window"):
        rows[name]["n"] = rows[name]["n_shard"]
    k1_paths = {"locality": report["locality"]["launches"]["block_ell_spmm"],
                "kway (banded, 4 shards)": report["kway"]["banded"]["launches"]["block_ell_spmm"],
                "hybrid (banded, 2 × 4 mesh)":
                    report["hybrid"]["banded"]["launches"]["block_ell_spmm"]}
    launches = {"K1": sum(k1_paths.values()),
                "K2": report["giant"]["plain"]["launches"]["banded_spmm_unit"],
                "K2 window": report["giant"]["plain"]["launches"]["banded_spmm_unit_window"],
                "K3": report["giant"]["packed"]["launches"]["banded_spmm_unit_packed"],
                "K4": report["microbench"]["banded"]["launches"]["banded_spmm"],
                "K5": report["halo"]["plain"]["launches"]["halo_banded_spmm"],
                "K6": report["halo"]["packed"]["launches"]["halo_banded_spmm_unit_packed"],
                "K5 window": report["halo"]["plain"]["launches"]["halo_banded_spmm_window"]}
    errors = {**report["kernels"]["max_abs_err"], "K1": report["kernels_k1"]["max_abs_err"],
              "K4": report["kernels_k4"]["max_abs_err"], **report["kernels_halo"]["max_abs_err"]}
    names = {"K1": "block_ell_spmm", "K2": "banded_spmm_unit",
             "K2 window": "banded_spmm_unit at F = 3 (rows not 16-byte pieces: "
                          "the earlier body, banded_window.cu)",
             "K3": "banded_spmm_unit_packed", "K4": "banded_spmm",
             "K5": "halo_banded_spmm", "K6": "halo_banded_spmm_unit_packed",
             "K5 window": "halo_banded_spmm_unit at F = 3 (rows not 16-byte pieces: "
                          "the earlier body, the halo mode of banded_window.cu)"}
    replaces = {"K1": "gcn_maxcut_tpu/ops/pallas_block_ell.py:146",
                "K2": "gcn_maxcut_tpu/ops/pallas_banded.py:257",
                "K2 window": "gcn_maxcut_tpu/ops/pallas_banded.py:257",
                "K3": "gcn_maxcut_tpu/ops/pallas_banded.py:529",
                "K4": "gcn_maxcut_tpu/ops/pallas_banded.py:257",
                "K5": "gcn_maxcut_tpu/ops/pallas_halo.py:162",
                "K6": "gcn_maxcut_tpu/ops/pallas_halo.py:409",
                "K5 window": "gcn_maxcut_tpu/ops/pallas_halo.py:515"}
    sources = {"K1": K1_SOURCE, "K2": HALO_SOURCE, "K2 window": KERNEL_SOURCE,
               "K3": HALO_SOURCE, "K4": K4_SOURCE, "K5": HALO_SOURCE, "K6": HALO_SOURCE,
               "K5 window": KERNEL_SOURCE}
    kernels = [{
        "name": f"{name} {names[name]}", "route": "cuda",
        "source": sources[name],
        "replaces": replaces[name], "launches": launches[name],
        "max_abs_err": errors[name], "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
        "bound_ms": rows[name]["bound_ms"], "bound_by": rows[name]["bound_by"],
        "library_ms": rows[name]["library_ms"],
        "shape": [rows[name]["n"], rows[name]["F"]], "dtype": rows[name]["dtype"],
        **({"shards": rows[name]["shards"], "op_ms": rows[name]["op_ms"],
            "exchange_ms": rows[name]["exchange_ms"]} if name.startswith(("K5", "K6")) else {}),
        "earlier_ms": rows[name].get("earlier_ms"),
    } for name in ("K1", "K2", "K2 window", "K3", "K4", "K5", "K5 window", "K6")]
    kernels[0]["launches_by_path"] = k1_paths
    kernels[3]["launches_by_path"] = {
        "giant packed, 40 epochs with checkpoints": launches["K3"],
        "giant packed, resumed at epoch 20": report["giant"]["resume"]["launches"][
            "banded_spmm_unit_packed"]}

    # the probes' rows: (label, wrapper, source, pallas_call, probe run,
    # launch counter, error key, timing case)
    probe_timings = report["kernels_probes"]["timings"]
    probe_errors = report["kernels_probes"]["max_abs_err"]
    for label, wrapper, source, replaced, run, counter, err_key, case in [
        ("P1", "window_gather (window_warp_gather)", PROBE_SOURCE,
         "experiments/gather_probe.py:169", "gather_probe", "window_gather", "window_gather",
         "W=255 B=512 d=8 float32 x"),
        ("P2", "window_gather (window_warp_gather, bf16 x)", PROBE_SOURCE,
         "experiments/gather_probe2.py:92", "gather_probe2", "window_gather", "window_gather",
         "W=255 B=256 d=8 bfloat16 x"),
        ("P3", "subblock_spmm (ring)", SUBBLOCK_SOURCE,
         "experiments/subblock_probe.py:123", "subblock_probe", "subblock_spmm",
         "subblock_spmm", "W=255 B=256 Wp=256"),
        ("P4", "panel_ell_spmm (panel_ell_gather)", PROBE_SOURCE,
         "experiments/panel_ell_probe.py:157",
         "panel_ell_probe", "panel_ell_spmm", "panel_ell_spmm", "W=255 B=256 Wp=256 W_P=4"),
        ("P5a", "banded_spmm_cols (K4's ring, column weights)", K4_SOURCE,
         "experiments/weighted_probe.py:224", "weighted_probe", "banded_spmm_cols",
         "banded_spmm_cols", f"n={BANDED_N} F=128 D=8 cols"),
        ("P5b", "banded_spmm (K4 on w')", K4_SOURCE, "experiments/weighted_probe.py:251",
         "weighted_probe", "banded_spmm", "banded_spmm (P5b)", f"n={BANDED_N} F=128 D=8 blockw"),
    ]:
        row = next(t for t in probe_timings if t["case"] == case)
        kernels.append({
            "name": f"{label} {wrapper}", "route": "cuda", "source": source,
            "replaces": replaced, "launches": report["probes"][run]["launches"][counter],
            "max_abs_err": probe_errors[err_key], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": [row["n"], row["F"]], "dtype": row["dtype"],
            "earlier_ms": row.get("earlier_ms"),
        })
    adam = report["adam"]["giant"]
    packed = report["giant"]["packed"]
    kernels.append({
        "name": "C2 Adam step (ops/adam.step_kernel)", "route": "cuda", "source": ADAM_SOURCE,
        "replaces": "none: optax.adam under XLA's fusion",
        # measured on the packed giant's 40-epoch run: launches an Adam step
        "launches": sum(packed["adam_launches"].values()) / packed["epochs"],
        "ms": adam["ms"], "plain_ms": adam["plain_ms"], "bound_ms": adam["bound_ms"],
        "bound_by": "bytes", "library_ms": adam["library_ms"],
        "library_equal": adam["library_equal"], "shape": adam["leaves"],
        "dtype": f"float32, mu {adam['mu_dtype']}", "recipe": report["adam"]["recipe"],
    })
    sddmm = report["sddmm"]
    recipe = report["recipe"]
    kernels.append({
        "name": "C3 SDDMM forward + backward (ops/segment.sddmm)", "route": "cuda",
        "source": SDDMM_SOURCE,
        "replaces": "none: the JAX package's gathers and scatter-adds under XLA",
        # measured on the recipe's pipeline: launches a graph step
        "launches": sum(recipe["sddmm_launches"].values()) / recipe["adam_launches"]["adam_count"],
        "ms": {d: r["ms"] for d, r in sddmm.items()},
        "plain_ms": {d: r["plain_ms"] for d, r in sddmm.items()},
        "plain_unpadded_ms": {d: r["plain_unpadded_ms"] for d, r in sddmm.items()},
        "bound_ms": {d: r["bound_ms"] for d, r in sddmm.items()}, "bound_by": "bytes (latency)",
        "library_ms": None, "shape": {d: r["shape"] for d, r in sddmm.items()},
        "dtype": "float32",
    })
    log(f"total {report['seconds']:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
