"""gcn_maxcut_tpu_torch — the PyTorch/CUDA port of ``gcn_maxcut_tpu``.

The JAX package stays the reference; every module here mirrors the path of
its counterpart there (``gcn_maxcut_tpu/<path>`` → ``gcn_maxcut_tpu_torch/
<path>``) and is tested against it on the same inputs.  The port imports
torch and numpy only, never JAX or the JAX package.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``device.resolve_device``); there is no silent fallback.
Kernels are hand-written CUDA C++ under ``csrc/``, built by ``build.py`` at
first use; on CPU tensors each op runs its plain PyTorch version.

So far the port holds:
  core/        padded Graph container (COO sorted by receiver, ELL tables,
               block-ELL plans, locality relabeling)
  data/        seeded regular / G(n,p) graphs, terminal normalisation, RCM,
               npz datasets (the JAX package's layout) and the text format
  ops/         block-ELL / ELL / COO SpMM, SDDMM, STE ops; the banded SpMM
               kernels (K2, K3, weighted K4), the block-ELL kernel (K1) and
               the sharded halo kernels over a device ring (K5, K6)
  models/      GraphConv (norm='both'), the GCNSoftmax module and the
               legacy sigmoid QUBO model
  objectives/  edge-form cut loss, sampled-decode quantile loss, hard cut
               value, the loss-variant zoo and the max-cut QUBO
  train/       TrainingConfig, the Adam loop (per-graph or batched steps,
               constant or cosine rate, STE / quantile / entropy losses)
               with early stopping, npz checkpoints (the JAX package's
               layout) and resume; the single-graph QUBO loop
  eval/        argmax and sampled decoders, the multi-start greedy-flip
               refine, the class-relabeling search and the evaluation
               harness (per-graph tests, size buckets, analysis, reports)
  baselines/   randomized k-way max-cut; greedy flips, simulated
               annealing, BLS and the recursive 2-way split
  native/      ctypes bindings of native/libgraphtools.so (the regular
               sampler, partitions, symmetry check, shard assembly)
  parallel/    device rings (meshes), the node-sharded banded giant
               trainers, graph partitioning, the ring / all-gather sharded
               SpMM and the giant trainer of BASELINE config 4
  bench/       the cut-quality suite, the k-way sweep, the sharded conv's
               scaling harness, giant banded trainers, the locality
               trainer, the recipe's epoch and post-processing timings,
               SpMM microbenchmarks and the H100 roofline
  utils/       the per-epoch JSONL metrics logger
  cli.py       ``generate``, ``train``, ``test``, ``pipeline`` and ``bench
               --what quality|train|post|giant|locality|spmm|banded|kway|
               scaling``
"""

__version__ = "0.1.0"
