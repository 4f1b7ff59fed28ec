"""gcn_maxcut_tpu_torch — the PyTorch/CUDA port of ``gcn_maxcut_tpu``.

The JAX package stays the reference; every module here mirrors the path of
its counterpart there (``gcn_maxcut_tpu/<path>`` → ``gcn_maxcut_tpu_torch/
<path>``) and is tested against it on the same inputs.  The port imports
torch and numpy only, never JAX or the JAX package.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``device.resolve_device``); there is no silent fallback.
Kernels are hand-written CUDA C++ under ``csrc/``, built by ``build.py`` at
first use; on CPU tensors each op runs its plain PyTorch version.  Loops
that the JAX package runs inside one device call (a chunk of epochs, the
greedy climb, the SA chains) run on the card as captured CUDA graphs
replayed a step at a time (``train/chunks.py``).

Each subpackage exports the JAX package's names (its ``__all__``); the
names the port renames or does not port are listed in ``JAX_NAMES``.

The port holds:
  core/        padded Graph container (COO sorted by receiver, ELL tables,
               block-ELL plans, locality relabeling)
  data/        seeded regular / G(n,p) graphs, terminal normalisation, RCM,
               npz datasets (the JAX package's layout), the text format and
               the enhanced datasets' baseline statistics
  ops/         block-ELL / ELL / COO SpMM, SDDMM, STE ops; the banded SpMM
               kernels (K2, K3, weighted K4), the block-ELL kernel (K1), the
               sharded halo kernels over a device ring (K5, K6) and the
               design probes' kernels (P1–P5)
  models/      GraphConv (norm='both'), the GCNSoftmax module and the
               legacy sigmoid QUBO model
  objectives/  edge-form cut loss, sampled-decode quantile loss, hard cut
               value, the loss-variant zoo and the max-cut QUBO
  train/       TrainingConfig, the Adam loop (per-graph or batched steps,
               constant or cosine rate, STE / quantile / entropy losses)
               with early stopping on the device, chunks of epochs
               (``make_epoch_fn``, ``ChunkRunner``), npz checkpoints (the
               JAX package's layout) and resume, the reference's ``.pth``
               checkpoints; the single-graph QUBO loop
  eval/        argmax and sampled decoders, the multi-start greedy-flip
               refine, the class-relabeling search and the evaluation
               harness (per-graph tests, size buckets, analysis, reports)
  baselines/   randomized k-way max-cut; greedy flips, simulated annealing,
               BLS and the recursive 2-way split; brute force, the flow
               min-cut, the anytime solver and the native sweep
  native/      ctypes bindings of native/libgraphtools.so (the regular
               sampler, partitions, symmetry check, shard assembly, the
               brute-force and greedy solvers) and its build
  parallel/    device rings and (data, graph) meshes, multi-process runs
               over torch.distributed, the node-sharded banded giant
               trainers and their step builders, graph partitioning, the
               ring / all-gather sharded SpMM, the giant trainer of
               BASELINE config 4, data-parallel and hybrid training
  bench/       the cut-quality suite, the k-way sweep, the sharded conv's
               scaling harness, giant banded trainers, the locality
               trainer, the recipe's epoch (captured chunks, differenced)
               and post-processing timings, SpMM microbenchmarks and the
               H100 roofline
  utils/       logging, timers that synchronise the card, profiler traces,
               the non-finite check of a chunk
  viz/         the publication charts (matplotlib, where installed)
  examples/    the repo's example scripts on the port
  experiments/ the SpMM design probes
  cli.py       ``generate``, ``train``, ``test``, ``pipeline``, ``solve``,
               ``convert`` and ``bench --what all|quality|train|post|giant|
               locality|spmm|banded|kway|scaling|hybrid``
"""

__version__ = "0.1.0"

# Every public name of a JAX module that has no counterpart under the same
# name in the port's module of the same path: "<module>.<name>" (or a
# module) -> (the port's name, or None where it is not ported, and why).
# ``tests/test_torch_port_exports.py`` holds both packages to this table.
JAX_NAMES = {
    "ops.pallas_block_ell": ("ops.block_ell", "the kernel is CUDA, not Pallas"),
    "ops.pallas_banded": ("ops.banded", "the kernels are CUDA, not Pallas"),
    "ops.pallas_halo": ("ops.halo", "the kernels are CUDA, not Pallas"),
    "ops.segment.spmm_xla": ("spmm_coo", "the COO path is not XLA's"),
    "ops.pallas_banded.banded_spmm_xla": ("banded_spmm_plain", "the plain version"),
    "ops.pallas_banded.banded_spmm_unit_xla": ("banded_spmm_unit_plain",
                                               "the plain version"),
    "ops.pallas_banded.DEFAULT_BLOCK": (None, "a TPU row block; the CUDA kernels size "
                                              "their own tiles (ops/banded.stream_shape)"),
    "models.gcn.gcn_softmax_init": ("GCNSoftmax.init", "the model is an nn.Module"),
    "eval.decode.post_process_jit": (None, "a jax.jit alias; PyTorch runs eagerly"),
    "parallel.partition.shard_specs": (None, "shard_map PartitionSpecs; a ShardedGraph "
                                             "is a list of per-shard blocks"),
    "parallel.partition.local_shard": (None, "the per-device view inside shard_map; "
                                             "each block already is one"),
    "utils.cache": (None, "XLA's persistent compilation cache"),
    "utils.cache.enable_compilation_cache": (None, "XLA's persistent compilation cache"),
    "utils.timing.scan_timeit": (None, "times an op inside one jit for a TPU runtime whose "
                                       "block_until_ready returned early; CUDA events "
                                       "time the card"),
    "utils.timing.scan_timeit_stats": (None, "as scan_timeit"),
    "logger": (None, "a module's logger is no API; the port's modules log through "
                     "logging.getLogger where they log"),
}
