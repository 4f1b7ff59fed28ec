"""gcn_maxcut_tpu_torch — the PyTorch/CUDA port of ``gcn_maxcut_tpu``.

The JAX package stays the reference; every module here mirrors the path of
its counterpart there (``gcn_maxcut_tpu/<path>`` → ``gcn_maxcut_tpu_torch/
<path>``) and is tested against it on the same inputs.  The port imports
torch and numpy only, never JAX or the JAX package.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``device.resolve_device``); there is no silent fallback.
Kernels are hand-written CUDA C++ under ``csrc/``, built by ``build.py`` at
first use; on CPU tensors each op runs its plain PyTorch version.

This slice holds:
  core/        padded Graph container (COO sorted by receiver, ELL tables)
  data/        seeded regular / G(n,p) graphs, terminal normalisation
  ops/         ELL/COO SpMM, SDDMM, STE ops, banded SpMM kernel (K2, K3)
  models/      GraphConv (norm='both') and the GCNSoftmax module
  objectives/  edge-form cut loss and hard cut value
  train/       TrainingConfig, per-graph Adam loop with early stopping
  eval/        argmax and sampled decoders
  baselines/   randomized k-way max-cut
  bench/       single-device giant banded trainers (plain and packed)
  cli.py       ``pipeline`` and ``bench --what giant``
"""

__version__ = "0.1.0"
