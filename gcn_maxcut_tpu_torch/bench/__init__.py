"""bench: see the counterpart in gcn_maxcut_tpu/bench/.

The JAX package's six names, then the sharded conv's scaling harness; the
other benches are imported from their modules.
"""

from gcn_maxcut_tpu_torch.bench.kway_sweep import kway_sweep
from gcn_maxcut_tpu_torch.bench.microbench import (
    bench_post_processing,
    bench_spmm,
    bench_train_epoch,
)
from gcn_maxcut_tpu_torch.bench.roofline import RooflineModel, chip_specs
from gcn_maxcut_tpu_torch.bench.scaling import bench_sharded_conv, scaling_sweep

__all__ = [
    "RooflineModel",
    "chip_specs",
    "bench_spmm",
    "bench_train_epoch",
    "bench_post_processing",
    "kway_sweep",
    "bench_sharded_conv",
    "scaling_sweep",
]
