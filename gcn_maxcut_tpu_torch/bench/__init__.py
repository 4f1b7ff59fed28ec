"""bench: see the counterpart in gcn_maxcut_tpu/bench/.

``kway_sweep`` (BASELINE config 4) and the sharded conv's scaling harness
are exported here; the other benches are imported from their modules.
"""

from gcn_maxcut_tpu_torch.bench.kway_sweep import kway_sweep
from gcn_maxcut_tpu_torch.bench.scaling import bench_sharded_conv, scaling_sweep

__all__ = ["bench_sharded_conv", "kway_sweep", "scaling_sweep"]
