"""ops: see the counterpart in gcn_maxcut_tpu/ops/.

JAX's ``spmm_xla`` is ``spmm_coo`` here, and its ``pallas_block_ell``,
``pallas_banded`` and ``pallas_halo`` modules are ``block_ell``,
``banded`` and ``halo``: their kernels are CUDA.
"""

from gcn_maxcut_tpu_torch.ops.segment import (
    sddmm,
    segment_sum_edges,
    spmm,
    spmm_coo,
)
from gcn_maxcut_tpu_torch.ops.ste import (
    pin_terminals,
    ste_argmax_onehot,
    ste_threshold,
)

__all__ = [
    "spmm",
    "spmm_coo",
    "sddmm",
    "segment_sum_edges",
    "pin_terminals",
    "ste_argmax_onehot",
    "ste_threshold",
]
