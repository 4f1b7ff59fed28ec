"""Launches of the port's hand-written CUDA kernels, counted in one place.

Each wrapper under ``ops/`` adds to its key where its kernel launches, so
the counts say which kernel ran, not which op was called.  A kernel's
earlier body, where it is a live route, counts under the op's name +
``_window``.  ``train/chunks.ChunkRunner`` carries a captured epoch's
launches over its replays, which make no Python call.
"""

from __future__ import annotations

LAUNCHES = {
    # K1: csrc/block_ell_gather.cu (ops/block_ell.py)
    "block_ell_spmm": 0,
    # K2, K3 on csrc/halo_stream.cu, K4 on csrc/banded_stream.cu, and their
    # earlier body csrc/banded_window.cu (ops/banded.py)
    "banded_spmm_unit": 0, "banded_spmm_unit_packed": 0, "banded_spmm": 0,
    "banded_spmm_unit_window": 0, "banded_spmm_unit_packed_window": 0,
    "banded_spmm_window": 0,
    # K5, K6 on csrc/halo_stream.cu, and the halo mode of
    # csrc/banded_window.cu (ops/halo.py), one a shard
    "halo_banded_spmm": 0, "halo_banded_spmm_unit_packed": 0,
    "halo_banded_spmm_window": 0, "halo_banded_spmm_unit_packed_window": 0,
    # the probes' kernels (ops/probe_kernels.py)
    "window_gather": 0, "subblock_spmm": 0, "panel_ell_spmm": 0,
    "banded_spmm_cols": 0, "banded_spmm_cols_window": 0,
    # Adam's step, csrc/adam.cu (ops/adam.py)
    "adam_update": 0, "adam_count": 0,
    # the decode's climb, csrc/climb.cu (ops/climb.py)
    "climb": 0,
    # the cut loss's SDDMM, csrc/sddmm.cu (ops/segment.py)
    "sddmm": 0, "sddmm_backward": 0,
    # the packed giant's head and cut loss, csrc/group_head.cu (ops/group_head.py)
    "group_head": 0, "cut_dot": 0, "group_head_backward": 0,
}


def reset() -> None:
    """Every count back to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
