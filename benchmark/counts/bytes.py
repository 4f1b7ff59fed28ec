"""Bytes a kernel has to move, counted from shapes: each input byte read
once and each output byte written once."""

from __future__ import annotations


def banded_unit_call(n: int, width: int, elsize: int) -> float:
    """One unit-weight banded aggregation (K2, K3) of an [n, width] array:
    read it once, write the sum once."""
    return 2.0 * n * width * elsize


def giant_packed_epoch_k3(n: int, width: int = 16, elsize: int = 2, calls: int = 6) -> float:
    """The packed giant's epoch: three aggregations forward and three
    backward, each on the [n, 16] bf16 stream."""
    return calls * banded_unit_call(n, width, elsize)
