"""Bytes of the plain giant trainer's aggregations an epoch
(``bench/giant_demo.train_banded_giant``, node order, float32 streams),
counted from shapes by ``bytes.banded_unit_call``: each input byte read
once and each output byte written once."""

from __future__ import annotations

from benchmark.counts.bytes import banded_unit_call


def k2_epoch(n: int, hidden: int = 16, elsize: int = 4) -> float:
    """K2 at r = 1 on the [n, hidden] stream: the first layer's
    aggregation forward and its adjoint backward."""
    return 2 * banded_unit_call(n, hidden, elsize)


def f3_epoch(n: int, classes: int = 3, elsize: int = 4) -> float:
    """The class-wide body on [n, classes] rows: the second layer's
    aggregation and the loss's ⟨S, A S⟩, each forward and backward."""
    return 4 * banded_unit_call(n, classes, elsize)
