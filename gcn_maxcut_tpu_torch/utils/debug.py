"""Debug helpers: port of ``debug_mode`` and ``assert_finite`` of
``gcn_maxcut_tpu/utils/debug.py``.

``debug_mode`` turns on autograd's anomaly detection, where the JAX one
sets ``jax_debug_nans``/``jax_debug_infs``: a backward that produces a NaN
raises and names the forward operation that led to it.  Anomaly detection
has no separate check for infinities, so there is no ``infs`` argument.
``checked`` (``checkify``) is not ported: eager PyTorch raises its errors
where they happen, so no traced error needs surfacing.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Anomaly detection on inside the context (the previous setting is
    restored on exit)."""
    with torch.autograd.set_detect_anomaly(nans, check_nan=nans):
        yield


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in the JAX ``keystr`` notation and JAX's leaf order:
    ``['key']`` for a dict entry (keys sorted), ``[i]`` for a list or tuple
    element."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_finite(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first floating leaf of
    ``tree`` (tensors or arrays in nested dicts, lists and tuples) that holds
    a NaN or an infinity."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and not bool(torch.isfinite(leaf).all())
        else:
            arr = np.asarray(leaf)
            bad = arr.dtype.kind == "f" and not np.isfinite(arr).all()
        if bad:
            raise FloatingPointError(f"non-finite values in {name} at {path}")
