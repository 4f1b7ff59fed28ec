"""Dataset (de)serialization and the text graph format loader.

Port of ``gcn_maxcut_tpu/data/io.py``, in the same ``.npz`` layout, so a
file either package writes loads in the other: ``edges_{i}`` and
``weights_{i}`` arrays per graph and a ``_meta`` array of JSON bytes (the
processing config and each graph's index, size, terminals, degree and
whether it is weighted).  Graphs are rebuilt on load.  The text format is
the reference's (``prepareData.ipynb`` cell 2): ``[t1, t2, t3]``, then one
``u v w`` edge per line.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Dict, List

import numpy as np

from gcn_maxcut_tpu_torch.data.generate import GraphSpec
from gcn_maxcut_tpu_torch.data.process import DataConfig, ProcessedDataset, process_graphs


def save_object(obj, path: str | Path) -> None:
    """Pickle helper for reference-format interop (``commons.py:22-25``)."""
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_object(path: str | Path):
    """Unpickle helper (``commons.py:26-36``).  Trusted inputs only:
    unpickling can run arbitrary code."""
    with open(path, "rb") as f:
        return pickle.load(f)


def save_dataset(dataset: ProcessedDataset, path: str | Path) -> None:
    """Write specs and config to one compressed ``.npz``."""
    arrays = {}
    meta: Dict[str, object] = {
        "config": {
            "max_nodes": dataset.config.max_nodes,
            "num_terminals": dataset.config.num_terminals,
            "node_pad_multiple": dataset.config.node_pad_multiple,
            "edge_pad_multiple": dataset.config.edge_pad_multiple,
        },
        "keys": [],
    }
    for i, spec in dataset.specs.items():
        arrays[f"edges_{i}"] = spec.edges
        if spec.weights is not None:
            arrays[f"weights_{i}"] = spec.weights
        meta["keys"].append({
            "index": int(i),
            "n_nodes": spec.n_nodes,
            "terminals": list(spec.terminals),
            "degree": spec.degree,
            "weighted": spec.weights is not None,
        })
    arrays["_meta"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez_compressed(Path(path), **arrays)


def load_dataset(path: str | Path) -> ProcessedDataset:
    """Load a dataset written by either package's ``save_dataset`` and
    process its graphs (tensors on the CPU)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["_meta"]).decode("utf-8"))
        specs: Dict[int, GraphSpec] = {}
        for rec in meta["keys"]:
            i = rec["index"]
            specs[i] = GraphSpec(
                n_nodes=rec["n_nodes"],
                edges=data[f"edges_{i}"],
                terminals=rec["terminals"],
                degree=rec["degree"],
                weights=data[f"weights_{i}"] if rec["weighted"] else None,
            )
    return process_graphs(specs, DataConfig(**meta["config"]))


def load_text_graph(path: str | Path) -> GraphSpec:
    """Parse the reference text format: ``[t1, t2, t3]`` then ``u v [w]``
    lines (weight 1 when missing); edges become (min, max) pairs."""
    lines = Path(path).read_text().strip().splitlines()
    terminals = json.loads(lines[0])
    edges: List[List[int]] = []
    weights: List[float] = []
    for line in lines[1:]:
        parts = line.split()
        if not parts:
            continue
        u, v = int(parts[0]), int(parts[1])
        edges.append([min(u, v), max(u, v)])
        weights.append(float(parts[2]) if len(parts) > 2 else 1.0)
    e = np.asarray(edges, dtype=np.int64)
    n = int(e.max()) + 1 if e.size else max(terminals) + 1
    return GraphSpec(
        n_nodes=n,
        edges=e,
        terminals=[int(t) for t in terminals],
        weights=np.asarray(weights, dtype=np.float32),
    )
