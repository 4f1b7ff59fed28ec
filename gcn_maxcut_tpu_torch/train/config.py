"""Training configuration: port of ``gcn_maxcut_tpu/train/config.py``.

Field-for-field superset of the reference dataclass
(``Training/TrainingNeural.py:36-67``), with the same defaulting rules:
``dim_embedding`` defaults to ``n_nodes``; ``hidden_dim`` to
``dim_embedding // 2``.  The fields and their checks are the JAX
package's, so one configuration means the same run in both, every value
included (``batched`` steps, the cosine schedule, the quantile and entropy
losses).  ``epochs_per_call`` is the epochs of one chunk
(``train/chunks.py``): one captured CUDA graph replayed that many times on
the card, eager epochs on the CPU, the losses read once a chunk; any value
gives the same run.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    # Model parameters
    n_nodes: int = 1000
    dim_embedding: Optional[int] = None    # defaults to n_nodes
    hidden_dim: Optional[int] = None       # defaults to dim_embedding // 2
    dropout: float = 0.0
    number_classes: int = 3

    # Training parameters
    learning_rate: float = 0.001
    number_epochs: int = 1000
    tolerance: float = 1e-4
    patience: int = 20
    prob_threshold: float = 0.5

    # Loss parameters
    A: float = 0.0
    C: float = 1.0
    penalty: float = 1000.0                # only applied if use_penalty

    # Saving parameters
    save_directory: Optional[str] = None   # model name stem; None = no saving
    save_frequency: int = 100

    # Extensions of the JAX package (no reference analog)
    feature_mode: str = "adjacency"        # "adjacency" | "embedding"
    use_penalty: bool = False              # reference keeps it commented out
    seed: int = 0
    log_every: Optional[int] = None        # defaults to save_frequency
    epochs_per_call: int = 1               # epochs a chunk (one host read)
    step_mode: str = "per_graph"           # "per_graph" | "batched"
    lr_schedule: str = "constant"          # "constant" | "cosine"
    lr_final_fraction: float = 0.05
    loss_mode: str = "ste"                 # "ste" | "quantile"
    quantile_c: float = 2.6
    entropy_weight: float = 0.0
    aggregation: str = "auto"              # "auto" | "sparse" | "dense"

    def __post_init__(self):
        if self.dim_embedding is None:
            object.__setattr__(self, "dim_embedding", self.n_nodes)
        if self.hidden_dim is None:
            object.__setattr__(self, "hidden_dim", self.dim_embedding // 2)
        if self.log_every is None:
            object.__setattr__(self, "log_every", self.save_frequency)
        if self.feature_mode not in ("adjacency", "embedding"):
            raise ValueError(f"unknown feature_mode {self.feature_mode!r}")
        if self.aggregation not in ("auto", "sparse", "dense"):
            raise ValueError(f"unknown aggregation {self.aggregation!r}")
        if self.step_mode not in ("per_graph", "batched"):
            raise ValueError(f"unknown step_mode {self.step_mode!r}")
        if self.lr_schedule not in ("constant", "cosine"):
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}")
        if self.loss_mode not in ("ste", "quantile"):
            raise ValueError(f"unknown loss_mode {self.loss_mode!r}")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "TrainingConfig":
        return cls(**json.loads(s))
