"""Roofline model for SpMM edges/s on the card.

Port of ``gcn_maxcut_tpu/bench/roofline.py`` with the H100's own figure
only (NVIDIA's data sheet, SXM part): 3.35 TB/s of HBM3.  SpMM is bound by
bytes at every width the port runs, so the model holds no compute peak.

The bound is the least traffic any SpMM must make: read x once, read each
directed edge's index and weight once, write y once,

    bytes_per_edge = (2·4·F·n + 8·E) / E        (float32 features)

and the backward of the symmetric operator is one more pass of the same
shape (``FWD_BWD_FACTOR`` = 2).  The JAX package charged a feature-row read
per edge instead (no reuse), which a kernel that stages a window of rows,
or a card whose 50 MB L2 holds much of x, can beat; so that model is no
bound here.  With this one no measured fraction can exceed 1.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float           # device-memory bandwidth, GB/s


_CHIPS = {
    "h100": ChipSpec("NVIDIA H100 SXM", 3350.0),
}


def chip_specs(name: str = "h100") -> ChipSpec:
    if name not in _CHIPS:
        raise ValueError(f"no figures for chip {name!r}; known: {sorted(_CHIPS)}")
    return _CHIPS[name]


@dataclasses.dataclass
class RooflineModel:
    chip: ChipSpec
    feature_dim: int
    n_nodes: int
    n_edges: int              # directed

    @property
    def bytes_per_edge_fwd(self) -> float:
        features = 2 * 4.0 * self.feature_dim * self.n_nodes / max(1, self.n_edges)
        return features + 8.0

    #: fwd+bwd traffic multiple: the backward is one more forward-shaped pass
    FWD_BWD_FACTOR = 2.0

    def edges_per_s(self, fwd_bwd: bool = True) -> float:
        factor = self.FWD_BWD_FACTOR if fwd_bwd else 1.0
        return self.chip.hbm_gbps * 1e9 / (self.bytes_per_edge_fwd * factor)

    def fraction_of_roofline(self, measured_edges_per_s: float, fwd_bwd: bool = True) -> float:
        return measured_edges_per_s / self.edges_per_s(fwd_bwd)
