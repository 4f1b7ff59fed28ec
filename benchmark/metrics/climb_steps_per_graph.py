"""Lockstep climb steps per decoded graph: the program's counter
``climb.steps`` over the graphs in the traced window."""

from gcn_maxcut_tpu_torch.utils import profiling


def read(out, cell):
    graphs = out.units.get("graphs", 0)
    spans = getattr(profiling, "span_totals", dict)()     # {} where the program has none
    if not out.trace or not graphs or not spans:
        return None
    return profiling.counts().get("climb.steps", 0) / graphs
