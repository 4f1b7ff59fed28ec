"""Climbs captured per decoded graph: the program's counter
``climb.captures`` (a climb whose step was captured on the card: a new
padded shape, or one dropped and captured again) over the graphs in the
traced window.  Captures exist only on the card."""

from gcn_maxcut_tpu_torch.utils import profiling


def read(out, cell):
    graphs = out.units.get("graphs", 0)
    spans = getattr(profiling, "span_totals", dict)()     # {} where the program has none
    if not out.trace or not graphs or not spans or not cell.device.startswith("cuda"):
        return None
    return profiling.counts().get("climb.captures", 0) / graphs
