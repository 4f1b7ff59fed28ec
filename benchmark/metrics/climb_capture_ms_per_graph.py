"""Host milliseconds of captures per decoded graph: the program's span
``chunk.capture`` (a runner's warm-up step and capture; in the decode
window only climbs capture) over the graphs in the traced window.
Captures exist only on the card."""

from gcn_maxcut_tpu_torch.utils import profiling


def read(out, cell):
    graphs = out.units.get("graphs", 0)
    spans = getattr(profiling, "span_totals", dict)()     # {} where the program has none
    if not out.trace or not graphs or not spans or not cell.device.startswith("cuda"):
        return None
    return spans.get("chunk.capture", {}).get("total_s", 0.0) * 1e3 / graphs
