"""Host milliseconds of the decode's forward per graph: the program's span
``decode.forward`` (both dense operators and the two-layer forward) over
the graphs in the traced window."""

from gcn_maxcut_tpu_torch.utils import profiling


def read(out, cell):
    graphs = out.units.get("graphs", 0)
    spans = getattr(profiling, "span_totals", dict)()     # {} where the program has none
    if not out.trace or not graphs or "decode.forward" not in spans:
        return None
    return spans["decode.forward"]["total_s"] * 1e3 / graphs
