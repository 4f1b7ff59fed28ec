"""Share of the card's climbs that ``csrc/climb.cu`` ran, in %: the
program's counters ``climb.kernel`` over ``climb.runs`` (every climb on the
card) in the traced window.  Nothing where the program counts no climb
runs, or off the card."""

from gcn_maxcut_tpu_torch.utils import profiling


def read(out, cell):
    graphs = out.units.get("graphs", 0)
    runs = getattr(profiling, "counts", dict)().get("climb.runs", 0)
    if not out.trace or not graphs or not runs or not cell.device.startswith("cuda"):
        return None
    return 100.0 * profiling.counts().get("climb.kernel", 0) / runs
