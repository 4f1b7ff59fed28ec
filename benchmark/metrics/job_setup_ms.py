"""Host milliseconds a giant job spends before its steady epochs: the
program's spans ``giant.setup`` (the parameters' copy to the device, the
closures, Adam's state, the chunk callable) and ``chunk.capture`` (the
warm-up epoch and the capture) over the jobs in the traced window."""

from gcn_maxcut_tpu_torch.utils import profiling


def read(out, cell):
    jobs = out.units.get("jobs", 0)
    spans = getattr(profiling, "span_totals", dict)()     # {} where the program has none
    if not out.trace or not jobs or "giant.setup" not in spans:
        return None
    capture = spans.get("chunk.capture", {}).get("total_s", 0.0)
    return (spans["giant.setup"]["total_s"] + capture) * 1e3 / jobs
