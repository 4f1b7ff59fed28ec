"""Host milliseconds a sharded giant job spends before its steady epochs:
the program's spans ``sharded.partition`` (node -> shard),
``sharded.assemble`` (the shards' tables and their move to the device),
``sharded.setup`` (the parameters' placement, Adam's state, the chunk
callable) and ``chunk.capture`` (the warm-up epoch and the capture) over
the jobs in the traced window."""

from gcn_maxcut_tpu_torch.utils import profiling

SPANS = ("sharded.partition", "sharded.assemble", "sharded.setup", "chunk.capture")


def read(out, cell):
    jobs = out.units.get("jobs", 0)
    spans = getattr(profiling, "span_totals", dict)()     # {} where the program has none
    if not out.trace or not jobs or "sharded.setup" not in spans:
        return None
    return sum(spans.get(name, {}).get("total_s", 0.0) for name in SPANS) * 1e3 / jobs
