"""Host milliseconds an epoch spends launching its replayed CUDA graph: the
program's span ``chunk.replay`` (the loop of ``graph.replay()`` calls)
over the epochs in the traced window.  Replays exist only on the card."""

from gcn_maxcut_tpu_torch.utils import profiling


def read(out, cell):
    epochs = out.units.get("epochs", 0)
    spans = getattr(profiling, "span_totals", dict)()     # {} where the program has none
    if not out.trace or not epochs or "chunk.replay" not in spans:
        return None
    return spans["chunk.replay"]["total_s"] * 1e3 / epochs
