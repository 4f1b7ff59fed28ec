"""The share of the traced training window in which no kernel or copy ran
on the device, from that trace's own intervals."""


def read(out, cell):
    t = out.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
