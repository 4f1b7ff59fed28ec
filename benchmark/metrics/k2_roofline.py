"""The byte bound of the traced epochs' first-layer aggregations in the
plain giant trainer (``counts/giant_plain.k2_epoch``: two [n, 16] float32
streams an epoch, K2 forward and backward, each read and written once) at
the HBM peak, over the device time of ``halo_stream_kernel`` in the trace
(only K2 launches it in the cells that list this metric)."""

import torch

from benchmark.counts.peaks import peak

KERNEL = "halo_stream_kernel"


def read(out, cell):
    t, epochs = out.trace, out.units.get("epochs", 0)
    if not t or not epochs or not cell.device.startswith("cuda"):
        return None
    seconds = sum(v for k, v in t["kernel_s"].items() if KERNEL in k)
    p = peak(torch.cuda.get_device_name(0))
    if seconds <= 0 or p is None:
        return None
    bound = out.info["k2_bytes_per_epoch"] * epochs / p["hbm_bytes_per_s"]
    return 100.0 * bound / seconds
