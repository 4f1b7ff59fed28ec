"""The byte bound of the traced epochs' class-wide aggregations in the
plain giant trainer (``counts/giant_plain.f3_epoch``: four [n, 3] float32
streams an epoch, the second layer's and the loss's, forward and backward,
each read and written once) at the HBM peak, over the device time of
``banded_window_kernel`` (``csrc/banded_window.cu``, the body that takes
rows that are not 16-byte pieces) in the trace."""

import torch

from benchmark.counts.peaks import peak

KERNEL = "banded_window_kernel"


def read(out, cell):
    t, epochs = out.trace, out.units.get("epochs", 0)
    if not t or not epochs or not cell.device.startswith("cuda"):
        return None
    seconds = sum(v for k, v in t["kernel_s"].items() if KERNEL in k)
    p = peak(torch.cuda.get_device_name(0))
    if seconds <= 0 or p is None:
        return None
    bound = out.info["f3_bytes_per_epoch"] * epochs / p["hbm_bytes_per_s"]
    return 100.0 * bound / seconds
