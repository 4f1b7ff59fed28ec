"""The byte bound of the traced epochs' banded aggregations
(``counts/bytes.py``: six [n, 16] bf16 streams an epoch, each read and
written once) at the HBM peak, over the device time of
``halo_stream_kernel`` in the trace."""

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
    bound = out.info["k3_bytes_per_epoch"] * epochs / p["hbm_bytes_per_s"]
    return 100.0 * bound / seconds
