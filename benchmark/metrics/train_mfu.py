"""Model FLOPs of the traced epochs (``counts/flops.py``) over the traced
window, as a share of the device's float32 peak (``counts/peaks.py``)."""

import torch

from benchmark.counts.peaks import peak


def read(out, cell):
    t, epochs = out.trace, out.units.get("epochs", 0)
    if not t or not epochs or t["window_s"] <= 0 or not cell.device.startswith("cuda"):
        return None
    p = peak(torch.cuda.get_device_name(0))
    if p is None:
        return None
    return 100.0 * out.info["flops_per_epoch"] * epochs / t["window_s"] / p["f32_flops"]
