"""Published peaks (NVIDIA's data sheet, H100 SXM, dense, at 700 W): float32
outside the tensor cores (the port turns TF32 off) and HBM bandwidth."""

from __future__ import annotations

PEAKS = {
    "H100": {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peak(kind: str) -> dict | None:
    """The peaks of the device named ``kind`` (``torch.cuda.get_device_name``),
    or None for a device not in the table."""
    for key, value in PEAKS.items():
        if key in kind:
            return value
    return None
