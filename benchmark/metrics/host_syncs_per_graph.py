"""Host waits on the device per decoded graph: the trace's runtime calls
cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize and
the blocking cudaMemcpy, over the graphs in the trace."""

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def read(out, cell):
    t, graphs = out.trace, out.units.get("graphs", 0)
    if not t or not graphs or not cell.device.startswith("cuda"):
        return None
    return sum(t["runtime"].get(name, 0) for name in SYNCS) / graphs
