"""data: see the counterpart in gcn_maxcut_tpu/data/."""

from gcn_maxcut_tpu_torch.data.generate import (
    generate_graph,
    generate_graph_dataset,
    generate_unique_terminals,
    gnp_edges,
    random_regular_edges,
    regular_graph_on_device,
)
from gcn_maxcut_tpu_torch.data.io import (
    load_dataset,
    load_object,
    load_text_graph,
    save_dataset,
    save_object,
)
from gcn_maxcut_tpu_torch.data.process import (
    DataConfig,
    ProcessedDataset,
    normalize_terminals,
    process_graphs,
)

__all__ = [
    "generate_graph",
    "generate_unique_terminals",
    "generate_graph_dataset",
    "random_regular_edges",
    "gnp_edges",
    "regular_graph_on_device",
    "normalize_terminals",
    "process_graphs",
    "ProcessedDataset",
    "DataConfig",
    "save_dataset",
    "load_dataset",
    "save_object",
    "load_object",
    "load_text_graph",
]
