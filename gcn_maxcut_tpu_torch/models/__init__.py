"""models: see the counterpart in gcn_maxcut_tpu/models/.

JAX's ``gcn_softmax_init`` is ``GCNSoftmax.init`` here: the model is an
``nn.Module`` that owns its parameters.
"""

from gcn_maxcut_tpu_torch.models.gcn import (
    GCNParams,
    GCNSoftmax,
    GCNSoftmaxParams,
    count_params,
    embedding_init,
    gcn_conv_apply,
    gcn_conv_init,
    gcn_dev_apply,
    gcn_dev_init,
    gcn_softmax_apply,
)

__all__ = [
    "GCNParams",
    "GCNSoftmaxParams",
    "gcn_conv_init",
    "gcn_conv_apply",
    "GCNSoftmax",
    "gcn_softmax_apply",
    "gcn_dev_init",
    "gcn_dev_apply",
    "embedding_init",
    "count_params",
]
