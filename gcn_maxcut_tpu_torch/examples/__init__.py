"""examples: the scripts of the repo's ``examples/`` on the port.

One module per script, with the same names; each has a ``main`` with the
JAX script's arguments plus ``device`` (default: the CUDA device) and runs
as ``python -m gcn_maxcut_tpu_torch.examples.<name>``.
``visualization_demo`` only renders saved results and takes no device.
"""
