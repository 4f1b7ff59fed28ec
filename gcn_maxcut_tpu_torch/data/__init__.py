"""data: see the counterpart in gcn_maxcut_tpu/data/."""
