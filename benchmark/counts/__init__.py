"""The operations and bytes the configurations' work needs, counted from
shapes (the yardstick of ``train_mfu`` and ``k3_roofline``), and the
table of peaks."""
