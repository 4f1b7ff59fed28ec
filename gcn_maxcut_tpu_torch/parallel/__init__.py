"""parallel: see the counterpart in gcn_maxcut_tpu/parallel/.

So far the node-sharded banded path: ``mesh.py`` (a ring of torch devices)
and ``giant_banded.py`` (the halo giant trainers on K5 and K6).
"""

from gcn_maxcut_tpu_torch.parallel.mesh import Mesh, device_count, make_mesh

__all__ = ["Mesh", "device_count", "make_mesh"]
