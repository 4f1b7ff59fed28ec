"""utils: see the counterpart in gcn_maxcut_tpu/utils/.

JAX's ``enable_compilation_cache`` (XLA's persistent cache) is not ported.
"""

from gcn_maxcut_tpu_torch.utils.logging import get_logger
from gcn_maxcut_tpu_torch.utils.timing import PhaseTimer, Timer

__all__ = ["get_logger", "Timer", "PhaseTimer"]
