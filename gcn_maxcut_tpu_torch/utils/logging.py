"""Structured logging: port of ``gcn_maxcut_tpu/utils/logging.py``.

``get_logger`` gives a logger under the port's package name; the first call
gives the package's logger one stderr handler (unless it has one) and the
INFO level, as the JAX package does for its own name.
"""

from __future__ import annotations

import logging
import sys

ROOT = "gcn_maxcut_tpu_torch"
_CONFIGURED = False


def get_logger(name: str = ROOT) -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        root = logging.getLogger(ROOT)
        if not root.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(
                logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
            root.addHandler(handler)
        root.setLevel(logging.INFO)
        _CONFIGURED = True
    return logging.getLogger(name)
