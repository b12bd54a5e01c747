"""Minimal structured logging for the port (no external deps)."""
from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"
_configured = False


def get_logger(name: str = "repro_torch") -> logging.Logger:
    """A logger under the ``repro_torch`` root, which writes to stderr."""
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root = logging.getLogger("repro_torch")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True
    return logging.getLogger(name if name.startswith("repro_torch") else f"repro_torch.{name}")
