"""Rank-prefixed logging.

Counterpart of ``torchmpi_tpu/utils/logging.py``: every line carries
``[rank/size]``; ``LOG_TO_FILE=1`` writes one file per rank and keeps the
console for rank 0 only (the reference's ``wrap.sh`` behaviour).  The rank
is this process's ``torch.distributed`` rank.
"""

from __future__ import annotations

import logging
import os
import sys

_configured: set = set()


def get_logger(name: str = "torchmpi_tpu_torch") -> logging.Logger:
    """Process logger with a ``[rank/size]`` prefix.

    * default: every rank logs to stderr;
    * ``LOG_TO_FILE=1``: each process writes ``<dir>/rank_<r>.log`` and
      only rank 0 keeps the console; the directory is
      ``TORCHMPI_TPU_LOG_DIR`` (default ``torchmpi_tpu_logs`` under the
      working directory).

    The level is ``TORCHMPI_TPU_LOG_LEVEL``, else DEBUG when the
    ``verbose`` knob is set, else INFO; it is read once per logger name,
    at its first use."""
    logger = logging.getLogger(name)
    if name in _configured:
        return logger
    _configured.add(name)

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        rank, size = 0, 1
    fmt = logging.Formatter(
        f"[{rank}/{size}] %(asctime)s %(levelname).1s %(name)s: %(message)s",
        datefmt="%H:%M:%S")
    level = os.environ.get("TORCHMPI_TPU_LOG_LEVEL")
    if level is None:
        from ..runtime import config

        level = "DEBUG" if int(config.get("verbose")) else "INFO"
    logger.setLevel(level)
    logger.propagate = False

    if os.environ.get("LOG_TO_FILE") == "1":
        log_dir = os.environ.get("TORCHMPI_TPU_LOG_DIR", "torchmpi_tpu_logs")
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, f"rank_{rank}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
        if rank != 0:
            return logger
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    return logger
