"""Logging setup.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/utils/logger.py``
(``setup_logger`` :11, ``get_logger`` :50; reference utils/logger.py:7):
the ``cmpl_torch`` logger writes to the standard output on rank 0 and to
``save_dir/log.txt.rank{rank}``.  The rank is an argument (0 for one
process).  A later call with another ``save_dir`` moves the file output
there, so one process can run several trainings one after the other.
"""

import logging
import os
import sys
from typing import Optional

ROOT = "cmpl_torch"


class _StdoutHandler(logging.StreamHandler):
    """Writes to whatever ``sys.stdout`` is when a record is emitted (a
    handler bound to the stream of its creation would write to a closed
    stream once a caller has swapped ``sys.stdout``)."""

    def __init__(self):
        super().__init__(sys.stdout)

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, _value):
        pass


def setup_logger(
    name: str = ROOT,
    save_dir: Optional[str] = None,
    rank: int = 0,
    filename: str = "log.txt",
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    if rank == 0 and not any(isinstance(h, _StdoutHandler) for h in logger.handlers):
        ch = _StdoutHandler()
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(fmt)
        logger.addHandler(ch)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.abspath(os.path.join(save_dir, f"{filename}.rank{rank}"))
        for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
            if h.baseFilename != path:
                logger.removeHandler(h)
                h.close()
        if not any(isinstance(h, logging.FileHandler) for h in logger.handlers):
            fh = logging.FileHandler(path)
            fh.setLevel(logging.DEBUG)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger


def get_logger(suffix: str = "") -> logging.Logger:
    return logging.getLogger(ROOT + (f".{suffix}" if suffix else ""))
