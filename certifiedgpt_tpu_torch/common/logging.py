"""Logger + output-dir plumbing of the PyTorch port.

A copy of ``certifiedgpt_tpu/common/logging.py``: console +
``{output_dir}/certified.log`` file handler, the logger registered in the
port's registry under ``logger`` so any layer can fetch it without passing
handles around.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

from certifiedgpt_tpu_torch.common.registry import registry

LOG_FILE_NAME = "certified.log"


def setup_logger(
    output_dir: Optional[str] = None,
    level: int = logging.INFO,
    name: str = "certifiedgpt_tpu_torch",
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    # Re-running setup (tests, notebooks) must not stack handlers —
    # and must close the old ones (a FileHandler holds certified.log
    # open; dropping it unreferenced leaks the fd)
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        try:
            handler.close()
        except Exception:
            pass

    formatter = logging.Formatter(
        "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
    )

    console = logging.StreamHandler(sys.stdout)
    console.setFormatter(formatter)
    logger.addHandler(console)

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        file_handler = logging.FileHandler(os.path.join(output_dir, LOG_FILE_NAME))
        file_handler.setFormatter(formatter)
        logger.addHandler(file_handler)
        registry.register_path("output_dir", output_dir)

    registry.register("logger", logger)
    return logger


def get_logger() -> logging.Logger:
    logger = registry.get("logger")
    if logger is None:
        logger = setup_logger()
    return logger
