"""The logging tree and request ids (the JAX package's ``obs/logging_setup.py``).

Four handlers: the console at INFO, ``app_debug.log`` (DEBUG, rotated at
midnight, 3 kept), ``app_main.log`` (INFO, midnight, 7 kept) and
``app_error.log`` (ERROR, rotated at 5 MB, 3 kept), with noisy libraries
held at WARNING. Standard library only.
"""

from __future__ import annotations

import logging
import logging.handlers
import time
import uuid
from pathlib import Path

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"

_NOISY_LIBRARIES = {
    "werkzeug": logging.WARNING,
    "urllib3": logging.WARNING,
    "filelock": logging.WARNING,
}

_configured = False


def setup_logging(log_dir: str | Path = "logs", *, console_level: int = logging.INFO) -> logging.Logger:
    """Configure the root logging tree once; later calls change nothing.
    Returns the root logger."""
    global _configured
    root = logging.getLogger()
    if _configured:
        return root
    _configured = True

    log_path = Path(log_dir)
    log_path.mkdir(parents=True, exist_ok=True)
    formatter = logging.Formatter(_FORMAT)
    root.setLevel(logging.DEBUG)

    console = logging.StreamHandler()
    console.setLevel(console_level)
    handlers = [
        console,
        logging.handlers.TimedRotatingFileHandler(
            log_path / "app_debug.log", when="midnight", backupCount=3),
        logging.handlers.TimedRotatingFileHandler(
            log_path / "app_main.log", when="midnight", backupCount=7),
        logging.handlers.RotatingFileHandler(
            log_path / "app_error.log", maxBytes=5 * 1024 * 1024, backupCount=3),
    ]
    for handler, level in zip(handlers, (console_level, logging.DEBUG, logging.INFO,
                                         logging.ERROR)):
        handler.setLevel(level)
        handler.setFormatter(formatter)
        root.addHandler(handler)

    for name, level in _NOISY_LIBRARIES.items():
        logging.getLogger(name).setLevel(level)
    return root


def new_request_id(short: bool = True) -> str:
    """An 8-character request id (a uuid5 of the clock and a uuid4), or a
    full uuid4 hex with ``short=False``."""
    if short:
        return uuid.uuid5(uuid.NAMESPACE_OID, f"{time.time_ns()}-{uuid.uuid4()}").hex[:8]
    return uuid.uuid4().hex
