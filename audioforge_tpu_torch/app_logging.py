"""Non-realtime log plumbing for the supervisor/control threads.

Behavioral contract (mirrors `python/mic_eq/app_logging.py`): log lines
land in ``<config dir>/AudioForge/logs/app.log`` rotated at 1 MB with
3 backups, repeat configuration attaches no duplicate handler, and the
root logger never sits above INFO once configured. Nothing here may be
called from the RT/audio path — logging is host-thread-only by design.
"""

from __future__ import annotations

import logging
import os
from logging.handlers import RotatingFileHandler
from pathlib import Path

__all__ = ["configure_app_logging", "get_log_file"]

LOG_DIR_NAME = "AudioForge"
LOG_FILE_MAX_BYTES = 1_000_000
LOG_FILE_BACKUP_COUNT = 3

_LINE_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def get_log_file() -> Path:
    """Where runtime logs are written for this platform."""
    if os.name == "nt":
        base = os.environ.get("APPDATA") or str(Path.home())
    else:
        base = os.environ.get("XDG_CONFIG_HOME") or str(Path.home() / ".config")
    return Path(base, LOG_DIR_NAME, "logs", "app.log")


def _already_attached(logger: logging.Logger, target: Path) -> bool:
    """True when some rotating handler on ``logger`` already owns ``target``."""
    for h in logger.handlers:
        if not isinstance(h, RotatingFileHandler):
            continue
        if Path(h.baseFilename) == target:
            return True
    return False


def configure_app_logging() -> Path:
    """Attach the rotating file handler once; return the log path.

    Safe to call from every entry point — a second call on the same
    interpreter is a no-op beyond returning the path.
    """
    target = get_log_file()
    target.parent.mkdir(parents=True, exist_ok=True)

    root = logging.getLogger()
    if not _already_attached(root, target):
        sink = RotatingFileHandler(
            target,
            maxBytes=LOG_FILE_MAX_BYTES,
            backupCount=LOG_FILE_BACKUP_COUNT,
            encoding="utf-8",
        )
        sink.setFormatter(logging.Formatter(_LINE_FORMAT))
        root.addHandler(sink)
        # NOTSET (0) means "unconfigured", which logging treats as WARNING
        # at the root — pull it down so INFO-level runtime events persist.
        if root.level == logging.NOTSET or root.level > logging.INFO:
            root.setLevel(logging.INFO)
    return target
