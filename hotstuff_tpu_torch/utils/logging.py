"""Logging setup emitting the reference harness's log format.

Port copy of ``hotstuff_tpu/utils/logging.py``, whole. The benchmark
harness measures by regex-scraping timestamped log lines
(``benchmark/logs.py``); the expected shape is env_logger's:
``[2021-06-01T07:58:01.845Z INFO module] message`` with millisecond UTC
timestamps and WARN (not WARNING) level names, so the reference's
``LogParser`` reads the port's node and client logs unchanged.
"""

from __future__ import annotations

import logging
import sys
import time

_LEVELS = {0: logging.ERROR, 1: logging.WARNING, 2: logging.INFO, 3: logging.DEBUG}


class _EnvLoggerFormatter(logging.Formatter):
    converter = time.gmtime

    def format(self, record: logging.LogRecord) -> str:
        level = {"WARNING": "WARN", "CRITICAL": "ERROR"}.get(
            record.levelname, record.levelname
        )
        ts = time.strftime("%Y-%m-%dT%H:%M:%S", self.converter(record.created))
        ms = int(record.msecs)
        return f"[{ts}.{ms:03d}Z {level} {record.name}] {record.getMessage()}"


def setup_logging(verbosity: int = 2, stream=None) -> None:
    """verbosity: 0=error 1=warn 2=info 3+=debug (reference -v flag
    semantics, ``node/src/main.rs:61-71``)."""
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(_EnvLoggerFormatter())
    root = logging.getLogger()
    root.handlers.clear()
    root.addHandler(handler)
    root.setLevel(_LEVELS.get(verbosity, logging.DEBUG))
