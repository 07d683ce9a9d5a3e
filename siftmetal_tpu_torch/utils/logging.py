"""Structured logging for pipeline counters and events.

The port's copy of ``siftmetal_tpu/utils/logging.py``: one stdlib-logging
namespace (``siftmetal_tpu_torch.*``) plus helpers that turn the
pipeline's counter dicts (0-dim tensors on any device, arrays or ints)
into structured records.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, Mapping

_ROOT = "siftmetal_tpu_torch"


def get_logger(subsystem: str = "") -> logging.Logger:
    name = f"{_ROOT}.{subsystem}" if subsystem else _ROOT
    return logging.getLogger(name)


def configure(level: int = logging.INFO, json_lines: bool = False) -> None:
    """Opt-in default handler: human-readable or JSON-lines."""
    logger = logging.getLogger(_ROOT)
    logger.setLevel(level)
    if logger.handlers:
        return
    handler = logging.StreamHandler()
    if json_lines:
        class _Json(logging.Formatter):
            def format(self, record):
                payload = {
                    "logger": record.name,
                    "level": record.levelname,
                    "msg": record.getMessage(),
                }
                extra = getattr(record, "counters", None)
                if extra:
                    payload["counters"] = extra
                return json.dumps(payload)

        handler.setFormatter(_Json())
    else:
        handler.setFormatter(
            logging.Formatter("%(name)s %(levelname)s %(message)s")
        )
    logger.addHandler(handler)


def log_counters(
    counters: Mapping[str, object], subsystem: str = "extract",
    level: int = logging.INFO,
) -> Dict[str, int]:
    """Materialize a pipeline's counter dict and log it structured.

    Returns the plain-int dict (also usable for metrics export). Warns
    when any overflow counter is nonzero — the failure mode the reference
    leaves silent."""
    plain = {k: int(v) for k, v in counters.items()}
    logger = get_logger(subsystem)
    logger.log(level, "counters %s", plain, extra={"counters": plain})
    overflow = sum(v for k, v in plain.items() if "overflow" in k)
    if overflow:
        logger.warning(
            "%d detections dropped to static budgets "
            "(raise SiftConfig.max_* limits)",
            overflow,
        )
    return plain
