"""Logging/observability configuration (SURVEY.md §5.5).

Mirrors the reference's ``config.logging.json``: a rotating
``logs/overseer.log`` (100 MB × 10) on the root logger, a separate
rotating ``logs/protocol.log`` carrying the full decoded-frame firehose
(``protocol.<instance>`` loggers, non-propagating — reference
p25_control_demod.py:62,535), and console output for the
``overseer.quality`` health lines (the documented operational health
check is grepping "System Status" lines, reference README.md:103).

Usage::

    from radiocapture_tpu_torch.utils.logconfig import setup_logging
    setup_logging("logs")                  # site/overseer processes
    log = logging.getLogger("protocol." + instance_uuid)

Multiprocess safety: the reference wraps handlers with
``multiprocessing_logging`` (overseer.py:56-59); here per-source OS
workers each call ``setup_logging`` with their own ``log_dir`` (or rely
on the Supervisor passing ``suffix=worker_name``) so rotating files are
never shared across processes — the TPU build's workers are few and
long-lived, unlike the reference's per-channel process zoo.
"""

from __future__ import annotations

import logging
import logging.config
import os

_FORMAT = ("[%(asctime)s] (%(filename)s:%(lineno)d) - %(name)s - "
           "%(levelname)s - %(message)s")


def logging_dict(log_dir: str = "logs", suffix: str = "",
                 max_bytes: int = 100 * 1024 * 1024,
                 backup_count: int = 10,
                 console_level: str = "INFO") -> dict:
    """The dictConfig tree (reference config.logging.json:1-62)."""
    tag = f".{suffix}" if suffix else ""
    return {
        "version": 1,
        "disable_existing_loggers": False,
        "formatters": {"simple": {"format": _FORMAT}},
        "handlers": {
            "console": {
                "class": "logging.StreamHandler",
                "formatter": "simple",
                "level": console_level,
                "stream": "ext://sys.stdout",
            },
            "file_handler": {
                "class": "logging.handlers.RotatingFileHandler",
                "formatter": "simple",
                "level": "INFO",
                "filename": os.path.join(log_dir, f"overseer{tag}.log"),
                "maxBytes": max_bytes,
                "backupCount": backup_count,
                "encoding": "utf8",
            },
            "protocol_handler": {
                "class": "logging.handlers.RotatingFileHandler",
                "formatter": "simple",
                "level": "INFO",
                "filename": os.path.join(log_dir, f"protocol{tag}.log"),
                "maxBytes": max_bytes,
                "backupCount": backup_count,
                "encoding": "utf8",
            },
        },
        "loggers": {
            "overseer.quality": {"handlers": ["console"]},
            "protocol": {"handlers": ["protocol_handler"],
                         "propagate": False},
        },
        "root": {"handlers": ["file_handler"], "level": "INFO"},
    }


def setup_logging(log_dir: str = "logs", suffix: str = "",
                  **kw) -> None:
    os.makedirs(log_dir, exist_ok=True)
    logging.config.dictConfig(logging_dict(log_dir, suffix, **kw))


def protocol_logger(instance_uuid: str) -> logging.Logger:
    """Per-instance decoded-frame firehose logger
    (p25_control_demod.py:62)."""
    return logging.getLogger(f"protocol.{instance_uuid}")
