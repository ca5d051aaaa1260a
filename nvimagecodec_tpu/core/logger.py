"""Logging / debug messenger.

Counterpart of the reference's debug-messenger architecture
(reference: src/logger.h, src/default_debug_messenger.h,
include/nvimgcodec.h:717-793 — severity×category filtered fan-out to user
callbacks). Python `logging` provides the default sink with a severity knob
read from `TPUIMGCODEC_VERBOSITY` (reference analog: PYNVIMGCODEC_VERBOSITY,
python/module.cpp:50-72); `register_debug_messenger` adds user callbacks
filtered by severity and category bitmasks, mirroring
nvimgcodecDebugMessengerDesc (include/nvimgcodec.h:769-793).
"""
from __future__ import annotations

import enum
import logging
import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

_CONFIGURED = False


class DebugMessageSeverity(enum.IntFlag):
    """Bitmask severities (reference: nvimgcodecDebugMessageSeverity_t,
    include/nvimgcodec.h:717-733)."""

    TRACE = 1
    DEBUG = 2
    INFO = 4
    WARNING = 8
    ERROR = 16
    FATAL = 32
    ALL = TRACE | DEBUG | INFO | WARNING | ERROR | FATAL
    DEFAULT = WARNING | ERROR | FATAL


class DebugMessageCategory(enum.IntFlag):
    """Bitmask categories (reference: nvimgcodecDebugMessageCategory_t,
    include/nvimgcodec.h:735-747)."""

    GENERAL = 1
    PLUGIN = 2
    PERFORMANCE = 4
    ALL = GENERAL | PLUGIN | PERFORMANCE


@dataclass
class DebugMessageData:
    """Payload handed to callbacks (reference: nvimgcodecDebugMessageData_t,
    include/nvimgcodec.h:749-767)."""

    message: str
    code: int = 0
    codec_id: Optional[str] = None
    instance_name: Optional[str] = None


# Callback signature: (severity, category, data) -> None
DebugCallback = Callable[[DebugMessageSeverity, DebugMessageCategory, DebugMessageData], None]


@dataclass
class _Messenger:
    callback: DebugCallback
    severities: int = int(DebugMessageSeverity.DEFAULT)
    categories: int = int(DebugMessageCategory.ALL)


_messengers: Dict[int, _Messenger] = {}
_messengers_lock = threading.Lock()
_next_handle = 1

_SEV_TO_LOGGING = {
    DebugMessageSeverity.TRACE: logging.DEBUG,
    DebugMessageSeverity.DEBUG: logging.DEBUG,
    DebugMessageSeverity.INFO: logging.INFO,
    DebugMessageSeverity.WARNING: logging.WARNING,
    DebugMessageSeverity.ERROR: logging.ERROR,
    DebugMessageSeverity.FATAL: logging.CRITICAL,
}


def register_debug_messenger(
    callback: DebugCallback,
    severities: int = int(DebugMessageSeverity.DEFAULT),
    categories: int = int(DebugMessageCategory.ALL),
) -> int:
    """Register a user debug callback; returns a handle for unregistering
    (reference: nvimgcodecDebugMessengerCreate, src/nvimgcodec_director.cpp
    messenger registration)."""
    global _next_handle
    with _messengers_lock:
        handle = _next_handle
        _next_handle += 1
        _messengers[handle] = _Messenger(callback, int(severities), int(categories))
        return handle


def unregister_debug_messenger(handle: int) -> bool:
    """Remove a previously registered callback
    (reference: nvimgcodecDebugMessengerDestroy)."""
    with _messengers_lock:
        return _messengers.pop(handle, None) is not None


def emit(
    severity: DebugMessageSeverity,
    category: DebugMessageCategory,
    message: str,
    *,
    code: int = 0,
    codec_id: Optional[str] = None,
    instance_name: Optional[str] = None,
    logger_name: str = "nvimagecodec_tpu",
) -> None:
    """Fan a message out to every registered callback whose severity and
    category masks match, then to Python logging (reference: Logger::log,
    src/logger.h — iterates messengers, filters by mask)."""
    with _messengers_lock:
        targets = [
            m
            for m in _messengers.values()
            if (m.severities & int(severity)) and (m.categories & int(category))
        ]
    if targets:
        data = DebugMessageData(
            message=message, code=code, codec_id=codec_id, instance_name=instance_name
        )
        for m in targets:
            try:
                m.callback(severity, category, data)
            except Exception:  # user callback must not break the pipeline
                logging.getLogger(logger_name).exception("debug messenger callback raised")
    get_logger(logger_name).log(_SEV_TO_LOGGING.get(severity, logging.INFO), "%s", message)


def _configure() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    verbosity = int(os.environ.get("TPUIMGCODEC_VERBOSITY", "1"))
    level = {
        0: logging.CRITICAL,  # silent
        1: logging.WARNING,
        2: logging.INFO,
        3: logging.DEBUG,
    }.get(verbosity, logging.DEBUG if verbosity > 3 else logging.WARNING)
    logging.basicConfig(
        level=level,
        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s",
    )
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    _configure()
    return logging.getLogger(name)
