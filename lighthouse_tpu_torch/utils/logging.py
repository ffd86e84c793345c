"""Structured logging with metrics integration.

The `common/logging` analog: slog-style key-value structured records over
the stdlib logging backend, plus a `MetricsHandler` that counts emitted
records per level into the global metrics registry (logging/src/lib.rs:
17-37 MetricsLayer) so log volume is observable."""

from __future__ import annotations

import logging
import sys
import time

from ..metrics import inc_counter

_FIELD_SEP = ", "


class StructuredAdapter(logging.LoggerAdapter):
    """`log.info("imported block", slot=5, root="0x…")` — kwargs become
    key=value fields appended to the message."""

    def process(self, msg, kwargs):
        extra_fields = {
            k: kwargs.pop(k)
            for k in list(kwargs)
            if k not in ("exc_info", "stack_info", "stacklevel", "extra")
        }
        if extra_fields:
            fields = _FIELD_SEP.join(f"{k}={v}" for k, v in extra_fields.items())
            msg = f"{msg} [{fields}]"
        return msg, kwargs


class MetricsHandler(logging.Handler):
    """Counts records per level (the MetricsLayer analog)."""

    def emit(self, record):
        inc_counter("log_records_total", level=record.levelname.lower())


_CONFIGURED = False


def get_logger(name: str = "lighthouse_tpu_torch", level=logging.INFO) -> StructuredAdapter:
    global _CONFIGURED
    base = logging.getLogger(name)
    if not _CONFIGURED:
        root = logging.getLogger("lighthouse_tpu_torch")
        root.setLevel(level)
        if not any(isinstance(h, MetricsHandler) for h in root.handlers):
            root.addHandler(MetricsHandler())
        if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(
                logging.Formatter(
                    "%(asctime)s %(levelname)-5s %(name)s: %(message)s"
                )
            )
            root.addHandler(h)
        _CONFIGURED = True
    return StructuredAdapter(base, {})
