"""Leveled singleton logger.

Capability parity with the reference logger (reference: src/logger.ts:11-47):
four levels, emoji-prefixed colored console output, global singleton. Unlike
the reference — where only `info` respects the level and warning/error/debug
always print (src/logger.ts:29-44) — every level here is gated consistently,
and output is structured enough to grep.

Structured JSON mode (SYMMETRY_LOG_JSON=1 or set_json_mode(True)): every
record becomes one JSON line on stderr — `{"ts", "t_mono", "level",
"msg"}` plus the ambient `trace_id`/`request_id`/`component` from
log_context(), so log lines correlate with the request-tracing timeline
(utils/trace.py) by the same ids AND the same monotonic clock (`t_mono`
is CLOCK_MONOTONIC — the clock every span and metric ring stamps — so a
log line lands on the merged timeline without wall-clock reconciliation).
The context rides a contextvars.ContextVar: set once around a request's
handling, stamped on every record logged inside it (async tasks inherit
it across awaits; other requests' tasks never see it). `component` names
the subsystem that logged (provider/host/scheduler/slo/...): set a
process-wide default once with set_component(), override per block via
log_context(component=...) — the SLO monitor's breach events log as
component "slo" with the breaching request's trace_id already ambient.
"""

from __future__ import annotations

import contextlib
import contextvars
import enum
import json
import os
import sys
import threading
import time

_log_ctx: contextvars.ContextVar[dict[str, str]] = contextvars.ContextVar(
    "symmetry_log_ctx", default={})


@contextlib.contextmanager
def log_context(trace_id: str = "", request_id: str = "",
                component: str = ""):
    """Stamp trace_id/request_id/component on every record logged inside
    the block (and inside anything it awaits/spawns via context
    inheritance)."""
    ctx = {**_log_ctx.get()}
    if trace_id:
        ctx["trace_id"] = trace_id
    if request_id:
        ctx["request_id"] = request_id
    if component:
        ctx["component"] = component
    token = _log_ctx.set(ctx)
    try:
        yield
    finally:
        _log_ctx.reset(token)


# Process-wide default `component` (e.g. the engine host sets "host"
# once at startup); log_context(component=...) overrides per block.
_default_component = ""


def set_component(name: str) -> None:
    global _default_component
    _default_component = name


class LogLevel(enum.IntEnum):
    ERROR = 0
    WARNING = 1
    INFO = 2
    DEBUG = 3


_COLORS = {
    LogLevel.ERROR: "\x1b[31m",    # red
    LogLevel.WARNING: "\x1b[33m",  # yellow
    LogLevel.INFO: "\x1b[36m",     # cyan
    LogLevel.DEBUG: "\x1b[2m",     # dim
}
_EMOJI = {
    LogLevel.ERROR: "❌",
    LogLevel.WARNING: "⚠️ ",
    LogLevel.INFO: "ℹ️ ",
    LogLevel.DEBUG: "🔍",
}
_RESET = "\x1b[0m"


def _level_from_env(value: str | None) -> LogLevel:
    """Tolerant parse: number or name; bad values fall back to INFO."""
    if not value:
        return LogLevel.INFO
    try:
        return LogLevel(int(value))
    except ValueError:
        pass
    try:
        return LogLevel[value.strip().upper()]
    except KeyError:
        print(f"⚠️  ignoring invalid SYMMETRY_LOG_LEVEL={value!r}", file=sys.stderr)
        return LogLevel.INFO


class Logger:
    """Singleton leveled logger (reference: src/logger.ts:11-24 singleton pattern)."""

    _instance: "Logger | None" = None
    _lock = threading.Lock()

    def __new__(cls) -> "Logger":
        with cls._lock:
            if cls._instance is None:
                cls._instance = super().__new__(cls)
                cls._instance._level = _level_from_env(
                    os.environ.get("SYMMETRY_LOG_LEVEL")
                )
                cls._instance._color = sys.stderr.isatty()
                cls._instance._json = os.environ.get(
                    "SYMMETRY_LOG_JSON", "") not in ("", "0", "false")
            return cls._instance

    def set_log_level(self, level: LogLevel | int) -> None:
        self._level = LogLevel(level)

    def set_json_mode(self, enabled: bool) -> None:
        """One-JSON-object-per-line records with trace/request ids."""
        self._json = bool(enabled)

    @property
    def level(self) -> LogLevel:
        return self._level

    def _emit(self, level: LogLevel, *parts: object) -> None:
        if level > self._level:
            return
        msg = " ".join(str(p) for p in parts)
        if self._json:
            record = {"ts": round(time.time(), 3),
                      # Monotonic stamp: the clock spans/metrics use, so
                      # a log line correlates with the timeline without
                      # wall-clock reconciliation.
                      "t_mono": round(time.monotonic(), 4),
                      "level": level.name.lower(), "msg": msg,
                      **({"component": _default_component}
                         if _default_component else {}),
                      **_log_ctx.get()}
            print(json.dumps(record, ensure_ascii=False), file=sys.stderr,
                  flush=True)
            return
        ts = time.strftime("%H:%M:%S")
        ctx = _log_ctx.get()
        tag = (f" [{ctx['trace_id']}]" if ctx.get("trace_id") else "")
        line = f"{_EMOJI[level]} [{ts}]{tag} {msg}"
        if self._color:
            line = f"{_COLORS[level]}{line}{_RESET}"
        print(line, file=sys.stderr, flush=True)

    def error(self, *parts: object) -> None:
        self._emit(LogLevel.ERROR, *parts)

    def warning(self, *parts: object) -> None:
        self._emit(LogLevel.WARNING, *parts)

    def info(self, *parts: object) -> None:
        self._emit(LogLevel.INFO, *parts)

    def debug(self, *parts: object) -> None:
        self._emit(LogLevel.DEBUG, *parts)


logger = Logger()
