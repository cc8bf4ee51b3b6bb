"""Structured JSON log funnel: every framework log line, one pipe.

Metrics, spans, traces and the flight ring make the framework
*measurable*; without this module its textual output stays ad-hoc —
scattered ``print``s and stdlib loggers that carry no trace identity and can't be collected from a
pod of workers. This module is the single funnel: :func:`get_logger`
returns a named logger whose records are JSON objects stamped with the
active trace context (``trace_id`` / ``span_id``), the process identity
fields (``process_index`` / ``role``, via :func:`set_default_fields`),
and free-form structured fields — written as one JSON line per record and
mirrored into the flight recorder's ring, so a crash dump interleaves the
process's last log lines with its span ends and errors in one sequence.

Controls (all env-overridable, all settable at runtime for tests):

- ``MMLSPARK_TPU_LOG_LEVEL`` — ``debug`` / ``info`` / ``warning`` /
  ``error`` (default ``info``).
- ``MMLSPARK_TPU_LOG_FILE`` — append JSON lines here instead of stderr.
- ``MMLSPARK_TPU_LOG_RATE`` — per-logger records/second cap (default
  200; 0 = unlimited). Overflow drops records, bumps
  ``log_records_dropped_total{logger=...}``, and emits ONE suppression
  notice when the window reopens — a hot loop cannot flood the sink.

Contracts (shared with the rest of ``observability``):

- **Kill-switch inert.** While ``metrics.set_enabled(False)`` every log
  call is a byte-identical no-op: no sink write, no flight event, no
  counter — instrumented paths keep exactly their uninstrumented
  behavior.
- **Never raises.** A full disk, a closed pipe, or an unserializable
  field degrades to silence (values fall back to ``repr``), never to an
  exception in the serving or training path.
- **One escape hatch.** :func:`console` is the sanctioned raw-output
  path for CLI ready-lines and crash-path notices that external
  orchestration parses (``tests/test_lint.py`` forbids bare ``print`` /
  ``sys.stderr.write`` / ``logging.getLogger`` everywhere else under
  ``mmlspark_tpu_torch/``).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, Optional, TextIO

from . import flight as _flight
from . import metrics as _metrics
from . import tracing as _tracing

__all__ = [
    "get_logger", "StructuredLogger", "console",
    "get_level", "set_level", "set_log_file", "set_rate_limit",
    "set_default_fields", "LEVELS",
]

_LEVEL_ENV = "MMLSPARK_TPU_LOG_LEVEL"
_FILE_ENV = "MMLSPARK_TPU_LOG_FILE"
_RATE_ENV = "MMLSPARK_TPU_LOG_RATE"

LEVELS: Dict[str, int] = {"debug": 10, "info": 20, "warning": 30,
                          "error": 40}


def _env_level() -> str:
    lvl = (os.environ.get(_LEVEL_ENV) or "info").strip().lower()
    return lvl if lvl in LEVELS else "info"


def _env_rate() -> float:
    try:
        return max(0.0, float(os.environ.get(_RATE_ENV, "") or 200.0))
    except ValueError:
        return 200.0


# RLock: the emit path resolves the sink under the lock, and that
# resolution may itself call set_log_file (env-pointed file, opened once)
_lock = threading.RLock()
_level_no = LEVELS[_env_level()]
_rate_limit = _env_rate()
_default_fields: Dict[str, Any] = {}
_loggers: Dict[str, "StructuredLogger"] = {}
# explicit sink set via set_log_file(); None means "resolve from env/stderr"
_sink: Optional[TextIO] = None
_sink_path: Optional[str] = None
# a path whose open() failed: never re-attempted per record (records fall
# back to stderr instead of silently vanishing behind a broken path)
_sink_failed: Optional[str] = None


def get_level() -> str:
    for name, no in LEVELS.items():
        if no == _level_no:
            return name
    return "info"


def set_level(level: str) -> str:
    """Set the funnel threshold; returns the previous level name
    (env default: ``MMLSPARK_TPU_LOG_LEVEL``)."""
    global _level_no
    prev = get_level()
    _level_no = LEVELS.get(str(level).strip().lower(), _level_no)
    return prev


def set_rate_limit(records_per_second: float) -> float:
    """Per-logger throughput cap; 0 disables limiting. Returns the
    previous cap (env default: ``MMLSPARK_TPU_LOG_RATE``)."""
    global _rate_limit
    prev, _rate_limit = _rate_limit, max(0.0, float(records_per_second))
    return prev


def set_log_file(path: Optional[str]) -> None:
    """Redirect the JSON-line sink (None: back to
    ``MMLSPARK_TPU_LOG_FILE`` or stderr). Closes a previously-set file.
    An unopenable path degrades to stderr — with ONE console notice,
    never one failed ``open()`` per record."""
    global _sink, _sink_path, _sink_failed
    with _lock:
        if _sink is not None:
            try:
                _sink.close()
            except Exception:  # noqa: BLE001
                pass
        _sink, _sink_path, _sink_failed = None, path, None
        if path:
            try:
                _sink = open(path, "a", encoding="utf-8")
            except OSError as e:
                _sink_failed = path
                console(f"[logging] cannot open {path!r} ({e}); "
                        "falling back to stderr", err=True)


def set_default_fields(**fields: Any) -> None:
    """Fields stamped onto every subsequent record (``process_index`` on
    multi-host runs, ``role`` on serving deployments); a None value
    removes the field. Replace-on-write, mirroring
    ``flight.set_default_fields``."""
    global _default_fields
    merged = {**_default_fields, **fields}
    _default_fields = {k: v for k, v in merged.items() if v is not None}


def _resolve_sink() -> TextIO:
    if _sink is not None:
        return _sink
    path = os.environ.get(_FILE_ENV)
    if path and path not in (_sink_failed, _sink_path):
        # env-pointed file: open once and pin (the common deployment
        # case); a failed open is remembered so it is not retried here
        set_log_file(path)
        return _sink if _sink is not None else sys.stderr
    return sys.stderr


def _emit_line(record: Dict[str, Any]) -> None:
    line = json.dumps(record, default=repr)
    with _lock:
        sink = _resolve_sink()
        sink.write(line + "\n")
        sink.flush()


class StructuredLogger:
    """One named pipe into the funnel. ``debug/info/warning/error`` accept
    printf-style positional args (stdlib-logger call sites port verbatim)
    plus structured keyword fields."""

    def __init__(self, name: str):
        self.name = name
        # rate-limit window state: [window_start_monotonic, emitted, dropped]
        self._win = [0.0, 0, 0]

    # -- rate limiting ------------------------------------------------------
    def _admit(self, now: float) -> bool:
        """One-second sliding window per logger. Returns False (and counts
        the drop) when the cap is hit; on window rollover a single
        suppression record reports what was lost."""
        if _rate_limit <= 0:
            return True
        with _lock:
            start, emitted, dropped = self._win
            if now - start >= 1.0:
                self._win = [now, 1, 0]
                suppressed = dropped
            else:
                if emitted >= _rate_limit:
                    self._win[2] += 1
                    return False
                self._win[1] += 1
                suppressed = 0
        if suppressed:
            self._record("warning", "rate limit: suppressed "
                         f"{suppressed} records in the last window",
                         _limited=True, suppressed=suppressed)
        return True

    # -- record path --------------------------------------------------------
    def _record(self, level: str, msg: str, *args: Any,
                _limited: bool = False, **fields: Any) -> None:
        try:
            if args:
                try:
                    msg = msg % args
                except Exception:  # noqa: BLE001 — bad format never raises
                    msg = f"{msg} {args!r}"
            now = time.monotonic()
            if not _limited and not self._admit(now):
                _metrics.safe_counter("log_records_dropped_total",
                                      logger=self.name).inc()
                return
            rec: Dict[str, Any] = {"ts": time.time(), "level": level,
                                   "logger": self.name, "msg": str(msg),
                                   "pid": os.getpid()}
            if _default_fields:
                rec.update(_default_fields)
            ctx = _tracing.current()
            if ctx is not None:
                rec.setdefault("trace_id", ctx.trace_id)
                rec.setdefault("span_id", ctx.span_id)
            for k, v in fields.items():
                rec.setdefault(k, v)
            _emit_line(rec)
            _metrics.safe_counter("log_records_total", level=level).inc()
            # ring-buffer the record: a flight dump interleaves the last
            # log lines with span ends / errors in one event sequence
            _flight.record("log", level=level, logger=self.name,
                           msg=rec["msg"],
                           **{k: v for k, v in fields.items()
                              if k not in ("kind", "level", "logger", "msg")})
        except Exception:  # noqa: BLE001 — logging must never break callers
            pass

    def _log(self, level: str, msg: str, *args: Any, **fields: Any) -> None:
        # the kill switch AND the level gate live here so a disabled or
        # filtered call costs two comparisons and allocates nothing
        if not _metrics.enabled() or LEVELS[level] < _level_no:
            return
        self._record(level, msg, *args, **fields)

    def debug(self, msg: str, *args: Any, **fields: Any) -> None:
        self._log("debug", msg, *args, **fields)

    def info(self, msg: str, *args: Any, **fields: Any) -> None:
        self._log("info", msg, *args, **fields)

    def warning(self, msg: str, *args: Any, **fields: Any) -> None:
        self._log("warning", msg, *args, **fields)

    def error(self, msg: str, *args: Any, **fields: Any) -> None:
        self._log("error", msg, *args, **fields)


def get_logger(name: str) -> StructuredLogger:
    """The (created-once) named logger — the one way framework code logs."""
    with _lock:
        lg = _loggers.get(name)
        if lg is None:
            lg = _loggers[name] = StructuredLogger(name)
        return lg


def console(msg: str, err: bool = False) -> None:
    """Unconditional plain line to stdout (or stderr with ``err=True``).

    The sanctioned raw-output path: CLI ready-lines that external
    orchestration parses (``serving_main``'s ``worker ... serving on``)
    and crash-path notices (flight dump locations) must reach their
    stream regardless of the telemetry kill switch — they are process
    lifecycle output, not telemetry.
    """
    stream = sys.stderr if err else sys.stdout
    try:
        stream.write(str(msg) + "\n")
        stream.flush()
    except Exception:  # noqa: BLE001 — a closed pipe must not kill the host
        pass


def _reset_for_tests() -> None:
    """Restore module defaults (level/rate from env, stderr sink, no
    default fields, fresh per-logger windows)."""
    global _level_no, _rate_limit, _default_fields
    set_log_file(None)
    _level_no = LEVELS[_env_level()]
    _rate_limit = _env_rate()
    _default_fields = {}
    with _lock:
        for lg in _loggers.values():
            lg._win = [0.0, 0, 0]
