"""Logging and check helpers of the port.  Counterpart:
``singa_tpu/logging.py`` — the reference's glog-style macros
(``include/singa/utils/logging.h``: ``LOG(INFO/WARNING/ERROR/FATAL)``,
``CHECK*``, ``InitLogging``), shaped for Python.

``LOG(INFO, ...)`` routes through the standard ``logging`` module under
the ``singa_tpu_torch`` logger (so host applications can reconfigure its
handlers); ``FATAL`` raises after logging, like the reference's abort.
``VLOG(v, ...)`` logs at ``INFO`` when ``v`` is at most the verbosity
that :func:`SetVerbosity` set.  ``CHECK*`` raise :class:`CheckError`
with the formatted operands.  Every line is also mirrored onto the
process-global span tracer (``telemetry.tracer.current()``, when one is
installed) as a ``log`` instant, cat ``log``, with its ``level`` and the
first 200 characters of its ``msg``, as the reference's
``_trace_instant`` does.

Left out of the copy: the reference's ``LINT`` channel renders
graph-lint findings, which belong to the analysis passes (ROADMAP.md
queue 1, item 12).
"""

from __future__ import annotations

import logging as _pylogging
import sys

from .telemetry.tracer import current as _tracer_current

__all__ = ["INFO", "WARNING", "ERROR", "FATAL", "LOG", "VLOG", "CHECK",
           "CHECK_EQ", "CHECK_NE", "CHECK_LT", "CHECK_LE", "CHECK_GT",
           "CHECK_GE", "CHECK_NOTNULL", "CheckError", "InitLogging",
           "SetVerbosity"]

INFO = _pylogging.INFO
WARNING = _pylogging.WARNING
ERROR = _pylogging.ERROR
FATAL = _pylogging.CRITICAL

_logger = _pylogging.getLogger("singa_tpu_torch")
_verbosity = 0


class CheckError(AssertionError):
    """Raised by CHECK* failures (reference: CHECK aborts via LOG(FATAL))."""


def InitLogging(argv0: str = "singa_tpu_torch", level: int = INFO) -> None:
    """Reference: ``InitLogging(argv[0])`` — attach a stderr handler."""
    if not _logger.handlers:
        h = _pylogging.StreamHandler(sys.stderr)
        h.setFormatter(_pylogging.Formatter(
            f"%(levelname).1s %(asctime)s {argv0}] %(message)s",
            datefmt="%H:%M:%S"))
        _logger.addHandler(h)
    _logger.setLevel(level)


def SetVerbosity(v: int) -> None:
    """VLOG threshold (reference: the device/graph profiling verbosity)."""
    global _verbosity
    _verbosity = int(v)


def _trace_instant(name: str, level_name: str, msg, args) -> None:
    """Mirror a log line onto the process-global span tracer (if one is
    installed), so log events land on the exported timeline."""
    tr = _tracer_current()
    if tr is None:
        return
    try:
        text = msg % args if args else str(msg)
    except Exception:
        text = str(msg)
    tr.instant(name, cat="log",
               args={"level": level_name, "msg": text[:200]})


def LOG(level: int, msg, *args) -> None:
    if not _logger.handlers:
        InitLogging()
    _logger.log(level, msg, *args)
    _trace_instant("log", _pylogging.getLevelName(level), msg, args)
    if level >= FATAL:
        raise CheckError(msg % args if args else str(msg))


def VLOG(v: int, msg, *args) -> None:
    if v <= _verbosity:
        LOG(INFO, msg, *args)


def _fail(op, a, b):
    raise CheckError(f"CHECK_{op} failed: {a!r} vs {b!r}")


def CHECK(cond, msg: str = "CHECK failed"):
    if not cond:
        raise CheckError(msg)
    return cond


def CHECK_EQ(a, b):
    if not a == b:
        _fail("EQ", a, b)
    return a


def CHECK_NE(a, b):
    if not a != b:
        _fail("NE", a, b)
    return a


def CHECK_LT(a, b):
    if not a < b:
        _fail("LT", a, b)
    return a


def CHECK_LE(a, b):
    if not a <= b:
        _fail("LE", a, b)
    return a


def CHECK_GT(a, b):
    if not a > b:
        _fail("GT", a, b)
    return a


def CHECK_GE(a, b):
    if not a >= b:
        _fail("GE", a, b)
    return a


def CHECK_NOTNULL(x):
    if x is None:
        raise CheckError("CHECK_NOTNULL failed")
    return x
