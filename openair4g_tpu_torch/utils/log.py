"""Central logger: per-component levels, the reference's LOG_E/W/I/D.

Reference parity: openair2/UTIL/LOG/log.c + log.h:150-156 — component-
scoped macros (PHY/MAC/RLC/PDCP/RRC/OCM/OTG...) with per-component level
filtering, a global enable, and a compact one-line format. Python's
stdlib logging carries the mechanics; this module pins the component
taxonomy, the level API (set_comp_log), and the reference-style line
format so sims/tools log uniformly.

A copy of openair4g_tpu/utils/log.py whose loggers are named
openair4g_tpu_torch.{comp}, so that their levels and handlers are not
the reference's when both packages run in one process.
"""
from __future__ import annotations

import logging
import sys

COMPONENTS = ("PHY", "MAC", "RLC", "PDCP", "RRC", "S1AP", "NAS", "GTPU",
              "SIM", "OCM", "OTG", "OMG", "HW")

_FMT = "[%(comp)s][%(levelname).1s] %(message)s"
_loggers: dict[str, logging.Logger] = {}
_handler: logging.Handler | None = None


class _StdoutHandler(logging.StreamHandler):
    """Writes to whatever sys.stdout is *now* (not at creation time) so
    redirected/captured stdout — oaisim log files, pytest capsys — always
    receives the lines, like the reference logger's FILE* indirection."""

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value):   # base-class __init__ assigns; ignore
        pass


def _get(comp: str) -> logging.Logger:
    global _handler
    comp = comp.upper()
    if comp not in _loggers:
        lg = logging.getLogger(f"openair4g_tpu_torch.{comp}")
        if _handler is None:
            _handler = _StdoutHandler()
            _handler.setFormatter(logging.Formatter(_FMT))
        if not lg.handlers:
            lg.addHandler(_handler)
        lg.propagate = False
        lg.setLevel(logging.WARNING)        # reference default: errors+warn
        _loggers[comp] = lg
    return _loggers[comp]


def set_comp_log(comp: str, level: str) -> None:
    """Per-component level, log.h's set_comp_log: 'error'|'warn'|'info'|
    'debug'|'off'."""
    lvl = dict(error=logging.ERROR, warn=logging.WARNING,
               info=logging.INFO, debug=logging.DEBUG,
               off=logging.CRITICAL + 1)[level]
    _get(comp).setLevel(lvl)


def set_global_log(level: str) -> None:
    for c in COMPONENTS:
        set_comp_log(c, level)


def _log(level: int, comp: str, msg: str, *args) -> None:
    _get(comp).log(level, msg % args if args else msg,
                   extra={"comp": comp.upper()})


def LOG_E(comp: str, msg: str, *args) -> None:
    _log(logging.ERROR, comp, msg, *args)


def LOG_W(comp: str, msg: str, *args) -> None:
    _log(logging.WARNING, comp, msg, *args)


def LOG_I(comp: str, msg: str, *args) -> None:
    _log(logging.INFO, comp, msg, *args)


def LOG_D(comp: str, msg: str, *args) -> None:
    _log(logging.DEBUG, comp, msg, *args)
