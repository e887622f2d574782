"""Logging subsystem: levels, redirection into user loggers (a copy of
gpboost_tpu/utils/log.py).

Reference: include/LightGBM/utils/log.h:78-170 (Log singleton with
Fatal/Warning/Info/Debug levels) and the Python-side redirect hook
`register_logger` (python-package/gpboost/basic.py:39-134,
LGBM_RegisterLogCallback).
"""

import sys

_LEVELS = {"fatal": 0, "warning": 1, "info": 2, "debug": 3}

_state = {
    "level": "info",
    "logger": None,          # user-registered logging.Logger-like object
    "info_method": "info",
    "warning_method": "warning",
}


def register_logger(logger, info_method_name="info",
                    warning_method_name="warning"):
    """Redirect all library output into `logger` (basic.py:39
    register_logger). Pass None to restore printing to stdout."""
    if logger is not None:
        for m in (info_method_name, warning_method_name):
            if not callable(getattr(logger, m, None)):
                raise TypeError(f"logger has no callable method '{m}'")
    _state["logger"] = logger
    _state["info_method"] = info_method_name
    _state["warning_method"] = warning_method_name


def set_log_level(level):
    """'fatal' | 'warning' | 'info' | 'debug' (log.h ResetLogLevel)."""
    if level not in _LEVELS:
        raise ValueError(f"unknown log level '{level}'")
    _state["level"] = level


def _emit(msg, method):
    logger = _state["logger"]
    if logger is not None:
        getattr(logger, method)(msg)
    else:
        print(msg, file=sys.stdout, flush=True)


class Log:
    """Log.debug/info/warning print by level; Log.fatal raises (log.h:170)."""

    @staticmethod
    def debug(msg):
        if _LEVELS[_state["level"]] >= _LEVELS["debug"]:
            _emit(f"[GPBoost] [Debug] {msg}", _state["info_method"])

    @staticmethod
    def info(msg):
        if _LEVELS[_state["level"]] >= _LEVELS["info"]:
            _emit(f"[GPBoost] [Info] {msg}", _state["info_method"])

    @staticmethod
    def warning(msg):
        if _LEVELS[_state["level"]] >= _LEVELS["warning"]:
            _emit(f"[GPBoost] [Warning] {msg}", _state["warning_method"])

    @staticmethod
    def fatal(msg):
        raise RuntimeError(f"[GPBoost] [Fatal] {msg}")
