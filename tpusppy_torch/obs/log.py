"""Logger factory with output attributable to its track.

A copy of ``tpusppy/obs/log.py``: one ``get_logger(name)`` for the whole
package, each record rendered as ``[name] message`` so the output of a
wheel's cylinders (hub, spokes, the checkpoint writer) says whose it is;
the level is one environment knob, ``TPUSPPY_LOG_LEVEL``
(DEBUG/INFO/WARNING/ERROR, default INFO).  The root ``tpusppy_torch``
logger writes to stdout.
"""

from __future__ import annotations

import logging
import os
import sys

_ROOT = "tpusppy_torch"


class _TrackFormatter(logging.Formatter):
    """``[track] message``: the track is the logger name below the root
    (the root's own records render untagged)."""

    def format(self, record):
        msg = record.getMessage()
        track = record.name
        if track.startswith(_ROOT + "."):
            track = track[len(_ROOT) + 1:]
        out = msg if track in (_ROOT, "root", "") else f"[{track}] {msg}"
        if record.exc_info:
            out += "\n" + self.formatException(record.exc_info)
        if record.stack_info:
            out += "\n" + self.formatStack(record.stack_info)
        return out


def _env_level(default=logging.INFO):
    name = os.environ.get("TPUSPPY_LOG_LEVEL", "").strip().upper()
    if not name:
        return default
    return getattr(logging, name, default)


#: Root logger of the package (stdout, [track]-formatted, env-leveled).
root = logging.getLogger(_ROOT)
root.setLevel(_env_level())
if not root.handlers:
    _h = logging.StreamHandler(sys.stdout)
    _h.setFormatter(_TrackFormatter())
    root.addHandler(_h)


def get_logger(name: str | None = None) -> logging.Logger:
    """Child of the package's root logger whose records render as
    ``[name] message``: a module tag ("resilience.checkpoint") or a
    cylinder ("spoke1:Lagrangian")."""
    if not name:
        return root
    return logging.getLogger(f"{_ROOT}.{name}")
