"""Terminal console helpers: ANSI color and streamed output.

A copy of ``booster_tpu/utils/console.py``: color only on a terminal (or
with FORCE_COLOR), never with NO_COLOR.
"""

from __future__ import annotations

import os
import sys

RESET = "\x1b[0m"
BOLD = "\x1b[1m"
DIM = "\x1b[2m"
CYAN = "\x1b[36m"
GREEN = "\x1b[32m"
YELLOW = "\x1b[33m"
MAGENTA = "\x1b[35m"


def color_enabled(stream=None) -> bool:
    stream = stream or sys.stdout
    if os.environ.get("NO_COLOR"):
        return False
    if os.environ.get("FORCE_COLOR"):
        return True
    return hasattr(stream, "isatty") and stream.isatty()


def colorize(text: str, *codes: str, stream=None) -> str:
    if not codes or not color_enabled(stream):
        return text
    return "".join(codes) + text + RESET


def stream_print(text: str, *codes: str) -> None:
    """Print a streamed delta without a newline, colorized on a terminal."""
    sys.stdout.write(colorize(text, *codes))
    sys.stdout.flush()
