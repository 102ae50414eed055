"""Event logging + progress monitors (log.c / monitor.c).

A copy of ``imagemagick_tpu/core/log.py``, pure Python.

Re-implements the observability layer: 22 event domains
(MagickCore/log.h:33-59) behind a bitmask, console/file
sinks with format escapes (log.c), and per-op progress callbacks
(monitor.h:25-28 MagickProgressMonitor; SetImageProgress calls sprinkled
through every op in the reference).  The CLI exposes -debug and -monitor.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional, Set

EVENT_DOMAINS = (
    "accelerate", "annotate", "blob", "cache", "coder", "configure",
    "deprecate", "draw", "exception", "image", "locale", "module",
    "pixel", "policy", "resource", "trace", "transform", "user", "wand",
    "x11", "command", "all", "none",
)


class LogManager:
    def __init__(self):
        self.enabled: Set[str] = set()
        self.sink = sys.stderr
        self._start = time.monotonic()
        env = os.environ.get("MAGICK_DEBUG", "")
        if env:
            self.set_log_event_mask(env)

    def set_log_event_mask(self, events: str) -> None:
        """SetLogEventMask: comma list of domains ('all', 'none' special)."""
        for e in events.lower().replace("+", ",").split(","):
            e = e.strip()
            if not e:
                continue
            if e == "none":
                self.enabled.clear()
            elif e == "all":
                self.enabled = set(EVENT_DOMAINS) - {"none"}
            elif e in EVENT_DOMAINS:
                self.enabled.add(e)

    def is_enabled(self, domain: str) -> bool:
        return domain in self.enabled or "all" in self.enabled

    def event(self, domain: str, message: str, *args) -> None:
        """LogMagickEvent: timestamped domain-tagged line."""
        if not self.is_enabled(domain):
            return
        t = time.monotonic() - self._start
        msg = message % args if args else message
        print(f"{t:010.6f} {domain[:4].upper()} {msg}", file=self.sink)


log = LogManager()


class ProgressMonitor:
    """MagickProgressMonitor: callback(tag, offset, extent) -> bool."""

    def __init__(self, callback: Optional[Callable[[str, int, int], bool]] = None):
        self.callback = callback

    def __call__(self, tag: str, offset: int, extent: int) -> bool:
        if self.callback is None:
            return True
        return bool(self.callback(tag, offset, extent))


def cli_monitor(tag: str, offset: int, extent: int) -> bool:
    """-monitor console percent display (mogrify.c MonitorProgress)."""
    pct = 100.0 * offset / max(extent, 1)
    print(f"{tag}: {offset} of {extent}, {pct:.0f}% complete",
          file=sys.stderr, end="\r" if offset < extent else "\n")
    return True
