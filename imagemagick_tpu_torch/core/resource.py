"""Resource limits and accounting (resource.c).

A copy of ``imagemagick_tpu/core/resource.py``, pure Python.  ImageMagick's
MagickCore/resource.c: global
limits for width/height/area/memory/disk/time/thread/list-length
(resource_.h:25-39), environment overrides MAGICK_*_LIMIT
(resource.c:1258-1322), and acquire/relinquish accounting.  Enforced at
decode time (constitute.c calls AcquireMagickResource before allocating)
— here io.read_images and pseudo-canvas creation check limits before
materializing arrays.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional


class ResourceLimitError(Exception):
    pass


_SUFFIX = {"": 1, "b": 1, "kb": 10 ** 3, "mb": 10 ** 6, "gb": 10 ** 9,
           "kib": 2 ** 10, "mib": 2 ** 20, "gib": 2 ** 30,
           "k": 2 ** 10, "m": 2 ** 20, "g": 2 ** 30,
           "kp": 10 ** 3, "mp": 10 ** 6, "gp": 10 ** 9}


def _parse_limit(s: str) -> float:
    s = str(s).strip().lower()
    if s in ("unlimited", "none", ""):
        return float("inf")
    import re

    m = re.match(r"^([0-9.]+)\s*([a-z]*)$", s)
    if not m:
        raise ValueError(f"bad resource limit {s!r}")
    return float(m.group(1)) * _SUFFIX.get(m.group(2), 1)


class ResourceManager:
    """Global limits + current/peak usage accounting."""

    DEFAULTS = {
        "width": 107374182400.0,     # max image width in pixels (16EP analog)
        "height": 107374182400.0,
        "area": float("inf"),        # W*H gate before allocation
        "memory": float("inf"),
        "map": float("inf"),
        "disk": float("inf"),
        "file": 768.0,
        "thread": float(os.cpu_count() or 1),
        "throttle": 0.0,
        "time": float("inf"),        # seconds; ops past this raise
        "list-length": float("inf"),
    }

    def __init__(self):
        self.limits: Dict[str, float] = dict(self.DEFAULTS)
        self.usage: Dict[str, float] = {k: 0.0 for k in self.DEFAULTS}
        self.peak: Dict[str, float] = {k: 0.0 for k in self.DEFAULTS}
        self._lock = threading.Lock()
        self._start = time.monotonic()
        # env overrides (resource.c:1258-1322)
        for key in self.DEFAULTS:
            env = os.environ.get(f"MAGICK_{key.upper().replace('-', '_')}_LIMIT")
            if env:
                try:
                    self.limits[key] = _parse_limit(env)
                except ValueError:
                    pass

    def set_limit(self, resource: str, value) -> None:
        r = resource.lower()
        if r not in self.limits:
            raise ValueError(f"unknown resource {resource!r}")
        self.limits[r] = _parse_limit(value) if isinstance(value, str) else float(value)

    def get_limit(self, resource: str) -> float:
        return self.limits[resource.lower()]

    def acquire(self, resource: str, amount: float) -> None:
        """AcquireMagickResource: raise if the limit would be exceeded."""
        r = resource.lower()
        with self._lock:
            limit = self.limits.get(r, float("inf"))
            if r in ("width", "height", "area"):
                if amount > limit:
                    raise ResourceLimitError(
                        f"{r} {amount:.0f} exceeds limit {limit:.0f}")
                return
            new = self.usage.get(r, 0.0) + amount
            if new > limit:
                raise ResourceLimitError(
                    f"{r} usage {new:.0f} exceeds limit {limit:.0f}")
            self.usage[r] = new
            self.peak[r] = max(self.peak[r], new)

    def relinquish(self, resource: str, amount: float) -> None:
        r = resource.lower()
        with self._lock:
            self.usage[r] = max(self.usage.get(r, 0.0) - amount, 0.0)

    def check_time(self) -> None:
        """TimeResource: abort long-running invocations."""
        if time.monotonic() - self._start > self.limits["time"]:
            raise ResourceLimitError("time limit exceeded")

    def check_image_size(self, width: int, height: int) -> None:
        self.acquire("width", float(width))
        self.acquire("height", float(height))
        self.acquire("area", float(width) * float(height))

    def report(self) -> Dict[str, Dict[str, float]]:
        """GetMagickResource-style usage snapshot."""
        return {k: {"limit": self.limits[k], "current": self.usage[k],
                    "peak": self.peak[k]} for k in self.limits}


# process-global singleton (MagickCore keeps these in statics)
resources = ResourceManager()
