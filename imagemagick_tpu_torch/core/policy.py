"""Security policy (policy.c).

A copy of ``imagemagick_tpu/core/policy.py``, pure Python.  ImageMagick's
MagickCore/policy.c: domains
(coder/delegate/filter/path/resource/module/cache) x rights (read/write/
execute), enforced before every decode/encode (constitute.c
IsCoderAuthorized at :733).  Policies load from a policy.xml-style file,
MAGICK_POLICY env pairs, or programmatic set_policy calls; default is the
reference's open profile (config/policy-open.xml: everything allowed).

Beyond the copy: ``no_host_files``, ``enforce_path`` and
``enforce_program``, with which the serve daemon runs a request so that
no path it names is opened and no external program (a delegate) runs.
"""

from __future__ import annotations

import contextlib
import fnmatch
import os
import re
import threading
from typing import Dict, List, Optional, Tuple

DOMAINS = ("undefined", "coder", "delegate", "filter", "path", "resource",
           "module", "cache", "system")
RIGHTS = ("none", "read", "write", "execute")


class PolicyError(Exception):
    pass


class PolicyManager:
    def __init__(self):
        # list of (domain, pattern, rights-set)
        self.rules: List[Tuple[str, str, frozenset]] = []
        path = os.environ.get("MAGICK_POLICY_PATH")
        if path and os.path.exists(path):
            try:
                self.load_xml(open(path).read())
            except Exception:
                pass

    def set_policy(self, domain: str, pattern: str, rights: str) -> None:
        d = domain.lower()
        if d not in DOMAINS:
            raise ValueError(f"unknown policy domain {domain!r}")
        rset = frozenset(r.strip().lower() for r in re.split(r"[|,\s]+", rights)
                         if r.strip())
        self.rules.append((d, pattern, rset))

    def load_xml(self, xml_text: str) -> None:
        """Parse policy.xml <policy domain=".." rights=".." pattern=".."/>."""
        for m in re.finditer(r"<policy\s+([^>/]*)/?>", xml_text):
            attrs = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1)))
            if "domain" in attrs:
                self.set_policy(attrs["domain"], attrs.get("pattern", "*"),
                                attrs.get("rights", "none"))

    def is_authorized(self, domain: str, pattern_value: str,
                      right: str) -> bool:
        """IsRightsAuthorized (policy.c:623): last matching rule wins;
        no matching rule means allowed (open profile)."""
        d = domain.lower()
        right = right.lower()
        allowed = True
        for rd, pat, rights in self.rules:
            if rd != d:
                continue
            if fnmatch.fnmatch(pattern_value.upper(), pat.upper()) or \
                    fnmatch.fnmatch(pattern_value.lower(), pat.lower()):
                allowed = right in rights
        return allowed

    def enforce(self, domain: str, value: str, right: str) -> None:
        if not self.is_authorized(domain, value, right):
            raise PolicyError(
                f"attempt to perform an operation not allowed by the "
                f"security policy `{value}'")


policy = PolicyManager()


def load_profile(name: str) -> None:
    """Load one of the shipped profiles by behavior (policy-{open,secure,...})."""
    policy.rules.clear()
    n = name.lower()
    if n == "open":
        return
    if n in ("limited", "secure", "websafe"):
        # match the intent of config/policy-secure.xml: no delegates,
        # no modules, only common raster coders for websafe
        policy.set_policy("delegate", "*", "none")
        policy.set_policy("module", "*", "none")
        policy.set_policy("path", "@*", "none")  # no indirect file reads
        if n == "websafe":
            policy.set_policy("coder", "*", "none")
            for fmt in ("PNG", "JPEG", "GIF", "WEBP", "MIFF", "BMP"):
                policy.set_policy("coder", fmt, "read|write")


_THREAD = threading.local()


@contextlib.contextmanager
def no_host_files():
    """Within the block, on this thread, every path that the caller's
    arguments name (a file to read or write, a font, a profile, a
    passphrase file, a script, an ``mpr:`` entry, which outlives the
    request, an ``mpc:`` cache) raises PolicyError at ``enforce_path``,
    and every delegate program at ``enforce_program``; stdin and stdout
    (``-``) and the pseudo formats stay open.  The serve daemon runs
    each request so."""
    prev = getattr(_THREAD, "no_files", False)
    _THREAD.no_files = True
    try:
        yield
    finally:
        _THREAD.no_files = prev


def enforce_path(path: str) -> None:
    """Raise PolicyError for ``path`` inside ``no_host_files``: called
    before a path that a caller named is opened or looked at."""
    if getattr(_THREAD, "no_files", False):
        raise PolicyError(f"{path!r}: no file of the host may be named "
                          f"here")


def enforce_program(name: str) -> None:
    """Raise PolicyError for running the external program ``name`` (a
    delegate: ghostscript, ffmpeg, ...) inside ``no_host_files``."""
    if getattr(_THREAD, "no_files", False):
        raise PolicyError(f"{name!r}: no program of the host may be run "
                          f"here")
