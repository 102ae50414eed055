"""The port's canned pipelines (``pipelines``)."""

from . import pipelines

__all__ = ["pipelines"]
