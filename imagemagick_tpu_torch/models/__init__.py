"""The port's canned pipelines (``pipelines``) and the corpus thumbnailer
(``thumbnailer``, BASELINE config #5)."""

from . import pipelines, thumbnailer

__all__ = ["pipelines", "thumbnailer"]
