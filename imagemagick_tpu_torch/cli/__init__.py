"""The port's command-line engine (``main``): the magick/convert dialect,
from files or pseudo images to files (``main.main``)."""

from .main import CLIError, CLIState, LazyImage, materialize_all, process

__all__ = ["CLIError", "CLIState", "LazyImage", "materialize_all", "process"]
