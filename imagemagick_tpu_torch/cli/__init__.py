"""The port's command-line engine (``main``): the ``config1_cli`` subset."""

from .main import CLIError, CLIState, LazyImage, materialize_all, process

__all__ = ["CLIError", "CLIState", "LazyImage", "materialize_all", "process"]
