"""``python -m imagemagick_tpu_torch.cli ...``: the magick/convert
command line on the card (``main.main``)."""

import sys

from .main import main

sys.exit(main())
