"""``python -m imagemagick_tpu_torch ...``: the magick/convert command
line on the card (``cli.main.main``)."""

import sys

from .cli.main import main

sys.exit(main())
