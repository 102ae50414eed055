"""The names by which the port's format lists (``-list format``,
``/formats``, ``magick_query_formats``) differ from the JAX package's, each
a fault of the JAX list that ``tests/test_torch_format_lists.py`` shows.

Read by the tests that compare the lists whole."""

# read by the JAX package (io/__init__.py:288-291), which lists BGRA, CMYK
# and YCBCR as write-only and R not at all
READ_WITH_A_SIZE = ("bgra", "cmyk", "ycbcr", "r")
# aliases that the JAX reader and writer take and its lists leave out
READ_ALIASES = ("text", "ttc", "v", "vif", "ept2", "ept3", "h")
WRITE_ALIASES = ("v", "vif", "ept2", "ept3", "h", "shtml")
# listed as readable by the JAX package; neither package reads a sixel
# file back
LISTED_UNREADABLE = ("six", "sixel")

RECORDED_FORMATS = {n.upper() for n in READ_WITH_A_SIZE + READ_ALIASES
                    + WRITE_ALIASES + LISTED_UNREADABLE}
