from slimt_jax.html.html import HTML  # noqa: F401
from slimt_jax.html.scanner import BadHTML, ScanError  # noqa: F401
