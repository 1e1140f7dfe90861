"""Vocoder conditioning and crossfade device ms a request (moves
request_ms_p90)."""
from gpubench.readers import voc_side_ms as read  # noqa: F401
