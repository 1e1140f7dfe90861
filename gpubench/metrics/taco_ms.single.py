"""Tacotron device ms a one-sentence request (moves request_ms_p90)."""
from gpubench.readers import taco_ms as read  # noqa: F401
