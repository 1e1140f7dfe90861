"""The device's idle share of a one-sentence window (moves request_ms_p90)."""
from gpubench.readers import idle_pct as read  # noqa: F401
