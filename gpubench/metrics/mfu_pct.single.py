"""A one-sentence window's share of the card's peak (moves request_ms_p90)."""
from gpubench.readers import serve_mfu as read  # noqa: F401
