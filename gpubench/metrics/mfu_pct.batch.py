"""A batched-serving window's share of the card's peak (moves
audio_s_per_s)."""
from gpubench.readers import serve_mfu as read  # noqa: F401
