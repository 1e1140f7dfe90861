"""The device's idle share of a batched-serving window (moves
audio_s_per_s)."""
from gpubench.readers import idle_pct as read  # noqa: F401
