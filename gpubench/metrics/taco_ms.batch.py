"""Tacotron device ms a batched call (moves audio_s_per_s)."""
from gpubench.readers import taco_ms as read  # noqa: F401
