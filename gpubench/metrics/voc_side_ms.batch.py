"""Vocoder conditioning and crossfade device ms a batched call (moves
audio_s_per_s)."""
from gpubench.readers import voc_side_ms as read  # noqa: F401
