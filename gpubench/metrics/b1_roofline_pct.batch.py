"""B1's share of its roofline in batched calls (moves audio_s_per_s)."""
from gpubench.readers import b1_roofline as read  # noqa: F401
