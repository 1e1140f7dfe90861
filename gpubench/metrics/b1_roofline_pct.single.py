"""B1's share of its roofline in one-sentence requests (moves
request_ms_p90)."""
from gpubench.readers import b1_roofline as read  # noqa: F401
