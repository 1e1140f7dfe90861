"""B7's share of its roofline, forward and backward (moves
train_steps_per_s)."""
from gpubench.readers import b7_roofline as read  # noqa: F401
